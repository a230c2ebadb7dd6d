"""Video wire formats for the host→device boundary (port of
simple_multimodal_tpu/data/video_wire.py).

Packed yuv420 layout (per frame, one uint8 [H*3//2, W] array, BT.601
full-range): rows 0..H-1 the Y plane; then the U plane [H//2, W//2] stored
row-major as [H//4, W]; then the V plane likewise. ``pack_yuv420`` runs on
the host in numpy; ``decode_video_wire`` turns any wire format into
normalized [..., H, W, 3] frames in the compute dtype, as tensor ops on the
tensor's own device (NHWC, the JAX package's layout).
"""
import numpy as np
import torch

_KR, _KG, _KB = 0.299, 0.587, 0.114


def packed_height(h: int) -> int:
    return h * 3 // 2


def can_pack(h: int, w: int) -> bool:
    """Packing needs H divisible by 4 (U/V replanes) and W by 2."""
    return h % 4 == 0 and w % 2 == 0


def pack_yuv420(frames: np.ndarray) -> np.ndarray:
    """uint8 RGB [..., H, W, 3] → packed uint8 [..., H*3//2, W]."""
    if frames.dtype != np.uint8:
        raise ValueError(f"pack_yuv420 expects uint8, got {frames.dtype}")
    *lead, h, w, c = frames.shape
    if c != 3 or not can_pack(h, w):
        raise ValueError(f"cannot 4:2:0-pack shape {frames.shape}")
    f = frames.astype(np.float32)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    y = _KR * r + _KG * g + _KB * b
    u = (b - y) / (2.0 * (1.0 - _KB)) + 128.0
    v = (r - y) / (2.0 * (1.0 - _KR)) + 128.0

    def sub(p):  # 2x2 box-average chroma, re-planed [H//2, W//2] → [H//4, W]
        return p.reshape(*lead, h // 2, 2, w // 2, 2).mean(axis=(-3, -1)).reshape(
            *lead, h // 4, w)

    out = np.concatenate([y, sub(u), sub(v)], axis=-2)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def unpack_yuv420(packed: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Packed uint8 [..., H*3//2, W] → normalized RGB [..., H, W, 3] in
    ``dtype``, range [0, 1], nearest-neighbour chroma upsampling."""
    *lead, hp, w = packed.shape
    h = hp * 2 // 3
    p = packed.float()
    y = p[..., :h, :]
    u = p[..., h:h + h // 4, :].reshape(*lead, h // 2, w // 2)
    v = p[..., h + h // 4:, :].reshape(*lead, h // 2, w // 2)

    def up2(q):
        return q.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)

    u = up2(u) - 128.0
    v = up2(v) - 128.0
    r = y + 2.0 * (1.0 - _KR) * v
    b = y + 2.0 * (1.0 - _KB) * u
    g = (y - _KR * r - _KB * b) / _KG
    rgb = torch.stack([r, g, b], dim=-1)
    return (rgb.clamp(0.0, 255.0) / 255.0).to(dtype)


def decode_video_wire(video: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Any wire format → normalized float frames [..., H, W, 3] in ``dtype``:
    uint8 with a last dim of 3 is RGB bytes (/255); other uint8 is packed
    yuv420 planes; float is already normalized and only cast."""
    if video.dtype == torch.uint8:
        if video.shape[-1] == 3:
            return video.to(dtype) / 255.0
        return unpack_yuv420(video, dtype)
    return video.to(dtype)
