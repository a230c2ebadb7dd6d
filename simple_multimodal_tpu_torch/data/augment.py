"""Device-side batch augmentation (port of simple_multimodal_tpu/data/augment.py).

The reference augments per item on the host: audio gets gaussian noise
(p=0.3) and a linear-interpolation time stretch by U[0.8, 1.2] (p=0.3);
video gets a brightness scale U[0.8, 1.2] (p=0.3) and a horizontal flip
(p=0.5). Here the same distributions act on the whole batch on its device,
every draw from an explicit generator, with static shapes (the time
stretch is a fixed-size gather with masking, not a resize).
"""
import torch


def time_stretch(wav: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """Linear-interpolation time stretch of wav [B, L] by factor [B] to
    length floor(L·factor), then padded with zeros / cut back to L; the
    coordinate map of ``F.interpolate(mode='linear', align_corners=False)``
    as the JAX ``_time_stretch`` writes it."""
    L = wav.shape[-1]
    new_len = torch.floor(L * factor.float())[:, None]                 # [B, 1]
    j = torch.arange(L, dtype=torch.float32, device=wav.device)[None]   # [1, L]
    src = (j + 0.5) * (L / torch.clamp(new_len, min=1.0)) - 0.5
    lo = torch.clamp(torch.floor(src), 0, L - 1).long()
    hi = torch.clamp(lo + 1, 0, L - 1)
    frac = torch.clamp(src - lo.float(), 0.0, 1.0)
    stretched = wav.gather(1, lo) * (1.0 - frac) + wav.gather(1, hi) * frac
    return torch.where(j < new_len, stretched, torch.zeros((), dtype=stretched.dtype,
                                                             device=wav.device))


def augment_audio(audio: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """audio f32 [B, L]: noise 0.01·N(0, 1) with p=0.3, then a time stretch
    by U[0.8, 1.2] with p=0.3, each per sample."""
    B, dev = audio.shape[0], audio.device
    add_noise = torch.rand(B, 1, generator=gen, device=dev) < 0.3
    noise = torch.randn(audio.shape, generator=gen, device=dev)
    audio = torch.where(add_noise, audio + 0.01 * noise, audio)
    do_stretch = torch.rand(B, 1, generator=gen, device=dev) < 0.3
    factor = 0.8 + torch.rand(B, generator=gen, device=dev) * 0.4
    return torch.where(do_stretch, time_stretch(audio, factor), audio)


def augment_video(video: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """video [B, T, H, W, 3] in [0, 1]: brightness ×U[0.8, 1.2] clipped to
    [0, 1] with p=0.3, and a horizontal flip with p=0.5, per sample."""
    B, dev = video.shape[0], video.device
    shape = (B,) + (1,) * (video.dim() - 1)
    do_bright = torch.rand(shape, generator=gen, device=dev) < 0.3
    factor = (0.8 + torch.rand(shape, generator=gen, device=dev) * 0.4).to(video.dtype)
    video = torch.where(do_bright, torch.clamp(video * factor, 0.0, 1.0), video)
    do_flip = torch.rand(shape, generator=gen, device=dev) < 0.5
    return torch.where(do_flip, video.flip(3), video)


def augment_batch(audio: torch.Tensor, video: torch.Tensor, gen: torch.Generator):
    """Audio and video augmentation of one batch, drawn from ``gen``."""
    return augment_audio(audio, gen), augment_video(video, gen)
