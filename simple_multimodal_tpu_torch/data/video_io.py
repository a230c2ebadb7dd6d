"""Host-side video decode (port of simple_multimodal_tpu/data/video_io.py).

Decodes the first ``max_frames`` frames with OpenCV, BGR→RGB, resized to
the frame size, as one fixed-shape uint8 [T, H, W, 3] buffer (channels
last, the JAX package's layout); normalisation happens on the device.
Missing or corrupt files, and clips shorter than ``max_frames``, give
zeros, as in the JAX package.

OpenCV is optional there and here. Without it the JAX package reads every
clip as black and says nothing; the port prints one loud warning the first
time it does so. The sample generator (``data/sample_data.py``) writes the
decoded frames as sidecars beside an empty clip on such a host, so that the
datasets of both packages read the frames that were drawn;
``sidecar_frames`` is how the port's dataset and demo read them.
"""
import sys
from pathlib import Path
from typing import Tuple

import numpy as np

cv2 = None
_HAS_CV2 = None  # imported at first use: None until then
_warned_black = False


def has_opencv() -> bool:
    """Whether OpenCV imports here (tried once, at first use)."""
    global cv2, _HAS_CV2
    if _HAS_CV2 is None:
        try:
            import cv2 as _cv2

            cv2, _HAS_CV2 = _cv2, True
        except Exception:  # pragma: no cover - depends on the host
            _HAS_CV2 = False
    return _HAS_CV2


def _warn_black(path) -> None:
    global _warned_black
    if not _warned_black:
        _warned_black = True
        print(f"WARNING: OpenCV is not installed: video files (first: {path}) read as BLACK "
              "frames; give the clips as decoded-frame sidecars (data/sample_data.py writes "
              "them) or install opencv-python", file=sys.stderr, flush=True)


def load_video_frames(
    path: str,
    max_frames: int = 30,
    frame_size: Tuple[int, int] = (224, 224),
    stride: int = 1,
) -> np.ndarray:
    """Decode up to ``max_frames`` RGB frames → uint8 [max_frames, H, W, 3].

    Missing/corrupt files yield zeros. ``stride`` > 1 keeps every
    ``stride``-th frame (the demo's subsampling of long clips).
    """
    h, w = frame_size[1], frame_size[0]
    out = np.zeros((max_frames, h, w, 3), dtype=np.uint8)
    if not has_opencv():
        _warn_black(path)
        return out
    try:
        cap = cv2.VideoCapture(str(path))
        n = 0
        frame_idx = 0
        while n < max_frames:
            ret, frame = cap.read()
            if not ret:
                break
            if frame_idx % stride == 0:
                frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
                frame = cv2.resize(frame, frame_size)
                out[n] = frame
                n += 1
            frame_idx += 1
        cap.release()
    except Exception:
        return np.zeros((max_frames, h, w, 3), dtype=np.uint8)
    return out


def is_empty_clip(path) -> bool:
    """An empty file: a clip the generator stored as sidecars (no OpenCV)."""
    path = Path(path)
    return path.exists() and path.stat().st_size == 0


def sidecar_frames(path, kind: str, shape) -> np.ndarray:
    """The frames of an empty clip, from its ``<clip>.<kind>.npy`` sidecar
    (``vid``: uint8 [T, H, W, 3]; ``vid420``: packed yuv420). Raises when
    the sidecar is missing or holds another shape than ``shape``: such a
    clip is never read as black."""
    path = Path(path)
    cache_path = path.with_suffix(path.suffix + f".{kind}.npy")
    if not cache_path.exists():
        raise FileNotFoundError(
            f"{path} is an empty clip without its decoded-frame sidecar {cache_path.name}; "
            "regenerate the sample set")
    arr = np.load(cache_path, mmap_mode="r")
    if tuple(arr.shape) != tuple(shape):
        raise ValueError(
            f"the sidecar of the empty clip {path} holds frames of shape "
            f"{tuple(arr.shape)}, but this config's frames are {tuple(shape)} "
            "(video_max_frames, video_frame_size): generate the sample set for this "
            "geometry or use the config it was made for")
    return np.array(arr)


def frame_count(path: str) -> int:
    """The clip's frame count as OpenCV reports it (0 if unknown or no OpenCV)."""
    if not has_opencv():
        return 0
    try:
        cap = cv2.VideoCapture(str(path))
        total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) or 0
        cap.release()
    except Exception:
        total = 0
    return total


def write_video(path: str, frames: np.ndarray, fps: int = 15) -> None:
    """Write uint8 RGB frames [T, H, W, 3] to an mp4 file (for sample data)."""
    if not has_opencv():
        raise RuntimeError("OpenCV not available; cannot encode video")
    h, w = frames.shape[1], frames.shape[2]
    fourcc = cv2.VideoWriter_fourcc(*"mp4v")
    out = cv2.VideoWriter(str(path), fourcc, fps, (w, h))
    for f in frames:
        out.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    out.release()
