"""ctypes bindings for the native smmdata decode library (port of
simple_multimodal_tpu/data/native.py).

Builds the repo's ``native/smmdata.cpp`` with g++ at first use into
``build/native/`` at the checkout root (``build/`` is not tracked), named
by a hash of the source and the flags, and never over the tracked
``native/libsmmdata.so``. Exposes WAV decode + resample, one file a
call. Without a compiler (or when the build fails) the callers fall back
to the numpy decoder; ``decoder()`` says which one runs, and the first
decode prints it. This is host decode, not a device kernel.
"""
import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_ROOT, "native", "smmdata.cpp")
_BUILD_DIR = os.path.join(_ROOT, "build", "native")
# portable code (no -march=native): the build directory may travel to
# another machine with the checkout
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lib = None
_lock = threading.Lock()
_build_error: Optional[str] = None
_announced = False


def _so_path() -> str:
    with open(_SRC, "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"libsmmdata-{key}.so")


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_error
    if _lib is not None or _build_error is not None:
        return _lib
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            so = _so_path()
            if not os.path.exists(so):
                os.makedirs(_BUILD_DIR, exist_ok=True)
                tmp = f"{so}.{os.getpid()}.tmp"
                subprocess.run(["g++", *_FLAGS, _SRC, "-o", tmp],
                               check=True, capture_output=True)
                os.replace(tmp, so)
            lib = ctypes.CDLL(so)
            lib.smm_decode_audio.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_float),
            ]
            lib.smm_decode_audio.restype = ctypes.c_int
            _lib = lib
        except Exception as e:
            stderr = getattr(e, "stderr", b"") or b""
            _build_error = f"{type(e).__name__}: {e} {stderr.decode(errors='replace')[:200]}"
            _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def decoder() -> str:
    """'native' when the C++ library builds and loads here, else 'numpy'."""
    return "native" if available() else "numpy"


def announce() -> None:
    """Print, once per process, which audio decoder runs."""
    global _announced
    if _announced:
        return
    _announced = True
    if available():
        print(f"audio decode: native ({_so_path()})", flush=True)
    else:
        print(f"audio decode: numpy (the native library did not build: {_build_error})",
              flush=True)


def decode_audio(path: str, target_rate: int, max_len: int) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    out = np.zeros(max_len, dtype=np.float32)
    lib.smm_decode_audio(
        str(path).encode(), target_rate, max_len,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out

