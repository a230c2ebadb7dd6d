"""Host-side audio decode (port of simple_multimodal_tpu/data/audio_io.py).

A small numpy WAV reader and writer over the stdlib ``wave`` container,
a windowed-sinc polyphase resampler, and ``load_audio_fixed`` (decode,
resample, mono, pad or truncate), with the JAX package's dtypes and
operation order so that outputs are byte-equal to its functions' on the
same files. Decode goes through the native C++ library
(``data/native.py``) when it builds on the host, numpy otherwise.
"""
import wave
from functools import lru_cache
from typing import Tuple

import numpy as np


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a PCM WAV file → (float32 waveform [channels, samples], rate)."""
    with wave.open(str(path), "rb") as wf:
        n_channels = wf.getnchannels()
        sampwidth = wf.getsampwidth()
        rate = wf.getframerate()
        n_frames = wf.getnframes()
        raw = wf.readframes(n_frames)
    if sampwidth == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sampwidth == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif sampwidth == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"Unsupported WAV sample width: {sampwidth}")
    data = data.reshape(-1, n_channels).T  # [channels, samples]
    return data, rate


def write_wav(path: str, waveform: np.ndarray, rate: int) -> None:
    """Write a mono/stereo float waveform as 16-bit PCM WAV."""
    wav = np.asarray(waveform)
    if wav.ndim == 1:
        wav = wav[None, :]
    pcm = np.clip(wav, -1.0, 1.0)
    pcm = (pcm * 32767.0).astype("<i2")
    with wave.open(str(path), "wb") as wf:
        wf.setnchannels(pcm.shape[0])
        wf.setsampwidth(2)
        wf.setframerate(rate)
        wf.writeframes(pcm.T.tobytes())


@lru_cache(maxsize=64)
def _sinc_kernel(src_rate: int, dst_rate: int, zeros: int = 24) -> np.ndarray:
    """Windowed-sinc polyphase kernel bank, shape [dst_step, taps].

    Equivalent to torchaudio's ``Resample`` (sinc interpolation with a Hann
    window); gcd-reduced so common ratios (44.1k→16k, 48k→16k) stay small.
    """
    g = np.gcd(src_rate, dst_rate)
    up, down = dst_rate // g, src_rate // g
    cutoff = 0.99 * 0.5 * min(1.0, up / down)
    taps_half = int(np.ceil(zeros * down / min(up, down)))
    # For each output phase p in [0, up), the fractional source position.
    kernels = []
    t = np.arange(-taps_half, taps_half + 1, dtype=np.float64)
    for p in range(up):
        frac = p * down / up
        x = (t - (frac - np.floor(frac))) * 2.0 * cutoff
        window = np.hanning(2 * taps_half + 1)
        k = 2.0 * cutoff * np.sinc(x) * window
        kernels.append(k)
    return np.stack(kernels).astype(np.float32)  # [up, taps]


def resample_np(waveform: np.ndarray, src_rate: int, dst_rate: int) -> np.ndarray:
    """Polyphase sinc resample on the host (numpy). waveform: [..., samples]."""
    if src_rate == dst_rate:
        return waveform
    g = np.gcd(src_rate, dst_rate)
    up, down = dst_rate // g, src_rate // g
    kernels = _sinc_kernel(src_rate, dst_rate)  # [up, taps]
    taps = kernels.shape[1]
    half = taps // 2
    n_in = waveform.shape[-1]
    n_out = int(np.floor(n_in * up / down))
    padded = np.pad(
        waveform, [(0, 0)] * (waveform.ndim - 1) + [(half, half + down)], mode="constant"
    )
    out = np.empty(waveform.shape[:-1] + (n_out,), dtype=np.float32)
    idx = np.arange(n_out)
    src_pos = (idx * down) // up  # integer source index per output sample
    phase = (idx * down) % up
    # Gather taps: out[i] = sum_t padded[src_pos[i] + t] * kernels[phase[i], t]
    gather = padded[..., src_pos[:, None] + np.arange(taps)[None, :]]
    out[...] = np.einsum("...ot,ot->...o", gather, kernels[phase])
    return out


def load_audio_fixed(
    path: str,
    target_rate: int = 16000,
    max_length: int = 160000,
    use_native: bool = True,
) -> np.ndarray:
    """Decode + resample + mono + pad/truncate to ``max_length`` (float32).

    Behavior parity with the reference loader (dataset_loaders.py:95-135):
    missing/corrupt files yield zeros; multi-channel is averaged to mono;
    long clips truncate from the front, short clips zero-pad at the end.

    Decode runs through the native C++ library (native/smmdata.cpp) when it
    builds on the host; the numpy path is the fallback.
    """
    if use_native:
        from . import native

        native.announce()
        if native.available():
            out = native.decode_audio(path, target_rate, max_length)
            if out is not None:
                return out
    try:
        wav, rate = read_wav(path)
    except Exception:
        return np.zeros(max_length, dtype=np.float32)
    if rate != target_rate:
        wav = resample_np(wav, rate, target_rate)
    if wav.shape[0] > 1:
        wav = wav.mean(axis=0, keepdims=True)
    wav = wav[0]
    if wav.shape[0] > max_length:
        wav = wav[:max_length]
    elif wav.shape[0] < max_length:
        wav = np.pad(wav, (0, max_length - wav.shape[0]))
    return wav.astype(np.float32)
