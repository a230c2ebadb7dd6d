"""Synthetic multimodal dataset generator (port of
simple_multimodal_tpu/data/sample_data.py).

Per-emotion procedural audio (sine recipes), per-emotion procedural video
(animated shapes and colours), ten texts per emotion, and shuffled
70/15/15 train/val/test CSV splits with the ``text, audio_path,
video_path, emotion, sample_id`` schema the dataset loaders consume. At
the same seed the WAVs, CSVs, ``generation_meta.json`` and (with OpenCV)
the mp4 clips are byte-equal to the JAX generator's.

Without OpenCV no mp4 can be encoded. Then each clip is stored as an empty
``video/<name>.mp4`` followed by the decoded-frame sidecars that both
packages' ``MultimodalDataset`` reads before any decode:
``<name>.mp4.vid.npy`` (the first ``SIDECAR_FRAMES`` frames at
``SIDECAR_SIZE``, uint8 [T, H, W, 3], as ``load_video_frames`` returns
them at the default config) and ``<name>.mp4.vid420.npy`` (their
``pack_yuv420``); ``generation_meta.json`` records ``"video_store":
"sidecar"`` and that geometry. Training then reads the frames that were
drawn, never black.
"""
import csv
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from . import video_io, video_wire
from .audio_io import write_wav

# the clip geometry of the sidecars written without OpenCV: ModelConfig's
# default video_max_frames and video_frame_size
SIDECAR_FRAMES = 30
SIDECAR_SIZE = (224, 224)

EMOTIONS = ["happy", "sad", "angry", "fear", "surprise", "disgust", "neutral"]

SAMPLE_TEXTS = {
    "happy": [
        "I'm so excited about this!", "This is the best day ever!",
        "I feel absolutely wonderful!", "Everything is going perfectly!",
        "I can't stop smiling!", "This makes me so happy!",
        "I'm thrilled about the news!", "Life is beautiful today!",
        "I'm overjoyed with the results!", "This brings me so much joy!",
    ],
    "sad": [
        "I feel really down today.", "This makes me so sad.",
        "I'm feeling quite depressed.", "Everything seems hopeless.",
        "I can't stop feeling blue.", "This is really disappointing.",
        "I feel like crying.", "My heart feels heavy.",
        "I'm going through a tough time.", "This news really upsets me.",
    ],
    "angry": [
        "This is absolutely infuriating!", "I'm so mad about this!",
        "This makes my blood boil!", "I can't believe this happened!",
        "This is completely unacceptable!", "I'm furious right now!",
        "This is driving me crazy!", "I'm really ticked off!",
        "This is so frustrating!", "I'm livid about this situation!",
    ],
    "fear": [
        "I'm really scared about this.", "This makes me very anxious.",
        "I'm worried something bad will happen.", "This terrifies me completely.",
        "I feel so nervous and afraid.", "This gives me the chills.",
        "I'm trembling with fear.", "This is my worst nightmare.",
        "I'm panicking about the outcome.", "This fills me with dread.",
    ],
    "surprise": [
        "Wow, I didn't expect that!", "This is so surprising!",
        "I can't believe my eyes!", "What a shocking revelation!",
        "This caught me off guard!", "I'm absolutely amazed!",
        "This is incredible!", "I never saw this coming!",
        "What a pleasant surprise!", "This is mind-blowing!",
    ],
    "disgust": [
        "This is absolutely revolting.", "I find this really disgusting.",
        "This makes me feel sick.", "This is completely repulsive.",
        "I can't stand this at all.", "This is so gross and nasty.",
        "This makes my stomach turn.", "I'm repelled by this behavior.",
        "This is utterly distasteful.", "This disgusts me to my core.",
    ],
    "neutral": [
        "This is a normal day.", "Everything seems ordinary.",
        "Nothing special is happening.", "This is just a regular occurrence.",
        "I'm feeling pretty neutral about this.", "This is neither good nor bad.",
        "It's just another typical situation.", "I have no strong feelings about this.",
        "This is quite unremarkable.", "Everything is proceeding as usual.",
    ],
}


def synth_audio(emotion: str, duration: float = 3.0, rate: int = 16000,
                rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Per-emotion procedural waveform (the reference generator's recipes)."""
    rng = rng or np.random.default_rng(0)
    t = np.linspace(0, duration, int(rate * duration))
    if emotion == "happy":
        audio = 0.3 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 880 * t)
        audio = audio + 0.1 * rng.standard_normal(t.shape)
    elif emotion == "sad":
        audio = 0.4 * np.sin(2 * np.pi * 220 * t) + 0.1 * np.sin(2 * np.pi * 110 * t)
        audio = audio * np.exp(-t * 0.5)
    elif emotion == "angry":
        audio = 0.5 * np.sin(2 * np.pi * 330 * t) + 0.3 * rng.standard_normal(t.shape)
    elif emotion == "fear":
        tremolo = 1 + 0.3 * np.sin(2 * np.pi * 5 * t)
        audio = 0.3 * np.sin(2 * np.pi * 400 * t) * tremolo
    elif emotion == "surprise":
        audio = np.zeros_like(t)
        a, b = int(len(t) * 0.3), int(len(t) * 0.7)
        audio[a:b] = 0.6 * np.sin(2 * np.pi * 600 * t[a:b])
    elif emotion == "disgust":
        audio = 0.4 * np.sin(2 * np.pi * 150 * t) + 0.2 * np.sin(2 * np.pi * 75 * t)
    else:  # neutral
        audio = 0.3 * np.sin(2 * np.pi * 300 * t)
    peak = np.max(np.abs(audio))
    if peak > 0:
        audio = audio / peak * 0.8
    return audio.astype(np.float32)


def synth_video(emotion: str, duration: float = 3.0, fps: int = 15,
                size: Tuple[int, int] = (224, 224),
                rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Per-emotion animated frames, uint8 RGB [T, H, W, 3].

    Each emotion gets a distinct coloured, animated pattern, drawn with
    numpy index math (no cv2 draw calls).
    """
    rng = rng or np.random.default_rng(0)
    w, h = size
    total = int(duration * fps)
    frames = np.zeros((total, h, w, 3), dtype=np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(total):
        frame = frames[i]
        if emotion == "happy":  # pulsing orange disc
            r = 50 + 20 * np.sin(i * 0.3)
            mask = (xx - w // 2) ** 2 + (yy - h // 2) ** 2 <= r * r
            frame[mask] = (255, 165, 0)
        elif emotion == "sad":  # blue drooping triangle
            x0, y0 = w // 4, h // 3
            x1, y1 = w // 2, h // 2 + 20
            x2, y2 = 3 * w // 4, h // 3
            d0 = (x1 - x0) * (yy - y0) - (y1 - y0) * (xx - x0)
            d1 = (x2 - x1) * (yy - y1) - (y2 - y1) * (xx - x1)
            d2 = (x0 - x2) * (yy - y2) - (y0 - y2) * (xx - x2)
            mask = ((d0 >= 0) & (d1 >= 0) & (d2 >= 0)) | ((d0 <= 0) & (d1 <= 0) & (d2 <= 0))
            frame[mask] = (0, 100, 255)
        elif emotion == "angry":  # red zigzag band
            phase = ((xx // 20) % 2) * 2 - 1
            band = np.abs(yy - (h // 2 + phase * h // 6 * np.sign(np.sin(xx * 0.3 + 1e-3)))) < 4
            frame[band] = (255, 0, 0)
        elif emotion == "fear":  # purple shaking disc
            nx, ny = int(10 * rng.standard_normal()), int(10 * rng.standard_normal())
            mask = (xx - (w // 2 + nx)) ** 2 + (yy - (h // 2 + ny)) ** 2 <= 30 * 30
            frame[mask] = (128, 0, 128)
        elif emotion == "surprise":  # expanding white ring
            r = min(20 + i * 2, 100)
            d2c = (xx - w // 2) ** 2 + (yy - h // 2) ** 2
            ring = (d2c <= (r + 2) ** 2) & (d2c >= (r - 2) ** 2)
            frame[ring] = (255, 255, 255)
        elif emotion == "disgust":  # green traveling wave of dots
            ys = (h // 2 + 30 * np.sin(xx[0] * 0.1 + i * 0.2)).astype(int)
            for x in range(0, w, 5):
                y = np.clip(ys[x], 3, h - 4)
                frame[y - 2 : y + 3, max(0, x - 2) : x + 3] = (0, 255, 0)
        else:  # neutral: gray rectangle outline
            t_ = 2
            frame[h // 4 : h // 4 + t_, w // 4 : 3 * w // 4] = (128, 128, 128)
            frame[3 * h // 4 - t_ : 3 * h // 4, w // 4 : 3 * w // 4] = (128, 128, 128)
            frame[h // 4 : 3 * h // 4, w // 4 : w // 4 + t_] = (128, 128, 128)
            frame[h // 4 : 3 * h // 4, 3 * w // 4 - t_ : 3 * w // 4] = (128, 128, 128)
    return frames


def create_sample_dataset(
    output_dir: str = "data/sample",
    num_samples_per_emotion: int = 10,
    emotions: Optional[List[str]] = None,
    seed: int = 42,
    duration: float = 3.0,
    difficulty: float = 0.0,
) -> str:
    """Generate media + train/val/test CSVs.

    ``difficulty`` in [0, 1] un-saturates the convergence bar (the default
    recipes are separable enough that val/test F1 hits 1.00 by epoch ~7 —
    round-4 finding: a saturated signal can't catch regressions). At
    difficulty d, each sample draws a random *confuser* emotion and:

    - audio/video are blended ``(1-a)*own + a*confuser`` with a = 0.5*d
      (recipe overlap — classes genuinely collide in feature space),
      plus extra audio noise at 0.25*d RMS;
    - with prob 0.5*d the text comes from the confuser (cross-modal
      conflict);
    - with prob 0.1*d the LABEL is flipped to the confuser (label noise:
      at d=1 the Bayes-optimal test F1 is ~0.9, so a perfect score is as
      suspicious as a collapsed one).

    d=0 reproduces the original generator bit-for-bit (no extra rng
    draws). The knob is recorded in ``generation_meta.json``. Without
    OpenCV the clips are stored as sidecars (module docstring).
    """
    difficulty = float(difficulty)
    if not 0.0 <= difficulty <= 1.0:
        raise ValueError(f"difficulty must be in [0, 1], got {difficulty}")
    emotions = emotions or EMOTIONS
    out = Path(output_dir)
    audio_dir = out / "audio"
    video_dir = out / "video"
    out.mkdir(parents=True, exist_ok=True)
    audio_dir.mkdir(exist_ok=True)
    video_dir.mkdir(exist_ok=True)

    sidecar = not video_io.has_opencv()
    rng = np.random.default_rng(seed)
    rows = []
    sample_id = 0
    for emotion in emotions:
        texts = SAMPLE_TEXTS.get(emotion, SAMPLE_TEXTS["neutral"])
        for i in range(num_samples_per_emotion):
            audio_name = f"{emotion}_{i:03d}.wav"
            video_name = f"{emotion}_{i:03d}.mp4"
            audio = synth_audio(emotion, duration, rng=rng)
            video = synth_video(emotion, duration, rng=rng)
            text = texts[i % len(texts)]
            label = emotion
            if difficulty > 0:
                others = [e for e in emotions if e != emotion] or [emotion]
                confuser = others[int(rng.integers(len(others)))]
                a = 0.5 * difficulty
                ca = synth_audio(confuser, duration, rng=rng)
                n = min(len(audio), len(ca))
                audio = ((1 - a) * audio[:n] + a * ca[:n]
                         + 0.25 * difficulty
                         * rng.standard_normal(n)).astype(np.float32)
                peak = np.max(np.abs(audio))
                if peak > 0:
                    audio = (audio / peak * 0.8).astype(np.float32)
                cv = synth_video(confuser, duration, rng=rng)
                t = min(len(video), len(cv))
                video = ((1 - a) * video[:t].astype(np.float32)
                         + a * cv[:t].astype(np.float32)).clip(
                             0, 255).astype(np.uint8)
                if rng.random() < 0.5 * difficulty:
                    ctexts = SAMPLE_TEXTS.get(confuser,
                                              SAMPLE_TEXTS["neutral"])
                    text = ctexts[int(rng.integers(len(ctexts)))]
                if rng.random() < 0.1 * difficulty:
                    label = confuser
            write_wav(audio_dir / audio_name, audio, 16000)
            if sidecar:
                _write_sidecar_clip(video_dir / video_name, video)
            else:
                video_io.write_video(video_dir / video_name, video)
            rows.append({
                "text": text,
                "audio_path": f"audio/{audio_name}",
                "video_path": f"video/{video_name}",
                "emotion": label,
                "sample_id": sample_id,
            })
            sample_id += 1

    order = rng.permutation(len(rows))
    rows = [rows[i] for i in order]
    n = len(rows)
    train_end = int(n * 0.7)
    val_end = train_end + int(n * 0.15)
    splits = {
        "train": rows[:train_end],
        "val": rows[train_end:val_end],
        "test": rows[val_end:],
    }
    for name, data in splits.items():
        with open(out / f"{name}.csv", "w", newline="") as f:
            writer = csv.DictWriter(
                f, fieldnames=["text", "audio_path", "video_path", "emotion", "sample_id"]
            )
            writer.writeheader()
            writer.writerows(data)
    import json

    meta = {"seed": seed, "duration": duration, "difficulty": difficulty,
            "num_samples_per_emotion": num_samples_per_emotion,
            "emotions": list(emotions)}
    if sidecar:
        meta.update({"video_store": "sidecar", "video_frames": SIDECAR_FRAMES,
                     "video_frame_size": list(SIDECAR_SIZE)})
    with open(out / "generation_meta.json", "w") as f:
        json.dump(meta, f, indent=2)
    return str(out)


def _write_sidecar_clip(path: Path, frames: np.ndarray) -> None:
    """An empty clip, then its decoded-frame sidecars (written after it, so
    the datasets' mtime rule takes them)."""
    path.write_bytes(b"")
    w, h = SIDECAR_SIZE
    clip = np.zeros((SIDECAR_FRAMES, h, w, 3), np.uint8)
    n = min(len(frames), SIDECAR_FRAMES)
    if frames.shape[1:3] != (h, w):
        raise ValueError(f"sidecar clips are {SIDECAR_SIZE}, got frames {frames.shape}")
    clip[:n] = frames[:n]
    np.save(path.with_suffix(path.suffix + ".vid.npy"), clip)
    np.save(path.with_suffix(path.suffix + ".vid420.npy"), video_wire.pack_yuv420(clip))
