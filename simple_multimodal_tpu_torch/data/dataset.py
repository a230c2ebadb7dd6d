"""CSV-driven multimodal datasets and the host batch loader (port of
simple_multimodal_tpu/data/dataset.py).

``MultimodalDataset`` and its four named subclasses, ``FewShotDataset``,
``collate``, ``DataLoader`` (seeded per-epoch shuffle, wrap padding of the
last batch), ``create_dataloader`` and ``get_dataset``, as numpy on the
host, with items and batches byte-equal to the JAX package's on the same
files:

- every batch is fixed-shape: ``input_ids i32[B, S]``, ``audio
  i16[B, samples]``, ``video uint8[B, T, H*3//2, W]`` (packed yuv420;
  ``[B, T, H, W, 3]`` under ``video_wire_format="rgb8"``); unpacking and
  normalisation run on the device (``data/video_wire.py``);
- decoded media is memoised to ``.npy`` sidecars beside the media
  (``cache_decoded``): kinds ``aud16``/``aud``, ``vid420``/``vid``, used
  while no older than their media file; a missing video file gives black
  (packed black is Y=0, U=V=128);
- augmentation runs on the device in the train step (``data/augment.py``).

One rule the JAX dataset lacks: an empty clip (the sample generator's
store on a host without OpenCV) is read from its sidecar only. A sidecar
of other geometry than the config's frames raises, naming both shapes; an
empty clip is never decoded to black.
"""
import csv
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from . import video_wire
from .audio_io import load_audio_fixed
from .tokenizer import get_tokenizer
from .video_io import is_empty_clip, load_video_frames, sidecar_frames


def _read_csv(path: Path) -> List[Dict[str, str]]:
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


class MultimodalDataset:
    """Base multimodal dataset: one split's CSV rows, tokenised up front."""

    def __init__(
        self,
        data_path: str,
        split: str = "train",
        config=None,
        augment: bool = False,
        cache_decoded: bool = True,
    ):
        self.data_path = Path(data_path)
        self.split = split
        self.config = config
        self.augment = augment
        self.cache_decoded = cache_decoded

        self.tokenizer = get_tokenizer(
            config.text_model_name, config.text_max_length,
            spm_path=getattr(config, "spm_model_path", None))
        self.data = self._load_data()
        self.emotion_to_id = {e: i for i, e in enumerate(config.emotion_labels)}
        self.id_to_emotion = {i: e for e, i in self.emotion_to_id.items()}
        # Tokenize the whole split up front: text is tiny and this keeps the
        # per-batch host work to media decode only.
        texts = [row["text"] for row in self.data]
        if texts:
            enc = self.tokenizer(texts, max_length=config.text_max_length)
            self._input_ids = enc["input_ids"]
            self._attention_mask = enc["attention_mask"]
        else:
            L = config.text_max_length
            self._input_ids = np.zeros((0, L), np.int32)
            self._attention_mask = np.zeros((0, L), np.int32)

    def _load_data(self) -> List[Dict[str, str]]:
        csv_path = self.data_path / f"{self.split}.csv"
        if not csv_path.exists():
            raise FileNotFoundError(f"Dataset file not found: {csv_path}")
        return _read_csv(csv_path)

    def __len__(self) -> int:
        return len(self.data)

    # -- media decode with sidecar cache ------------------------------------
    def _cached(self, media_path: Path, kind: str, loader):
        if not self.cache_decoded:
            return loader()
        cache_path = media_path.with_suffix(media_path.suffix + f".{kind}.npy")
        if cache_path.exists():
            try:
                # invalidate if the source media changed after caching
                if cache_path.stat().st_mtime >= media_path.stat().st_mtime:
                    return np.load(cache_path)
            except Exception:
                pass
        arr = loader()
        try:
            np.save(cache_path, arr)
        except Exception:
            pass
        return arr

    # Audio crosses the host→device boundary as int16 (the WAV source
    # precision): half the transfer bytes and cache size; encoders and train
    # steps dequantize on device. Set ship_audio_int16=False for f32.
    ship_audio_int16 = True

    def _audio(self, rel_path: str) -> np.ndarray:
        full = self.data_path / rel_path
        dtype = np.int16 if self.ship_audio_int16 else np.float32
        if not full.exists():
            return np.zeros(self.config.audio_max_length, dtype)

        def load():
            wav = load_audio_fixed(
                full, self.config.audio_sample_rate, self.config.audio_max_length
            )
            if self.ship_audio_int16:
                return np.clip(wav * 32768.0, -32768, 32767).astype(np.int16)
            return wav

        return self._cached(full, "aud16" if self.ship_audio_int16 else "aud",
                            load)

    def _video(self, rel_path: str) -> np.ndarray:
        full = self.data_path / rel_path
        size = tuple(self.config.video_frame_size)
        w, h = size
        pack = (getattr(self.config, "video_wire_format", "rgb8") == "yuv420"
                and video_wire.can_pack(h, w))
        T = self.config.video_max_frames
        if is_empty_clip(full):
            if pack:
                return sidecar_frames(full, "vid420", (T, video_wire.packed_height(h), w))
            return sidecar_frames(full, "vid", (T, h, w, 3))
        if not full.exists():
            if pack:
                # packed BLACK, not raw zeros: zero chroma bytes decode to
                # U=V=-128 → green frames; black is Y=0, U=V=128
                z = np.zeros((self.config.video_max_frames,
                              video_wire.packed_height(h), w), np.uint8)
                z[:, h:, :] = 128
                return z
            return np.zeros((self.config.video_max_frames, h, w, 3), np.uint8)
        if pack:
            # packed sidecar: warm epochs read half the bytes off disk too
            return self._cached(
                full, "vid420",
                lambda: video_wire.pack_yuv420(load_video_frames(
                    full, self.config.video_max_frames, size)),
            )
        return self._cached(
            full, "vid",
            lambda: load_video_frames(full, self.config.video_max_frames, size),
        )

    def __getitem__(self, idx: int) -> Dict:
        row = self.data[idx]
        return {
            "text": {
                "input_ids": self._input_ids[idx],
                "attention_mask": self._attention_mask[idx],
            },
            "audio": self._audio(row["audio_path"]),
            "video": self._video(row["video_path"]),
            "emotion": np.int32(self.emotion_to_id[row["emotion"]]),
            "text_raw": row["text"],
            "sample_id": idx,
        }


class CMUMOSEIDataset(MultimodalDataset):
    """CMU-MOSEI CSVs."""


class MELDDataset(MultimodalDataset):
    """MELD CSVs."""


class IEMOCAPDataset(MultimodalDataset):
    """IEMOCAP CSVs."""


class SamplePDataset(MultimodalDataset):
    """Synthetic sample CSVs."""


class FewShotDataset:
    """Seeded n-shot-per-class subset."""

    def __init__(self, base_dataset: MultimodalDataset, n_shot: int,
                 n_way: Optional[int] = None, seed: int = 42):
        self.base_dataset = base_dataset
        self.n_shot = n_shot
        self.n_way = n_way or base_dataset.config.num_emotions
        rng = np.random.default_rng(seed)

        indices_by_class: Dict[int, List[int]] = {}
        for idx in range(len(base_dataset)):
            emotion = base_dataset.data[idx]["emotion"]
            cid = base_dataset.emotion_to_id[emotion]
            indices_by_class.setdefault(cid, []).append(idx)

        few_shot: List[int] = []
        for cid in range(self.n_way):
            if cid in indices_by_class:
                pool = indices_by_class[cid]
                take = min(n_shot, len(pool))
                few_shot.extend(rng.choice(pool, take, replace=False).tolist())
        self.few_shot_indices = few_shot
        self.config = base_dataset.config
        self.emotion_to_id = base_dataset.emotion_to_id

    def __len__(self) -> int:
        return len(self.few_shot_indices)

    def __getitem__(self, idx: int) -> Dict:
        return self.base_dataset[self.few_shot_indices[idx]]


def collate(items: Sequence[Dict]) -> Dict:
    """Stack per-item dicts into one fixed-shape batch."""
    return {
        "text": {
            "input_ids": np.stack([it["text"]["input_ids"] for it in items]),
            "attention_mask": np.stack([it["text"]["attention_mask"] for it in items]),
        },
        "audio": np.stack([it["audio"] for it in items]),
        "video": np.stack([it["video"] for it in items]),
        "emotion": np.stack([it["emotion"] for it in items]),
        "text_raw": [it["text_raw"] for it in items],
        "sample_ids": [it["sample_id"] for it in items],
    }


class DataLoader:
    """Minimal epoch iterator over a dataset with shuffling and fixed batches.

    No worker processes: decode cost is paid once thanks to the sidecar
    cache, and batches are plain numpy dicts that ``data/pipeline.py``
    ships to the card.
    ``drop_last_to_multiple`` pads the final short batch by wrapping around so
    every step sees the same batch shape; wrapped duplicates
    are marked in ``sample_ids`` consumers can mask on.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __iter__(self) -> Iterator[Dict]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(order)
        self._epoch += 1
        for start in range(0, n, self.batch_size):
            idx = order[start : start + self.batch_size]
            if len(idx) == 0:
                continue
            if self.drop_last and len(idx) < self.batch_size:
                break
            if len(idx) < self.batch_size:
                # wrap-pad to keep shapes static; duplicates share sample_ids
                # (cycle: the dataset may be smaller than one batch)
                reps = int(np.ceil((self.batch_size - len(idx)) / n))
                pad = np.tile(order, reps)[: self.batch_size - len(idx)]
                idx = np.concatenate([idx, pad])
            yield collate([self.dataset[int(i)] for i in idx])


def create_dataloader(dataset, batch_size: int, shuffle: bool = True,
                      num_workers: int = 0, pin_memory: bool = True,
                      seed: int = 0) -> DataLoader:
    """Factory with the reference loader's signature.

    ``num_workers``/``pin_memory`` are accepted for API compatibility; this
    pipeline has no worker processes (decode is cached) and device transfer is
    handled by the prefetcher.
    """
    del num_workers, pin_memory
    return DataLoader(dataset, batch_size, shuffle=shuffle, seed=seed)


def get_dataset(dataset_name: str, data_path: str, split: str, config,
                augment: bool = False) -> MultimodalDataset:
    """Name→class factory."""
    dataset_classes = {
        "cmu_mosei": CMUMOSEIDataset,
        "meld": MELDDataset,
        "iemocap": IEMOCAPDataset,
        "multimodal": MultimodalDataset,
        "sample": SamplePDataset,
    }
    if dataset_name not in dataset_classes:
        raise ValueError(f"Unknown dataset: {dataset_name}")
    return dataset_classes[dataset_name](
        data_path=data_path, split=split, config=config, augment=augment
    )
