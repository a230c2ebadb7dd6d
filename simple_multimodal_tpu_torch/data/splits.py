"""Dataset split utilities (port of simple_multimodal_tpu/data/splits.py):
stratified k-fold index generation and ratio splits by ``DataConfig``'s
``k_folds`` / ``test_split`` / ``val_split``, and a CSV re-splitter that
turns any combined CSV into the train/val/test layout the dataset loaders
consume. Same indices and files as the JAX functions at the same seed.
"""
import csv
from pathlib import Path
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np


def kfold_indices(labels: Sequence, k: int, seed: int = 42
                  ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Stratified k-fold: yields (train_idx, val_idx) per fold.

    Each class's samples are shuffled and dealt round-robin across folds, so
    every fold sees every class when possible.
    """
    labels = np.asarray(labels)
    rng = np.random.default_rng(seed)
    folds: List[List[int]] = [[] for _ in range(k)]
    for cls in np.unique(labels):
        idx = np.flatnonzero(labels == cls)
        rng.shuffle(idx)
        for i, j in enumerate(idx):
            folds[i % k].append(int(j))
    all_idx = set(range(len(labels)))
    for f in range(k):
        val = np.array(sorted(folds[f]), dtype=np.int64)
        train = np.array(sorted(all_idx - set(folds[f])), dtype=np.int64)
        yield train, val


def ratio_split(labels: Sequence, test_split: float = 0.2,
                val_split: float = 0.1, seed: int = 42
                ) -> Dict[str, np.ndarray]:
    """Stratified train/val/test split by ratios (DataConfig semantics)."""
    labels = np.asarray(labels)
    rng = np.random.default_rng(seed)
    out = {"train": [], "val": [], "test": []}
    for cls in np.unique(labels):
        idx = np.flatnonzero(labels == cls)
        rng.shuffle(idx)
        n = len(idx)
        n_test = int(round(n * test_split))
        n_val = int(round(n * val_split))
        out["test"].extend(idx[:n_test].tolist())
        out["val"].extend(idx[n_test:n_test + n_val].tolist())
        out["train"].extend(idx[n_test + n_val:].tolist())
    return {k: np.array(sorted(v), dtype=np.int64) for k, v in out.items()}


def write_split_csvs(rows: List[Dict], splits: Dict[str, np.ndarray],
                     output_dir: str) -> None:
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    fieldnames = list(rows[0].keys()) if rows else [
        "text", "audio_path", "video_path", "emotion", "sample_id"]
    for name, idx in splits.items():
        with open(out / f"{name}.csv", "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=fieldnames)
            writer.writeheader()
            writer.writerows([rows[int(i)] for i in idx])


def kfold_csvs(csv_path: str, output_dir: str, k: int, seed: int = 42,
               val_from_train: float = 0.1) -> List[str]:
    """Split one combined CSV into k fold directories (train/val/test each).

    Fold f's validation fold becomes test.csv; a slice of the remaining
    training rows becomes val.csv (the loaders expect all three splits).
    """
    with open(csv_path, newline="") as f:
        rows = list(csv.DictReader(f))
    labels = [r["emotion"] for r in rows]
    dirs = []
    for f_i, (train_idx, test_idx) in enumerate(kfold_indices(labels, k, seed)):
        rng = np.random.default_rng(seed + f_i)
        train_idx = train_idx.copy()
        rng.shuffle(train_idx)
        n_val = max(int(round(len(train_idx) * val_from_train)), 1)
        splits = {
            "train": np.sort(train_idx[n_val:]),
            "val": np.sort(train_idx[:n_val]),
            "test": test_idx,
        }
        fold_dir = str(Path(output_dir) / f"fold_{f_i}")
        write_split_csvs(rows, splits, fold_dir)
        dirs.append(fold_dir)
    return dirs
