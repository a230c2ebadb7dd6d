#!/usr/bin/env python
"""Sample data generator CLI of the PyTorch port (simple_multimodal_tpu_torch).

Takes ``create_sample_data.py``'s flags and writes the same set:
procedural per-emotion audio (WAV), video, texts and train/val/test CSVs.
With OpenCV the clips are mp4 files, byte-equal to the JAX generator's at
the same seed; without it each clip is an empty mp4 beside its
decoded-frame sidecars (``data/sample_data.py``), and the run says so.
"""
import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from simple_multimodal_tpu_torch.data.sample_data import (  # noqa: E402
    EMOTIONS, create_sample_dataset,
)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Create sample multimodal emotion dataset")
    parser.add_argument("--output_dir", type=str, default="data/sample",
                        help="Output directory for sample dataset")
    parser.add_argument("--num_samples", type=int, default=10,
                        help="Number of samples per emotion")
    parser.add_argument("--emotions", nargs="+", default=list(EMOTIONS),
                        help="List of emotions to generate")
    parser.add_argument("--duration", type=float, default=3.0,
                        help="Clip duration in seconds")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--difficulty", type=float, default=0.0,
                        help="0 (default, separable recipes) .. 1 (hard: "
                             "blended class recipes, cross-modal text "
                             "conflicts, 10%% label noise)")
    return parser


def main(argv=None) -> str:
    args = build_parser().parse_args(argv)
    np.random.seed(args.seed)
    path = create_sample_dataset(
        output_dir=args.output_dir,
        num_samples_per_emotion=args.num_samples,
        emotions=args.emotions,
        seed=args.seed,
        duration=args.duration,
        difficulty=args.difficulty,
    )
    with open(os.path.join(path, "generation_meta.json")) as f:
        store = json.load(f).get("video_store", "mp4")
    print("Sample dataset ready!")
    print(f"Location: {path}")
    print(f"Video clips stored as: {store}"
          + (" (no OpenCV here: empty mp4 files beside decoded-frame sidecars)"
             if store == "sidecar" else ""))
    print("You can now test the system with:")
    print(f"python train_advanced_torch.py --data_path {path} --epochs 5")
    return path


if __name__ == "__main__":
    main()
