#!/usr/bin/env python
"""Import pretrained HF backbones (safetensors) into a checkpoint of the
PyTorch port (beside ``tools/import_hf_backbones.py``).

Takes the ``model.safetensors`` files (or directories, or sharded
checkpoints) of the three backbone repos, loads them into a freshly
initialised port model (``models/safetensors_io.load_pretrained_backbones``:
every key must match) and writes a port checkpoint directory with its
config, which ``load_pretrained_model``, ``evaluate_model_torch.py`` and
``demo/serve_torch.py`` read. The ``safetensors`` package is not needed.

    python tools/import_hf_backbones_torch.py \\
        --text  /ckpts/deberta-v3-base \\
        --audio /ckpts/wav2vec2-base-960h \\
        --video /ckpts/vit-base-patch16-224 \\
        --output checkpoints/pretrained_base

Any subset of --text/--audio/--video may be given; the rest keep their
initialisation from ``--seed``. ``--device`` defaults to ``cuda`` (the card,
raising without one); ``cpu`` builds the model on the CPU.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from simple_multimodal_tpu_torch.config import ModelConfig  # noqa: E402


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(
        description="Load HF safetensors backbones into a port checkpoint")
    ap.add_argument("--text", help="DeBERTa-v2/v3 safetensors file or dir")
    ap.add_argument("--audio", help="Wav2Vec2 safetensors file or dir")
    ap.add_argument("--video", help="ViT safetensors file or dir")
    ap.add_argument("--output", required=True, help="Output checkpoint directory")
    ap.add_argument("--fusion_type", default="hierarchical",
                    choices=["early", "late", "mult", "graph",
                             "contrastive", "adaptive", "hierarchical"])
    ap.add_argument("--preset", default="base", choices=["tiny", "half", "base"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default): the card, raising without one; cpu: the CPU")
    args = ap.parse_args(argv)
    if not (args.text or args.audio or args.video):
        ap.error("give at least one of --text/--audio/--video")

    import torch

    from simple_multimodal_tpu_torch.models.multimodal_model import create_model
    from simple_multimodal_tpu_torch.models.safetensors_io import load_pretrained_backbones
    from simple_multimodal_tpu_torch.train.checkpoint import save_checkpoint

    cfg = ModelConfig(encoder_preset=args.preset)
    cfg.fusion_type = args.fusion_type
    model = create_model(cfg, device=args.device,
                         generator=torch.Generator().manual_seed(args.seed))
    load_pretrained_backbones(model, text=args.text, audio=args.audio, video=args.video)
    save_checkpoint(args.output, model, config=cfg)
    done = [n for n, v in (("text", args.text), ("audio", args.audio),
                           ("video", args.video)) if v]
    print(f"Imported {'+'.join(done)} backbones -> {args.output}")
    return args.output


if __name__ == "__main__":
    main()
