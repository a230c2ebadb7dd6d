#!/usr/bin/env python
"""Convert a reference PyTorch checkpoint into a checkpoint of the PyTorch
port (beside ``tools/convert_checkpoint.py``).

Takes the reference's layouts (a raw ``state_dict`` or
``{'model_state_dict': ...}`` in a ``.pth`` file, or a ``.safetensors``
export of its state_dict, read without the ``safetensors`` package) and
writes a port checkpoint directory with its config, which
``load_pretrained_model``, ``evaluate_model_torch.py`` and
``demo/serve_torch.py`` read. The port keeps the reference's parameter
names (both LSTM biases too), so the weights load by name: every key the
standard model reads must be there, and no other. Left out, as the
standard model never reads them: the encoders' adapters, the text prompt
and, under late fusion, the classifier.

    python tools/convert_checkpoint_torch.py --torch_checkpoint best.pth \\
        --output checkpoints/converted --fusion_type hierarchical

``--device`` defaults to ``cuda`` (the card, raising without one); ``cpu``
builds the model on the CPU.
"""
import argparse
import os
import sys
from typing import Dict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from simple_multimodal_tpu_torch.config import ModelConfig  # noqa: E402


def port_state_dict(sd: Dict, fusion_type: str) -> Dict:
    """The reference MultimodalEmotionModel's state_dict under the port's
    names, without the parameters its standard forward never reads."""
    import torch

    from simple_multimodal_tpu_torch.models.safetensors_io import hf_names

    unread = (".adapter.", "text_encoder.prompt_embeddings")
    out = {}
    for k, v in hf_names(sd).items():
        if any(u in f".{k}" for u in unread):
            continue
        if fusion_type == "late" and k.startswith("classifier."):
            continue
        out[k] = v if isinstance(v, torch.Tensor) else torch.as_tensor(v)
    return out


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(
        description="Convert a reference torch checkpoint into a port checkpoint")
    parser.add_argument("--torch_checkpoint", required=True,
                        help=".pth file from the reference implementation, or a "
                             ".safetensors export of its state_dict")
    parser.add_argument("--output", required=True, help="Output checkpoint directory")
    parser.add_argument("--fusion_type", default="hierarchical",
                        choices=["early", "late", "mult", "graph",
                                 "contrastive", "adaptive", "hierarchical"])
    parser.add_argument("--preset", default="base", choices=["tiny", "half", "base"])
    parser.add_argument("--device", default="cuda",
                        help="cuda (default): the card, raising without one; cpu: the CPU")
    args = parser.parse_args(argv)

    import torch

    from simple_multimodal_tpu_torch.models.multimodal_model import create_model
    from simple_multimodal_tpu_torch.models.safetensors_io import load_safetensors
    from simple_multimodal_tpu_torch.train.checkpoint import save_checkpoint

    if args.torch_checkpoint.endswith(".safetensors"):
        sd = load_safetensors(args.torch_checkpoint)
    else:
        # the reference's checkpoints may pickle more than tensors
        ckpt = torch.load(args.torch_checkpoint, map_location="cpu", weights_only=False)
        sd = ckpt.get("model_state_dict", ckpt) if isinstance(ckpt, dict) else ckpt

    config = ModelConfig(encoder_preset=args.preset)
    config.fusion_type = args.fusion_type
    model = create_model(config, device=args.device)
    model.load_state_dict(port_state_dict(sd, args.fusion_type))
    save_checkpoint(args.output, model, config=config)
    print(f"Converted checkpoint written to: {args.output}")
    return args.output


if __name__ == "__main__":
    main()
