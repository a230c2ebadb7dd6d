"""safetensors reader and writer with no ``safetensors`` package, and the
import of HF backbones into a port model (port of
simple_multimodal_tpu/models/safetensors_io.py).

The container: an 8-byte little-endian u64 header length, a JSON header
mapping each tensor's name to {dtype, shape, data_offsets}, then a flat
byte buffer. Reads go through numpy (a memory map of the file) into torch
tensors, so bf16 and fp8 tensors need no numpy dtype of their own; the
writer takes tensors or numpy arrays and, given numpy arrays, writes the
same bytes as the JAX package's writer (which stores a 0-d array as [1]).

``load_state_dict`` reads a file, a directory holding
``model.safetensors``, or a sharded ``model.safetensors.index.json``, and
strips an architecture prefix (``deberta.``, ``wav2vec2.``, ``vit.``, ...)
that every key shares. ``load_pretrained_backbones`` loads HF checkpoints
of DeBERTa-v2/v3 (or DeepSeek-V3, for the Moonlight tower), wav2vec2 and
ViT into ``text_encoder.model``, ``audio_encoder.model`` and
``video_encoder.vit``, whose parameter names are HF's: a missing or
unexpected key raises, naming it.

    from simple_multimodal_tpu_torch.models.safetensors_io import load_pretrained_backbones
    load_pretrained_backbones(model, text="/ckpts/deberta-v3-base",
                              audio="/ckpts/wav2vec2-base-960h",
                              video="/ckpts/vit-base-patch16-224")
"""
import json
import os
import re
import struct
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch

DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "F8_E4M3": torch.float8_e4m3fn, "F8_E5M2": torch.float8_e5m2,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U64": torch.uint64, "U32": torch.uint32, "U16": torch.uint16, "U8": torch.uint8,
    "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in DTYPES.items()}


def load_safetensors(path: str, keep: Optional[Callable[[str], bool]] = None
                     ) -> Dict[str, torch.Tensor]:
    """One .safetensors file → {name: CPU tensor}; with ``keep``, only the
    tensors whose name it accepts are read."""
    with open(path, "rb") as f:
        (header_len,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(header_len).decode("utf-8"))
    data = np.memmap(path, dtype=np.uint8, mode="r", offset=8 + header_len)
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__" or (keep is not None and not keep(name)):
            continue
        dtype = DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: unsupported safetensors dtype {info['dtype']!r}"
                             f" for tensor {name!r}")
        start, end = info["data_offsets"]
        if start == end:
            out[name] = torch.empty(info["shape"], dtype=dtype)
            continue
        raw = torch.from_numpy(np.array(data[start:end]))
        out[name] = raw.view(dtype).reshape(info["shape"])
    return out


def _tensor_bytes(value) -> tuple:
    """(safetensors dtype name, shape, bytes) of a tensor or numpy array."""
    t = value.detach().cpu() if isinstance(value, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(value))
    name = _NAMES.get(t.dtype)
    if name is None:
        raise ValueError(f"unsupported dtype {t.dtype}")
    t = t.contiguous()
    raw = t.reshape(-1).view(torch.uint8).numpy().tobytes() if t.numel() else b""
    return name, list(t.shape), raw


def save_safetensors(tensors: Mapping, path: str,
                     metadata: Optional[Dict[str, str]] = None) -> None:
    """Write a .safetensors file from tensors or numpy arrays."""
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = dict(metadata)
    bufs = []
    offset = 0
    for name, value in tensors.items():
        try:
            dtype, shape, raw = _tensor_bytes(value)
        except ValueError as e:
            raise ValueError(f"{e} for {name!r}") from None
        header[name] = {"dtype": dtype, "shape": shape,
                        "data_offsets": [offset, offset + len(raw)]}
        bufs.append(raw)
        offset += len(raw)
    hjson = json.dumps(header, separators=(",", ":")).encode("utf-8")
    hjson += b" " * ((-(8 + len(hjson))) % 8)  # 8-byte-align the data section
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hjson)))
        f.write(hjson)
        for raw in bufs:
            f.write(raw)


# prefixes of the HF task-model wrappers; stripped when every key has one
_ARCH_PREFIXES = ("deberta.", "wav2vec2.", "vit.", "model.", "bert.", "roberta.")


def _strip_shared_prefix(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    for prefix in _ARCH_PREFIXES:
        if sd and all(k.startswith(prefix) for k in sd):
            return {k[len(prefix):]: v for k, v in sd.items()}
    return sd


def load_state_dict(path: str, keep: Optional[Callable[[str], bool]] = None
                    ) -> Dict[str, torch.Tensor]:
    """A safetensors checkpoint (a file, a directory holding
    ``model.safetensors``, a sharded ``model.safetensors.index.json``, or
    a directory of .safetensors files) with a shared architecture prefix
    stripped; with ``keep``, only the tensors whose (file) name it accepts
    are read."""
    if os.path.isdir(path):
        index = os.path.join(path, "model.safetensors.index.json")
        single = os.path.join(path, "model.safetensors")
        if os.path.isfile(index):
            with open(index) as f:
                weight_map = json.load(f)["weight_map"]
            files = sorted(set(weight_map.values()))
        elif os.path.isfile(single):
            files = ["model.safetensors"]
        else:
            files = [f for f in sorted(os.listdir(path)) if f.endswith(".safetensors")]
            if not files:
                raise FileNotFoundError(f"{path}: no model.safetensors[.index.json] found")
        sd: Dict[str, torch.Tensor] = {}
        for name in files:
            sd.update(load_safetensors(os.path.join(path, name), keep))
    else:
        sd = load_safetensors(path, keep)
    return _strip_shared_prefix(sd)


def hf_names(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """HF's weight-norm parametrization of wav2vec2's positional conv
    (``parametrizations.weight.original0/1``, newer transformers) under the
    port's names (``weight_g`` / ``weight_v``, as older checkpoints)."""
    renames = {"parametrizations.weight.original0": "weight_g",
               "parametrizations.weight.original1": "weight_v"}
    out = {}
    for k, v in sd.items():
        for old, new in renames.items():
            if k.endswith(old):
                k = k[:-len(old)] + new
        out[k] = v
    return out


_LAYER = re.compile(r"^(?:model\.)?layers\.(\d+)\.")
_EXPERT = re.compile(r"\.mlp\.experts\.(\d+)\.")


def deepseek_state_dict(path: str, cfg) -> Dict[str, torch.Tensor]:
    """A DeepSeek-V3 checkpoint (``DeepseekV3ForCausalLM``'s names, under
    ``model.``) as the tower of ``cfg`` (``models/deepseek.py``) holds it:
    the first ``num_hidden_layers`` layers and, of each MoE layer's routed
    experts, only the held ones (``cfg.held_experts``, by their global
    indices); the LM head and every other tensor are never read."""
    held = set(cfg.held_experts)

    def keep(name: str) -> bool:
        if name.startswith("lm_head."):
            return False
        layer = _LAYER.match(name)
        if layer and int(layer.group(1)) >= cfg.num_hidden_layers:
            return False
        expert = _EXPERT.search(name)
        return not expert or int(expert.group(1)) in held

    sd = load_state_dict(path, keep)
    return {k[len("model."):] if k.startswith("model.") else k: v for k, v in sd.items()}


def load_pretrained_backbones(model, text: Optional[str] = None, audio: Optional[str] = None,
                              video: Optional[str] = None):
    """HF safetensors checkpoints into a port model's backbones in place:
    ``text`` (DeBERTa-v2/v3, or a DeepSeek-V3 checkpoint such as
    Moonlight-16B-A3B's where the tower is that decoder: its kept layers
    and held experts, ``deepseek_state_dict``) into ``text_encoder.model``,
    ``audio`` (wav2vec2) into ``audio_encoder.model``, ``video`` (ViT) into
    ``video_encoder.vit``. Every key must match: ``load_state_dict`` raises
    naming the missing and unexpected ones, and any shape that differs.
    Returns the model."""
    from .deepseek import DeepseekModel

    tower = model.text_encoder.model
    if text is not None and isinstance(tower, DeepseekModel):
        tower.load_state_dict(deepseek_state_dict(text, tower.cfg), strict=True)
        text = None
    for path, module in ((text, tower), (audio, model.audio_encoder.model),
                         (video, model.video_encoder.vit)):
        if path is not None:
            module.load_state_dict(hf_names(load_state_dict(path)), strict=True)
    return model
