"""Model configuration for the PyTorch port.

A stdlib copy of simple_multimodal_tpu's ``ModelConfig`` (same fields,
defaults and JSON round-trip), so the port never imports the JAX package:
importing that package's config runs its ``__init__``, which imports jax
whenever ``JAX_PLATFORMS`` is set. Like the reference, constructing a
``ModelConfig`` creates its data/save/log directories; no instance is made
at import time here.
"""
import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple


@dataclass
class ModelConfig:
    """Model configuration parameters (reference: config.py:6-79)."""

    # Text encoder
    text_model_name: str = "microsoft/deberta-v3-base"
    text_hidden_size: int = 768
    text_max_length: int = 512

    # Audio encoder
    audio_model_name: str = "facebook/wav2vec2-base-960h"
    audio_hidden_size: int = 768
    audio_sample_rate: int = 16000
    audio_max_length: int = 160000  # 10 seconds at 16kHz

    # Video encoder
    video_model_name: str = "google/vit-base-patch16-224"
    video_hidden_size: int = 768
    video_frame_size: Tuple[int, int] = (224, 224)
    video_max_frames: int = 30

    # Fusion parameters
    fusion_hidden_size: int = 512
    fusion_dropout: float = 0.1
    fusion_num_heads: int = 8
    fusion_num_layers: int = 4

    # Emotion classification
    num_emotions: int = 7  # happy, sad, angry, fear, surprise, disgust, neutral
    emotion_labels: List[str] = None

    # Graph fusion parameters
    graph_hidden_size: int = 256
    graph_num_layers: int = 3
    graph_dropout: float = 0.1

    # Contrastive learning parameters
    contrastive_temperature: float = 0.07
    contrastive_margin: float = 0.5

    # Few-shot learning parameters
    adapter_size: int = 64
    prompt_length: int = 10

    # Knowledge distillation parameters
    distill_temperature: float = 4.0
    distill_alpha: float = 0.7

    # Training parameters
    batch_size: int = 8
    learning_rate: float = 1e-4
    weight_decay: float = 1e-5
    num_epochs: int = 100
    warmup_steps: int = 1000
    gradient_clip_norm: float = 1.0

    # Data paths
    data_path: str = "./data"
    save_path: str = "./checkpoints"
    log_path: str = "./logs"

    # Device configuration
    device: str = "auto"  # auto, cpu, cuda
    mixed_precision: bool = True

    # --- Extensions of the JAX package (not present in the reference) ---
    # Encoder scale preset: 'base' builds the full pretrained-size backbones
    # (DeBERTa-v3-base / wav2vec2-base / ViT-B16); 'tiny' builds small
    # same-interface stand-ins for fast tests.
    encoder_preset: str = "base"
    # Compute dtype under mixed precision on a GPU. Params stay f32.
    compute_dtype: str = "bfloat16"
    # The fields below are kept so configs round-trip with the JAX package;
    # the serving port does not read them yet.
    mesh_shape: Tuple[int, int] = (1, 1)
    remat_encoders: object = "auto"
    flash_attention: object = "auto"
    flash_attention_train: object = "auto"
    video_wire_format: str = "yuv420"
    device_data_cache_mb: int = 2048
    spm_model_path: Optional[str] = None

    def __post_init__(self):
        if self.emotion_labels is None:
            self.emotion_labels = [
                "happy", "sad", "angry", "fear", "surprise", "disgust", "neutral"
            ]
        if isinstance(self.video_frame_size, list):
            self.video_frame_size = tuple(self.video_frame_size)
        if isinstance(self.mesh_shape, list):
            self.mesh_shape = tuple(self.mesh_shape)
        # Create directories (reference behavior, config.py:76-79)
        for p in (self.data_path, self.save_path, self.log_path):
            os.makedirs(p, exist_ok=True)


def config_to_dict(cfg) -> Dict:
    """Serialize a config (dataclass or plain object) to a JSON-able dict.

    Mirrors the reference's ``vars(config)`` dumps (train_advanced.py:511-518),
    including any fields attached after construction (e.g. ``fusion_type``).
    """
    d = dict(vars(cfg))
    out = {}
    for k, v in d.items():
        if isinstance(v, tuple):
            v = list(v)
        out[k] = v
    return out


def config_from_dict(cls, d: Dict):
    """Rebuild a config dataclass from a dict, keeping unknown keys as attrs."""
    known = {f.name for f in dataclasses.fields(cls)}
    kwargs = {k: v for k, v in d.items() if k in known}
    cfg = cls(**kwargs)
    for k, v in d.items():
        if k not in known:
            setattr(cfg, k, v)
    return cfg


def save_config_json(path: str, **configs) -> None:
    """Dump ``{name: vars(config)}`` JSON (reference train_advanced.py:511-518)."""
    payload = {name: config_to_dict(cfg) for name, cfg in configs.items()}
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)


def load_config_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)
