"""Configuration dataclasses for the PyTorch port.

A stdlib copy of simple_multimodal_tpu's ``ModelConfig``, ``DataConfig``
and ``ExperimentConfig`` (same fields, defaults and JSON round-trip), so
the port never imports the JAX package:
importing that package's config runs its ``__init__``, which imports jax
whenever ``JAX_PLATFORMS`` is set. Like the reference, constructing a
``ModelConfig`` creates its data/save/log directories; no instance is made
at import time here.

``ModelConfig.device_data_cache_mb`` is read by the port's trainer: a data
set that fits it is kept on the card (``data/pipeline.DeviceCachedLoader``).
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
    # The DeepSeek text tower's cut (text_model_name moonshotai/Moonlight-16B-A3B,
    # models/deepseek.py): the layers kept (0: the published 27), and this
    # process's share of each MoE layer's routed experts as (index, count):
    # the index-th of count equal blocks, as one of count expert-parallel ranks.
    text_num_layers: int = 0
    text_expert_share: Tuple[int, int] = (0, 1)

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
    # Mirrors the JAX config and round-trips through checkpoints; nothing in
    # the port reads it: create_model, load_pretrained_model and
    # MultimodalEmotionDemo take an explicit ``device`` argument ("cuda" by
    # default, "cpu" on request).
    device: str = "auto"  # auto, cpu, cuda
    mixed_precision: bool = True

    # --- Extensions of the JAX package (not present in the reference) ---
    # Encoder scale preset: 'base' builds the full pretrained-size backbones
    # (DeBERTa-v3-base / wav2vec2-base / ViT-B16); 'tiny' builds small
    # same-interface stand-ins for fast tests.
    encoder_preset: str = "base"
    # Compute dtype under mixed precision on a GPU. Params stay f32.
    compute_dtype: str = "bfloat16"
    # Kept so configs round-trip with the JAX package; the port reads none
    # of these four (its kernels are always on on the card).
    mesh_shape: Tuple[int, int] = (1, 1)
    remat_encoders: object = "auto"
    flash_attention: object = "auto"
    flash_attention_train: object = "auto"
    # The dataset's video wire format: packed yuv420 or rgb8 (data/dataset.py).
    video_wire_format: str = "yuv420"
    # A data set smaller than this stays on the card across epochs (the
    # trainer's DeviceCachedLoader); 0 disables.
    device_data_cache_mb: int = 2048
    # A sentencepiece unigram model file (data/tokenizer.get_tokenizer).
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
        if isinstance(self.text_expert_share, list):
            self.text_expert_share = tuple(self.text_expert_share)
        # Create directories (reference behavior, config.py:76-79)
        for p in (self.data_path, self.save_path, self.log_path):
            os.makedirs(p, exist_ok=True)


@dataclass
class DataConfig:
    """Data configuration parameters (reference: config.py:82-107)."""

    # Dataset selection
    primary_dataset: str = "sample"  # cmu_mosei, meld, iemocap...
    supplementary_datasets: List[str] = None

    # Data preprocessing
    normalize_audio: bool = True
    augment_data: bool = True
    balance_classes: bool = True

    # Cross-validation
    k_folds: int = 5
    test_split: float = 0.2
    val_split: float = 0.1

    # Data loading
    num_workers: int = 0
    pin_memory: bool = True

    # --- Extensions of the JAX package ---
    # Cache decoded audio/video as .npy sidecars next to the raw media.
    cache_decoded: bool = True
    # Number of batches to prefetch onto the device.
    prefetch_batches: int = 2

    def __post_init__(self):
        if self.supplementary_datasets is None:
            self.supplementary_datasets = ["meld"]


@dataclass
class ExperimentConfig:
    """Experiment configuration for research (reference: config.py:110-140)."""

    # Ablation studies
    enable_early_fusion: bool = True
    enable_late_fusion: bool = True
    enable_mult_fusion: bool = True
    enable_graph_fusion: bool = True
    enable_contrastive_learning: bool = True

    # Few-shot learning
    enable_prompt_tuning: bool = True
    enable_adapter_tuning: bool = True
    few_shot_samples: List[int] = None

    # Robustness testing
    test_missing_modalities: bool = True
    missing_modality_rates: List[float] = None

    # Knowledge distillation
    enable_knowledge_distillation: bool = True
    teacher_model_path: Optional[str] = None

    def __post_init__(self):
        if self.few_shot_samples is None:
            self.few_shot_samples = [1, 5, 10, 20, 50]
        if self.missing_modality_rates is None:
            self.missing_modality_rates = [0.1, 0.3, 0.5, 0.7]


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
