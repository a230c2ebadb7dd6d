"""Model assembly (port of simple_multimodal_tpu/models/multimodal_model.py):
three encoders → [modality dropout] → fusion → classifier and auxiliary
heads.

Every module keeps f32 parameters and computes in the ``dtype`` it is given
(weights cast at use, no autocast), so each kernel wrapper sees bf16
exactly where the JAX kernel did. The video wire format is decoded before
any modality zeroing: a zeroed packed yuv420 plane would decode to green.

Train mode is ``nn.Module.train()`` (no ``deterministic`` argument): the
forward then takes a ``torch.Generator`` on the model's device, from which
every dropout mask, kernel dropout seed, SpecAugment span and the modality
dropout are drawn. Only the ``standard`` family with the five fusion types
the hierarchical model runs is ported; ``late`` fusion and the
KD/few-shot/robust families are not ported yet.
"""
import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from ..data.video_wire import decode_video_wire
from ..ops.attention import dropout, linear, require_device, resolve_dtype
from .encoders import AudioEncoder, TextEncoder, VideoEncoder
from .fusion import (AdaptiveFusion, ContrastiveFusion, EarlyFusion, GraphFusion,
                     HierarchicalFusion, MultimodalTransformer)

FUSIONS = {
    "early": EarlyFusion,
    "mult": MultimodalTransformer,
    "graph": GraphFusion,
    "contrastive": ContrastiveFusion,
    "adaptive": AdaptiveFusion,
    "hierarchical": HierarchicalFusion,
}


class EmotionClassifier(nn.Module):
    """Main MLP head; the hierarchical sentiment heads are kept as
    parameters (checkpoint parity) but, as in the reference, do not feed
    the logits."""

    def __init__(self, config):
        super().__init__()
        Fh = config.fusion_hidden_size
        self.classifier = nn.Sequential(nn.Linear(Fh, Fh // 2), nn.ReLU(),
                                        nn.Dropout(config.fusion_dropout),
                                        nn.Linear(Fh // 2, config.num_emotions))
        self.sentiment_classifier = nn.Linear(Fh, 3)
        self.positive_classifier = nn.Linear(Fh, 2)
        self.negative_classifier = nn.Linear(Fh, 4)

    def forward(self, features, dtype, gen=None):
        h = torch.relu(linear(features, self.classifier[0], dtype))
        h = dropout(h, self.classifier[2].p, gen, self.training)
        return linear(h, self.classifier[3], dtype)


def modality_dropout(text, audio, video, rate: float, gen: torch.Generator):
    """Per-sample Bernoulli drop of each modality's features, at least one
    surviving: rows where all three dropped revive one uniformly at random
    (the JAX ``ops/adapters.modality_dropout``)."""
    B, dev = text.shape[0], text.device
    keep = torch.rand((B, 3), generator=gen, device=dev) > rate
    revive = torch.nn.functional.one_hot(
        torch.randint(0, 3, (B,), generator=gen, device=dev), 3).bool()
    keep = torch.where(keep.any(dim=1, keepdim=True), keep, revive)
    mask = keep.to(text.dtype)
    return text * mask[:, 0:1], audio * mask[:, 1:2], video * mask[:, 2:3]


class MultimodalEmotionModel(nn.Module):
    """Three encoders → fusion → heads, with the reference's output keys."""

    def __init__(self, config, dtype: torch.dtype = torch.float32):
        super().__init__()
        fusion_type = getattr(config, "fusion_type", "hierarchical")
        if fusion_type not in FUSIONS:
            raise NotImplementedError(f"fusion type {fusion_type!r} is not ported yet")
        Fh = config.fusion_hidden_size
        self.config = config
        self.fusion_type = fusion_type
        self.dtype = dtype
        self.text_encoder = TextEncoder(config)
        self.audio_encoder = AudioEncoder(config)
        self.video_encoder = VideoEncoder(config)
        self.fusion_layer = FUSIONS[fusion_type](config)
        self.classifier = EmotionClassifier(config)
        self.valence_regressor = nn.Linear(Fh, 1)
        self.arousal_regressor = nn.Linear(Fh, 1)
        self.uncertainty_head = nn.Linear(Fh, config.num_emotions)

    def forward(self, text_input: Dict[str, torch.Tensor], audio_input: torch.Tensor,
                video_input: torch.Tensor, use_adapter: bool = False,
                use_prompt: bool = False, compute_contrastive_loss: bool = False,
                missing_modalities: Optional[Sequence[str]] = None,
                gen: Optional[torch.Generator] = None) -> Dict:
        """text_input {input_ids, attention_mask} [B, S]; audio [B, T] float
        or int16; video [B, T, H, W, 3] uint8/float or packed yuv420.
        ``gen``: the generator of every random draw in train mode."""
        dt = self.dtype
        input_ids = text_input["input_ids"]
        attention_mask = text_input["attention_mask"]
        video_input = decode_video_wire(video_input, dt)
        if missing_modalities:
            if "text" in missing_modalities:
                input_ids = torch.zeros_like(input_ids)
                attention_mask = torch.zeros_like(attention_mask)
            if "audio" in missing_modalities:
                audio_input = torch.zeros_like(audio_input)
            if "video" in missing_modalities:
                video_input = torch.zeros_like(video_input)

        text = self.text_encoder(input_ids, attention_mask, dt, use_adapter,
                                 use_prompt, gen)["features"]
        audio = self.audio_encoder(audio_input, dt, use_adapter, gen)["features"]
        video = self.video_encoder(video_input, dt, use_adapter, gen)["features"]
        if self.training:
            text, audio, video = modality_dropout(text, audio, video, 0.1, gen)

        if self.fusion_type == "hierarchical" or self.fusion_type == "contrastive":
            fusion_output = self.fusion_layer(text, audio, video, dt, compute_contrastive_loss,
                                              gen)
        else:
            fusion_output = self.fusion_layer(text, audio, video, dt, gen)
        fused = (fusion_output["fused_features"] if isinstance(fusion_output, dict)
                 else fusion_output)
        logits = self.classifier(fused, dt, gen)
        output = {
            "emotion_logits": logits,
            # both softmaxes in the compute dtype, as the JAX model's
            "emotion_probs": torch.softmax(logits, dim=-1),
            "valence": linear(fused, self.valence_regressor, dt),
            "arousal": linear(fused, self.arousal_regressor, dt),
            "uncertainty": torch.softmax(linear(fused, self.uncertainty_head, dt), dim=-1),
            "text_features": text,
            "audio_features": audio,
            "video_features": video,
        }
        if isinstance(fusion_output, dict):
            for key, value in fusion_output.items():
                if key != "fused_features":
                    output[key] = value
        return output


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Deterministic random init from ``generator``, following the JAX
    package's initialisers: Linear/conv weights lecun-normal and biases 0,
    LayerNorm/GroupNorm 1 and 0, embeddings, positions and rel embeddings
    N(0, 0.02), LSTM U(±1/√H), GAT attention glorot-uniform,
    masked_spec_embed U[0, 1), positional-conv direction N(0, 0.02) with
    scale 1."""
    from .fusion import DenseGATLayer
    from .wav2vec2 import PositionalConvEmbedding

    def normal_(t, std):
        with torch.no_grad():
            t.copy_(torch.randn(t.shape, generator=generator) * std)

    def uniform_(t, lo, hi):
        with torch.no_grad():
            t.copy_(torch.rand(t.shape, generator=generator) * (hi - lo) + lo)

    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            fan_in = mod.weight[0].numel()
            normal_(mod.weight, 1.0 / math.sqrt(fan_in))
            if mod.bias is not None:
                nn.init.zeros_(mod.bias)
        elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
            nn.init.ones_(mod.weight)
            nn.init.zeros_(mod.bias)
        elif isinstance(mod, nn.Embedding):
            normal_(mod.weight, 0.02)
        elif isinstance(mod, nn.LSTM):
            bound = 1.0 / math.sqrt(mod.hidden_size)
            for name, p in mod.named_parameters():
                if name.startswith("bias"):
                    nn.init.zeros_(p)
                else:
                    uniform_(p, -bound, bound)
        elif isinstance(mod, DenseGATLayer):
            bound = math.sqrt(6.0 / (mod.heads + mod.out_features))  # fans of [1, H, C]
            for p in (mod.att_src, mod.att_dst):
                uniform_(p, -bound, bound)
        elif isinstance(mod, PositionalConvEmbedding):
            normal_(mod.conv.weight_v, 0.02)
        elif hasattr(mod, "in_proj_weight"):  # MultiHeadAttention
            normal_(mod.in_proj_weight, 1.0 / math.sqrt(mod.in_proj_weight.shape[1]))
    for name, p in model.named_parameters():
        if name.endswith("position_embeddings"):
            normal_(p, 0.02)
        elif name.endswith("masked_spec_embed"):
            uniform_(p, 0.0, 1.0)
    return model


def create_model(config, model_type: str = "standard", device="cuda",
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None) -> MultimodalEmotionModel:
    """An eval-mode model on ``device`` (the card unless the caller passes
    ``device="cpu"``; raises without a CUDA device), initialised from
    ``generator`` (seed 0 if None). ``dtype`` defaults to ``resolve_dtype``."""
    if model_type != "standard":
        raise NotImplementedError(f"model family {model_type!r} is not ported yet")
    device = require_device(device, "create_model")
    if dtype is None:
        dtype = resolve_dtype(config, device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = MultimodalEmotionModel(config, dtype=dtype)
    init_weights(model, generator)
    return model.to(device).eval()
