"""Model assembly (port of simple_multimodal_tpu/models/multimodal_model.py):
three encoders → [modality dropout] → fusion → classifier and auxiliary
heads, and the three model families built around it (knowledge
distillation, prototypical few-shot, robust to missing modalities).

Every module keeps f32 parameters and computes in the ``dtype`` it is given
(weights cast at use, no autocast), so each kernel wrapper sees bf16
exactly where the JAX kernel did. The video wire format is decoded before
any modality zeroing: a zeroed packed yuv420 plane would decode to green.

Train mode is ``nn.Module.train()`` (no ``deterministic`` argument): the
forward then takes a ``torch.Generator`` on the model's device, from which
every dropout mask, kernel dropout seed, SpecAugment span and the modality
dropout are drawn.

All seven fusion types are ported. ``late`` fusion has no ``classifier``
(its logits are the fused per-modality logits) and feeds the auxiliary
heads the mean of the three features, as in the JAX model.

While a profiler records, ``MultimodalEmotionModel.forward`` opens a span
around each encoder (``smm.encode.text``, ``.audio``, ``.video``) and one
around the rest (``smm.fuse``: modality dropout, fusion, classifier and
heads), through ``utils/profiling.py``'s ``annotate``.
"""
import functools
import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from ..data.video_wire import decode_video_wire
from ..ops.adapters import AdapterLayer
from ..ops.attention import dropout, linear, require_device, resolve_dtype
from ..parallel.mesh import draw_rows
from ..utils.profiling import annotate
from .encoders import AudioEncoder, TextEncoder, VideoEncoder
from .fusion import (AdaptiveFusion, ContrastiveFusion, EarlyFusion, GraphFusion,
                     HierarchicalFusion, LateFusion, MultimodalTransformer)

FUSIONS = {
    "early": EarlyFusion,
    "late": LateFusion,
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
    keep = draw_rows(torch.rand, (B, 3), generator=gen, device=dev) > rate
    revive = torch.nn.functional.one_hot(
        draw_rows(functools.partial(torch.randint, 0, 3), (B,), generator=gen, device=dev),
        3).bool()
    keep = torch.where(keep.any(dim=1, keepdim=True), keep, revive)
    mask = keep.to(text.dtype)
    return text * mask[:, 0:1], audio * mask[:, 1:2], video * mask[:, 2:3]


class MultimodalEmotionModel(nn.Module):
    """Three encoders → fusion → heads, with the reference's output keys.
    ``use_adapter`` / ``use_prompt`` build the encoders' adapters and the
    text prompt (the few-shot family's), which every forward then runs."""

    def __init__(self, config, dtype: torch.dtype = torch.float32,
                 use_adapter: bool = False, use_prompt: bool = False):
        super().__init__()
        fusion_type = getattr(config, "fusion_type", "hierarchical")
        if fusion_type not in FUSIONS:
            raise ValueError(f"Unknown fusion type: {fusion_type}")
        Fh = config.fusion_hidden_size
        self.config = config
        self.fusion_type = fusion_type
        self.dtype = dtype
        self.text_encoder = TextEncoder(config, adapter=use_adapter, prompt=use_prompt)
        self.audio_encoder = AudioEncoder(config, adapter=use_adapter)
        self.video_encoder = VideoEncoder(config, adapter=use_adapter)
        self.fusion_layer = FUSIONS[fusion_type](config)
        # late fusion's logits are its own: no classifier, as in JAX
        self.classifier = None if fusion_type == "late" else EmotionClassifier(config)
        self.valence_regressor = nn.Linear(Fh, 1)
        self.arousal_regressor = nn.Linear(Fh, 1)
        self.uncertainty_head = nn.Linear(Fh, config.num_emotions)

    def forward(self, text_input: Dict[str, torch.Tensor], audio_input: torch.Tensor,
                video_input: torch.Tensor, compute_contrastive_loss: bool = False,
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

        with annotate("smm.encode.text"):
            text = self.text_encoder(input_ids, attention_mask, dt, gen)["features"]
        with annotate("smm.encode.audio"):
            audio = self.audio_encoder(audio_input, dt, gen)["features"]
        with annotate("smm.encode.video"):
            video = self.video_encoder(video_input, dt, gen)["features"]
        with annotate("smm.fuse"):
            return self._fuse(text, audio, video, dt, compute_contrastive_loss, gen)

    def _fuse(self, text, audio, video, dt, compute_contrastive_loss, gen) -> Dict:
        """Modality dropout, the fusion layer, the classifier and the
        auxiliary heads over the three encoders' features."""
        if self.training:
            text, audio, video = modality_dropout(text, audio, video, 0.1, gen)

        if self.fusion_type == "hierarchical" or self.fusion_type == "contrastive":
            fusion_output = self.fusion_layer(text, audio, video, dt, compute_contrastive_loss,
                                              gen)
        else:
            fusion_output = self.fusion_layer(text, audio, video, dt, gen)
        if self.fusion_type == "late":
            logits = fusion_output["fused_logits"]
            aux_in = (text + audio + video) / 3.0
        else:
            aux_in = (fusion_output["fused_features"] if isinstance(fusion_output, dict)
                      else fusion_output)
            logits = self.classifier(aux_in, dt, gen)
        output = {
            "emotion_logits": logits,
            # both softmaxes in the logits' dtype, as the JAX model's
            "emotion_probs": torch.softmax(logits, dim=-1),
            "valence": linear(aux_in, self.valence_regressor, dt),
            "arousal": linear(aux_in, self.arousal_regressor, dt),
            "uncertainty": torch.softmax(linear(aux_in, self.uncertainty_head, dt), dim=-1),
            "text_features": text,
            "audio_features": audio,
            "video_features": video,
        }
        if self.fusion_type == "late":
            output["individual_logits"] = {m: fusion_output[f"{m}_logits"]
                                           for m in ("text", "audio", "video")}
            output["fusion_weights"] = fusion_output["fusion_weights"]
        if isinstance(fusion_output, dict):
            for key, value in fusion_output.items():
                if key != "fused_features":
                    output[key] = value
        return output


class KnowledgeDistillationModel(nn.Module):
    """A student trained against a frozen teacher's softened logits (JAX
    ``KnowledgeDistillationModel``). The teacher runs in eval mode under
    ``torch.no_grad()`` whatever ``train()`` set, and its parameters are
    frozen (``requires_grad`` off, JAX's ``freeze_mask``), so no optimizer
    takes them. Outputs are the student's, plus ``distillation_loss`` (KL(teacher ‖ student) at
    ``distill_temperature`` T, batch mean, times T²) and ``teacher_logits``."""

    def __init__(self, teacher_config, student_config, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.student = MultimodalEmotionModel(student_config, dtype)
        self.teacher = MultimodalEmotionModel(teacher_config, dtype)
        self.teacher.requires_grad_(False)

    def train(self, mode: bool = True):
        super().train(mode)
        self.teacher.eval()
        return self

    def forward(self, text_input, audio_input, video_input, gen=None, **kwargs) -> Dict:
        out = self.student(text_input, audio_input, video_input, gen=gen, **kwargs)
        with torch.no_grad():
            teacher_logits = self.teacher(text_input, audio_input, video_input)["emotion_logits"]
        T = self.student.config.distill_temperature
        soft_targets = torch.softmax(teacher_logits / T, dim=-1)
        soft_student = torch.log_softmax(out["emotion_logits"] / T, dim=-1)
        kl = soft_targets * (torch.log(soft_targets.clamp_min(1e-10)) - soft_student)
        out["distillation_loss"] = kl.sum(dim=-1).mean() * (T ** 2)
        out["teacher_logits"] = teacher_logits
        return out


class FewShotModel(nn.Module):
    """Prototypical network over the summed modality features of one base
    model run with its adapters and prompt (JAX ``FewShotModel``): the
    support's per-class mean through ``prototype_network``, f32 Euclidean
    distances of each query to each prototype, and ``softmax(−d)``. The
    support is [n_way · n_shot] clips ordered by class."""

    def __init__(self, config, dtype: torch.dtype = torch.float32):
        super().__init__()
        Fh = config.fusion_hidden_size
        self.config = config
        self.dtype = dtype
        self.base_model = MultimodalEmotionModel(config, dtype, use_adapter=True, use_prompt=True)
        self.prototype_network = nn.Sequential(nn.Linear(Fh, Fh), nn.ReLU(), nn.Linear(Fh, Fh))

    def _features(self, data: Dict, gen):
        out = self.base_model(data["text"], data["audio"], data["video"], gen=gen)
        return out["text_features"] + out["audio_features"] + out["video_features"]

    def forward(self, support_data: Dict, query_data: Dict, n_way: int, n_shot: int,
                gen: Optional[torch.Generator] = None) -> Dict:
        dt = self.dtype
        support = self._features(support_data, gen)
        query = self._features(query_data, gen)
        protos = support.reshape(n_way, n_shot, -1).mean(dim=1)
        h = torch.relu(linear(protos, self.prototype_network[0], dt))
        prototypes = linear(h, self.prototype_network[2], dt)
        diffs = query[:, None, :] - prototypes[None, :, :]
        distances = torch.sqrt((diffs.float() ** 2).sum(dim=-1).clamp_min(1e-12))
        return {"predictions": torch.softmax(-distances, dim=-1), "distances": distances,
                "prototypes": prototypes, "support_features": support,
                "query_features": query}


class RobustMultimodalModel(nn.Module):
    """The base model plus one backup classifier per modality, mixed by a
    predicted availability (sigmoid of ``modality_predictor``) or, with
    ``available_modalities``, by the given ones (JAX
    ``RobustMultimodalModel``); the weights are normalised by their sum
    + 1e-8. ``missing_modalities`` zeroes inputs as the base model does."""

    MODALITIES = ("text", "audio", "video")

    def __init__(self, config, dtype: torch.dtype = torch.float32):
        super().__init__()
        Fh, n = config.fusion_hidden_size, config.num_emotions
        self.config = config
        self.dtype = dtype
        self.base_model = MultimodalEmotionModel(config, dtype)
        self.modality_predictor = nn.Sequential(nn.Linear(3 * Fh, Fh), nn.ReLU(),
                                                nn.Linear(Fh, 3))
        self.text_only_classifier = nn.Linear(Fh, n)
        self.audio_only_classifier = nn.Linear(Fh, n)
        self.video_only_classifier = nn.Linear(Fh, n)

    def forward(self, text_input, audio_input, video_input,
                available_modalities: Optional[Sequence[str]] = None,
                missing_modalities: Optional[Sequence[str]] = None,
                compute_contrastive_loss: bool = False,
                gen: Optional[torch.Generator] = None) -> Dict:
        dt = self.dtype
        output = self.base_model(text_input, audio_input, video_input,
                                 compute_contrastive_loss=compute_contrastive_loss,
                                 missing_modalities=missing_modalities, gen=gen)
        feats = [output[f"{m}_features"] for m in self.MODALITIES]
        h = torch.relu(linear(torch.cat(feats, dim=-1), self.modality_predictor[0], dt))
        availability = torch.sigmoid(linear(h, self.modality_predictor[2], dt))
        preds = [linear(x, getattr(self, f"{m}_only_classifier"), dt)
                 for x, m in zip(feats, self.MODALITIES)]
        if available_modalities is None:
            weights = availability
        else:
            given = torch.tensor([float(m in available_modalities) for m in self.MODALITIES],
                                 dtype=availability.dtype, device=availability.device)
            weights = given.expand_as(availability)
        weights = weights / (weights.sum(dim=1, keepdim=True) + 1e-8)
        output.update({
            "robust_prediction": (weights[:, 0:1] * preds[0] + weights[:, 1:2] * preds[1]
                                  + weights[:, 2:3] * preds[2]),
            "modality_availability": availability,
            "individual_predictions": dict(zip(self.MODALITIES, preds)),
            "modality_weights": weights,
        })
        return output


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Deterministic random init from ``generator``, following the JAX
    package's initialisers: Linear/conv weights lecun-normal and biases 0
    (adapter kernels N(0, 0.02)), LayerNorm/GroupNorm 1 and 0, embeddings,
    positions and rel embeddings N(0, 0.02), prompt embeddings N(0, 1), LSTM
    U(±1/√H), GAT attention glorot-uniform, masked_spec_embed U[0, 1),
    positional-conv direction N(0, 0.02) with scale 1; late fusion's weights
    keep their 1/3."""
    from .fusion import DenseGATLayer
    from .wav2vec2 import PositionalConvEmbedding

    def normal_(t, std):
        with torch.no_grad():
            t.copy_(torch.randn(t.shape, generator=generator) * std)

    def uniform_(t, lo, hi):
        with torch.no_grad():
            t.copy_(torch.rand(t.shape, generator=generator) * (hi - lo) + lo)

    adapter_linears = {id(lin) for mod in model.modules() if isinstance(mod, AdapterLayer)
                       for lin in (mod.down_project, mod.up_project)}
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            fan_in = mod.weight[0].numel()
            std = 0.02 if id(mod) in adapter_linears else 1.0 / math.sqrt(fan_in)
            normal_(mod.weight, std)
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
        elif name.endswith("prompt_embeddings"):
            normal_(p, 1.0)
    return model


def create_model(config, model_type: str = "standard", device="cuda",
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None,
                 student_config=None) -> nn.Module:
    """An eval-mode model of the family ``model_type`` ('standard',
    'few_shot', 'robust' or 'distillation', the last with ``config`` as the
    teacher's and ``student_config`` as the student's, by default ``config``
    again as in the JAX factory) on ``device`` (the card unless the caller
    passes ``device="cpu"``; raises without a CUDA device), initialised from
    ``generator`` (seed 0 if None). ``dtype`` defaults to ``resolve_dtype``."""
    families = {
        "standard": lambda dt: MultimodalEmotionModel(config, dtype=dt),
        "few_shot": lambda dt: FewShotModel(config, dtype=dt),
        "robust": lambda dt: RobustMultimodalModel(config, dtype=dt),
        "distillation": lambda dt: KnowledgeDistillationModel(
            config, student_config or config, dtype=dt),
    }
    if model_type not in families:
        raise ValueError(f"Unknown model type: {model_type}")
    device = require_device(device, "create_model")
    if dtype is None:
        dtype = resolve_dtype(config, device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = init_weights(families[model_type](dtype), generator)
    return model.to(device).eval()



def load_pretrained_model(checkpoint_path: str, config=None, device="cuda",
                          dtype: Optional[torch.dtype] = None):
    """(model, config) from a port checkpoint directory
    (``train/checkpoint.save_checkpoint``): the standard model of the
    checkpoint's own config (or ``config``, which a ``save_params`` directory
    needs: it holds no config), its weights loaded, in eval
    mode on ``device`` (the card unless the caller passes ``device="cpu"``;
    raises without a CUDA device)."""
    import json

    from ..config import ModelConfig, config_from_dict
    from ..train.checkpoint import load_payload

    device = require_device(device, "load_pretrained_model")
    payload = load_payload(checkpoint_path)
    if config is None:
        if "config" not in payload:
            raise ValueError(f"{checkpoint_path} holds no config (a save_params directory): "
                             "pass the model's config")
        config = config_from_dict(ModelConfig, json.loads(payload["config"]))
    model = MultimodalEmotionModel(config, dtype=dtype or resolve_dtype(config, device))
    model.load_state_dict(payload["state_dict"])
    return model.to(device).eval(), config
