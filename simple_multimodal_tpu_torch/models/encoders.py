"""Modality encoders (port of simple_multimodal_tpu/models/encoders.py):
text (DeBERTa), audio (wav2vec2 + temporal attention) and video (ViT CLS
per frame + biLSTM + facial attention), each projected into the fusion
space.

The text backbone follows ``text_model_name``: moonshotai/Moonlight-16B-A3B
builds the DeepSeek-V3 decoder (``models/deepseek.py``; ``text_num_layers``
keeps its first layers, ``text_expert_share`` names the block of experts
this process holds), any other name DeBERTa, as before.

Behaviour kept from the reference: text pools the CLS token because 'bert'
is a substring of the backbone's model_type, and takes the mask-weighted
mean otherwise (the decoder's ``deepseek_v3``); audio arrives as int16 and is
dequantized on the device; video arrives in any wire format and is decoded
on the device.

Adapters and prompt tuning (the few-shot family's) are built only when the
encoder is constructed with ``adapter=True`` / ``prompt=True``, as the JAX
parameters exist only where a model was initialised with them; an encoder
built with them always runs them (JAX's forward flags ``use_adapter`` /
``use_prompt`` are what was built, one decision). The adapter sits
where the JAX package places it: after DeBERTa, after wav2vec2, and on the
ViT CLS features before the biLSTM. The prompt (``prompt_length`` rows of
the text width, N(0, 1) at init) goes ahead of the word embeddings and the
pooling mask gains as many ones.

In training mode each projection takes dropout at ``fusion_dropout``, as do
the temporal and facial attention probabilities and the output of the
biLSTM's first layer; the masks come from the caller's generator.
"""
import dataclasses
import os
from typing import Dict

import torch
import torch.nn as nn

from ..data.video_wire import decode_video_wire
from ..ops.adapters import AdapterLayer
from ..ops.attention import MultiHeadAttention, dropout, linear
from ..ops.lstm import LSTM
from .deberta import DebertaConfig, DebertaModel
from .deepseek import MOONLIGHT, DeepseekConfig, DeepseekModel
from .vit import ViTConfig, ViTModel
from .wav2vec2 import Wav2Vec2Config, Wav2Vec2Model

def resolve_backbone_configs(config):
    """Backbone dimension presets from a ModelConfig: 'tiny', 'half' (the
    distillation student's scale: width 384, 6 layers of 6 heads), else
    'base' (any other name resolves to 'base', as in the JAX package).
    ``SMM_WAV_FRONTEND=1`` in the environment turns on wav2vec2's fused
    front end (off by default), the JAX package's own switch."""
    preset = getattr(config, "encoder_preset", "base")
    if preset == "tiny":
        text = dataclasses.replace(DebertaConfig.tiny(), vocab_size=128100)
        audio = Wav2Vec2Config.tiny()
        vit = dataclasses.replace(ViTConfig.tiny(), image_size=config.video_frame_size[0])
    elif preset == "half":
        text = DebertaConfig.half()
        audio = Wav2Vec2Config.half()
        vit = dataclasses.replace(ViTConfig.half(), image_size=config.video_frame_size[0])
    else:
        text = DebertaConfig.base()
        audio = Wav2Vec2Config.base()
        vit = dataclasses.replace(ViTConfig.base(), image_size=config.video_frame_size[0])
    audio = dataclasses.replace(
        audio, fused_frontend=os.environ.get("SMM_WAV_FRONTEND", "0") == "1")
    return text, audio, vit


def text_backbone_config(config):
    """The text backbone's config: the DeepSeek decoder's for Moonlight (the
    ``tiny`` preset's with the hashing tokenizer's vocabulary, as DeBERTa's
    tiny), cut to ``text_num_layers`` (0: all) and ``text_expert_share``;
    otherwise the preset's DeBERTa."""
    if getattr(config, "text_model_name", None) != MOONLIGHT:
        return resolve_backbone_configs(config)[0]
    if getattr(config, "encoder_preset", "base") == "tiny":
        cfg = dataclasses.replace(DeepseekConfig.tiny(), vocab_size=128100)
    else:
        cfg = DeepseekConfig.moonlight()
    return dataclasses.replace(
        cfg, num_hidden_layers=getattr(config, "text_num_layers", 0) or cfg.num_hidden_layers,
        expert_share=tuple(getattr(config, "text_expert_share", (0, 1))))


class TextEncoder(nn.Module):
    def __init__(self, config, adapter: bool = False, prompt: bool = False):
        super().__init__()
        text_cfg = text_backbone_config(config)
        E = text_cfg.hidden_size
        self.text_cfg = text_cfg
        self.model = (DeepseekModel(text_cfg) if isinstance(text_cfg, DeepseekConfig)
                      else DebertaModel(text_cfg))
        self.prompt_embeddings = (nn.Parameter(torch.zeros(config.prompt_length, E))
                                  if prompt else None)
        self.adapter = AdapterLayer(E, config.adapter_size) if adapter else None
        self.projection = nn.Linear(E, config.fusion_hidden_size)
        self.drop = config.fusion_dropout

    def forward(self, input_ids, attention_mask, dtype=torch.float32,
                gen=None) -> Dict[str, torch.Tensor]:
        prompt = self.prompt_embeddings
        seq = self.model(input_ids, attention_mask, dtype, gen, prompt_embeds=prompt)
        if prompt is not None:  # the pooling mask covers the prompt rows too
            attention_mask = torch.cat(
                [attention_mask.new_ones((input_ids.shape[0], prompt.shape[0])),
                 attention_mask], dim=1)
        if self.adapter is not None:
            seq = self.adapter(seq, dtype, gen)
        if "bert" in self.text_cfg.model_type:  # reference substring rule
            pooled = seq[:, 0]
        else:
            # in f32: a bf16 count of more than 256 rows is rounded
            mask = attention_mask[..., None].float()
            pooled = ((seq.float() * mask).sum(1) / mask.sum(1).clamp_min(1e-9)).to(seq.dtype)
        features = dropout(linear(pooled, self.projection, dtype), self.drop, gen, self.training)
        return {"features": features, "sequence_output": seq, "attention_mask": attention_mask}


class AudioEncoder(nn.Module):
    def __init__(self, config, adapter: bool = False):
        super().__init__()
        _, audio_cfg, _ = resolve_backbone_configs(config)
        self.model = Wav2Vec2Model(audio_cfg)
        E = audio_cfg.hidden_size
        self.adapter = AdapterLayer(E, config.adapter_size) if adapter else None
        # the temporal attention's weights are never read downstream
        self.temporal_attention = MultiHeadAttention(E, 8, config.fusion_dropout)
        self.projection = nn.Linear(E, config.fusion_hidden_size)
        self.drop = config.fusion_dropout

    def forward(self, waveform, dtype=torch.float32,
                gen=None) -> Dict[str, torch.Tensor]:
        if waveform.dtype == torch.int16:  # the wire format: dequantize here
            waveform = waveform.to(dtype) / 32768.0
        seq = self.model(waveform, dtype, gen)
        if self.adapter is not None:
            seq = self.adapter(seq, dtype, gen)
        attended, weights = self.temporal_attention(seq, seq, seq, dtype, need_weights=False,
                                                    gen=gen)
        features = linear(attended.mean(dim=1), self.projection, dtype)
        return {"features": dropout(features, self.drop, gen, self.training),
                "sequence_output": attended, "attention_weights": weights}


class VideoEncoder(nn.Module):
    def __init__(self, config, adapter: bool = False):
        super().__init__()
        _, _, vit_cfg = resolve_backbone_configs(config)
        E = vit_cfg.hidden_size
        self.vit = ViTModel(vit_cfg)
        self.adapter = AdapterLayer(E, config.adapter_size) if adapter else None
        self.temporal_lstm = LSTM(E, E // 2, num_layers=2, bidirectional=True,
                                  dropout=config.fusion_dropout)
        self.facial_attention = MultiHeadAttention(E, 8, config.fusion_dropout)
        self.projection = nn.Linear(E, config.fusion_hidden_size)
        self.drop = config.fusion_dropout

    def forward(self, video_frames, dtype=torch.float32,
                gen=None) -> Dict[str, torch.Tensor]:
        """video_frames: [B, T, H, W, 3] uint8/float or packed yuv420."""
        frames = decode_video_wire(video_frames, dtype)
        B, T = frames.shape[:2]
        cls = self.vit(frames.reshape((B * T,) + frames.shape[2:]), dtype, cls_only=True,
                       gen=gen).reshape(B, T, -1)
        if self.adapter is not None:
            cls = self.adapter(cls, dtype, gen)
        lstm_out = self.temporal_lstm(cls, gen)
        attended, weights = self.facial_attention(lstm_out, lstm_out, lstm_out, dtype,
                                                  need_weights=False, gen=gen)
        features = linear(attended.mean(dim=1), self.projection, dtype)
        return {"features": dropout(features, self.drop, gen, self.training),
                "sequence_output": attended, "attention_weights": weights}
