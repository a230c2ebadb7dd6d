"""Modality encoders (port of simple_multimodal_tpu/models/encoders.py):
text (DeBERTa), audio (wav2vec2 + temporal attention) and video (ViT CLS
per frame + biLSTM + facial attention), each projected into the fusion
space.

Behaviour kept from the reference: text pools the CLS token because 'bert'
is a substring of the backbone's model_type; audio arrives as int16 and is
dequantized on the device; video arrives in any wire format and is decoded
on the device. Adapters and prompt tuning are not ported yet.

In training mode each projection takes dropout at ``fusion_dropout``, as do
the temporal and facial attention probabilities and the output of the
biLSTM's first layer; the masks come from the caller's generator.
"""
import dataclasses
from typing import Dict

import torch
import torch.nn as nn

from ..data.video_wire import decode_video_wire
from ..ops.attention import MultiHeadAttention, dropout, linear
from ..ops.lstm import LSTM
from .deberta import DebertaConfig, DebertaModel
from .vit import ViTConfig, ViTModel
from .wav2vec2 import Wav2Vec2Config, Wav2Vec2Model

_NOT_PORTED = ("adapters and prompt tuning are not ported yet "
               "(ROADMAP Queue 1, 'Adapters and prompt tuning')")


def resolve_backbone_configs(config):
    """Backbone dimension presets from a ModelConfig: 'tiny' or 'base'."""
    preset = getattr(config, "encoder_preset", "base")
    if preset == "tiny":
        text = dataclasses.replace(DebertaConfig.tiny(), vocab_size=128100)
        audio = Wav2Vec2Config.tiny()
        vit = dataclasses.replace(ViTConfig.tiny(), image_size=config.video_frame_size[0])
    elif preset == "base":
        text = DebertaConfig.base()
        audio = Wav2Vec2Config.base()
        vit = dataclasses.replace(ViTConfig.base(), image_size=config.video_frame_size[0])
    else:
        raise NotImplementedError(f"encoder preset {preset!r} is not ported yet "
                                  "(the port has 'tiny' and 'base')")
    return text, audio, vit


def _check_unported(use_adapter: bool, use_prompt: bool = False):
    if use_adapter or use_prompt:
        raise NotImplementedError(_NOT_PORTED)


class TextEncoder(nn.Module):
    def __init__(self, config):
        super().__init__()
        text_cfg, _, _ = resolve_backbone_configs(config)
        self.text_cfg = text_cfg
        self.model = DebertaModel(text_cfg)
        self.projection = nn.Linear(text_cfg.hidden_size, config.fusion_hidden_size)
        self.drop = config.fusion_dropout

    def forward(self, input_ids, attention_mask, dtype=torch.float32,
                use_adapter: bool = False, use_prompt: bool = False,
                gen=None) -> Dict[str, torch.Tensor]:
        _check_unported(use_adapter, use_prompt)
        seq = self.model(input_ids, attention_mask, dtype, gen)
        if "bert" in self.text_cfg.model_type:  # reference substring rule
            pooled = seq[:, 0]
        else:
            mask = attention_mask[..., None].to(seq.dtype)
            pooled = (seq * mask).sum(1) / mask.sum(1).clamp_min(1e-9)
        features = dropout(linear(pooled, self.projection, dtype), self.drop, gen, self.training)
        return {"features": features, "sequence_output": seq, "attention_mask": attention_mask}


class AudioEncoder(nn.Module):
    def __init__(self, config):
        super().__init__()
        _, audio_cfg, _ = resolve_backbone_configs(config)
        self.model = Wav2Vec2Model(audio_cfg)
        # the temporal attention's weights are never read downstream
        self.temporal_attention = MultiHeadAttention(audio_cfg.hidden_size, 8,
                                                     config.fusion_dropout)
        self.projection = nn.Linear(audio_cfg.hidden_size, config.fusion_hidden_size)
        self.drop = config.fusion_dropout

    def forward(self, waveform, dtype=torch.float32, use_adapter: bool = False,
                gen=None) -> Dict[str, torch.Tensor]:
        _check_unported(use_adapter)
        if waveform.dtype == torch.int16:  # the wire format: dequantize here
            waveform = waveform.to(dtype) / 32768.0
        seq = self.model(waveform, dtype, gen)
        attended, weights = self.temporal_attention(seq, seq, seq, dtype, need_weights=False,
                                                    gen=gen)
        features = linear(attended.mean(dim=1), self.projection, dtype)
        return {"features": dropout(features, self.drop, gen, self.training),
                "sequence_output": attended, "attention_weights": weights}


class VideoEncoder(nn.Module):
    def __init__(self, config):
        super().__init__()
        _, _, vit_cfg = resolve_backbone_configs(config)
        E = vit_cfg.hidden_size
        self.vit = ViTModel(vit_cfg)
        self.temporal_lstm = LSTM(E, E // 2, num_layers=2, bidirectional=True,
                                  dropout=config.fusion_dropout)
        self.facial_attention = MultiHeadAttention(E, 8, config.fusion_dropout)
        self.projection = nn.Linear(E, config.fusion_hidden_size)
        self.drop = config.fusion_dropout

    def forward(self, video_frames, dtype=torch.float32, use_adapter: bool = False,
                gen=None) -> Dict[str, torch.Tensor]:
        """video_frames: [B, T, H, W, 3] uint8/float or packed yuv420."""
        _check_unported(use_adapter)
        frames = decode_video_wire(video_frames, dtype)
        B, T = frames.shape[:2]
        cls = self.vit(frames.reshape((B * T,) + frames.shape[2:]), dtype, cls_only=True,
                       gen=gen)
        lstm_out = self.temporal_lstm(cls.reshape(B, T, -1), gen)
        attended, weights = self.facial_attention(lstm_out, lstm_out, lstm_out, dtype,
                                                  need_weights=False, gen=gen)
        features = linear(attended.mean(dim=1), self.projection, dtype)
        return {"features": dropout(features, self.drop, gen, self.training),
                "sequence_output": attended, "attention_weights": weights}
