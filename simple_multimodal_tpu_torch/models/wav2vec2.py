"""Wav2Vec2 audio backbone (port of simple_multimodal_tpu/models/wav2vec2.py).

facebook/wav2vec2-base-960h's architecture with HF state-dict names: a
7-layer strided conv feature extractor (per-channel GroupNorm on the first
layer only), feature projection, a grouped positional conv with weight
norm, and post-LN transformer layers whose attention and FFN run through
the ``attention_block`` (no LN, no residual) and ``ffn_block`` (post-LN)
kernels. 160 000 samples → 499 frames. Waveforms are [B, T]; the feature
encoder returns NWC [B, T', C] frames, the JAX layout.

In training mode the JAX model's dropouts run (feature projection,
encoder, attention output, and inside the kernels the attention
probabilities and the FFN's intermediate and output, all at 0.1), and
SpecAugment time masking replaces masked frames by ``masked_spec_embed``.
Every mask is drawn from the generator the caller passes.
"""
import dataclasses
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import dropout, fused_weights, gelu, kernel_seed, layer_norm, linear
from ..ops.hopper.attention_block import attention_block
from ..ops.hopper.ffn_block import ffn_block
from ._util import Group


@dataclasses.dataclass(frozen=True)
class Wav2Vec2Config:
    conv_dims: Tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512)
    conv_kernels: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_strides: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    pos_conv_kernel: int = 128
    pos_conv_groups: int = 16
    layer_norm_eps: float = 1e-5
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    feat_proj_dropout: float = 0.1
    mask_time_prob: float = 0.05
    mask_time_length: int = 10

    @staticmethod
    def base() -> "Wav2Vec2Config":
        return Wav2Vec2Config()

    @staticmethod
    def tiny() -> "Wav2Vec2Config":
        # the full 320x stride stack: a 10-second clip still gives ~499 frames
        return Wav2Vec2Config(conv_dims=(16,) * 7, hidden_size=32, num_layers=2,
                              num_heads=2, intermediate_size=64,
                              pos_conv_kernel=8, pos_conv_groups=2)

    def num_frames(self, num_samples: int) -> int:
        n = num_samples
        for k, s in zip(self.conv_kernels, self.conv_strides):
            n = (n - k) // s + 1
        return n


class FeatureEncoder(nn.Module):
    """Raw waveform [B, T] → frames [B, T', C]."""

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.cfg = cfg
        layers = []
        in_dim = 1
        for i, (dim, k, s) in enumerate(zip(cfg.conv_dims, cfg.conv_kernels, cfg.conv_strides)):
            members = {"conv": nn.Conv1d(in_dim, dim, k, stride=s, bias=False)}
            if i == 0:  # GroupNorm(C, C): per-channel normalisation over time
                members["layer_norm"] = nn.GroupNorm(dim, dim, eps=1e-5)
            layers.append(Group(**members))
            in_dim = dim
        self.conv_layers = nn.ModuleList(layers)

    def forward(self, waveform: torch.Tensor, dtype) -> torch.Tensor:
        x = waveform.to(dtype)[:, None, :]  # NCW inside, NWC at the boundary
        for i, layer in enumerate(self.conv_layers):
            x = F.conv1d(x, layer.conv.weight.to(dtype), stride=layer.conv.stride)
            if i == 0:
                gn = layer.layer_norm
                x = F.group_norm(x.float(), gn.num_groups, gn.weight.float(),
                                 gn.bias.float(), gn.eps).to(dtype)
            x = gelu(x, dtype)
        return x.transpose(1, 2)


class PositionalConvEmbedding(nn.Module):
    """Grouped conv with weight norm (torch ``weight_norm(dim=2)``: one
    scale per kernel position, the direction normed over (out, in))."""

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        E, K, G = cfg.hidden_size, cfg.pos_conv_kernel, cfg.pos_conv_groups
        self.cfg = cfg
        self.conv = Group(weight_g=nn.Parameter(torch.ones(1, 1, K)),
                          weight_v=nn.Parameter(torch.empty(E, E // G, K)),
                          bias=nn.Parameter(torch.zeros(E)))

    def forward(self, hidden: torch.Tensor, dtype) -> torch.Tensor:
        K, G = self.cfg.pos_conv_kernel, self.cfg.pos_conv_groups
        v = self.conv.weight_v.float()
        norm = v.pow(2).sum(dim=(0, 1), keepdim=True).sqrt()
        w = (self.conv.weight_g * v / norm.clamp_min(1e-12)).to(dtype)
        out = F.conv1d(hidden.to(dtype).transpose(1, 2), w, self.conv.bias.to(dtype),
                       padding=K // 2, groups=G)
        if K % 2 == 0:  # SamePad: drop the trailing extra frame
            out = out[..., :-1]
        return gelu(out, dtype).transpose(1, 2)


class Wav2Vec2EncoderLayer(nn.Module):
    """Post-LN layer (do_stable_layer_norm=False)."""

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        E, Fd, eps = cfg.hidden_size, cfg.intermediate_size, cfg.layer_norm_eps
        self.cfg = cfg
        self.attention = Group(q_proj=nn.Linear(E, E), k_proj=nn.Linear(E, E),
                               v_proj=nn.Linear(E, E), out_proj=nn.Linear(E, E))
        self.layer_norm = nn.LayerNorm(E, eps=eps)
        self.feed_forward = Group(intermediate_dense=nn.Linear(E, Fd),
                                  output_dense=nn.Linear(Fd, E))
        self.final_layer_norm = nn.LayerNorm(E, eps=eps)

    def forward(self, hidden: torch.Tensor, dtype, gen=None) -> torch.Tensor:
        cfg, a = self.cfg, self.attention
        train, dev = self.training, hidden.device
        rate, seed = kernel_seed(gen, cfg.attention_dropout, train, dev)
        attn = attention_block(hidden, *fused_weights(
            (a.q_proj, a.k_proj, a.v_proj, a.out_proj), dtype), num_heads=cfg.num_heads,
            dropout_rate=rate, dropout_seed=seed)
        attn = dropout(attn, cfg.hidden_dropout, gen, train)
        hidden = layer_norm(hidden + attn, self.layer_norm, dtype)
        ff = self.feed_forward
        w1, b1, w2, b2 = fused_weights((ff.intermediate_dense, ff.output_dense), dtype)
        ln = self.final_layer_norm
        rate, seed = kernel_seed(gen, cfg.hidden_dropout, train, dev)
        return ffn_block(hidden, w1, b1, w2, b2,
                         ln=(ln.weight.to(dtype), ln.bias.to(dtype), ln.eps),
                         ln_post=True, residual=True, dropout_rate_mid=rate,
                         dropout_rate_out=rate, dropout_seed=seed)


def spec_augment_mask(B: int, S: int, prob: float, length: int,
                      gen: torch.Generator, device) -> torch.Tensor:
    """SpecAugment time mask [B, S] (bool): every frame starts a span of
    ``length`` frames with probability ``prob``, spans cut at S (the JAX
    model's convolution of the starts with a ones window, 'full', first S)."""
    starts = (torch.rand((B, S), generator=gen, device=device) < prob).to(torch.int32)
    run = starts.cumsum(dim=1)
    before = torch.nn.functional.pad(run, (length, 0))[:, :S]  # starts up to t - length
    return run - before > 0


class Wav2Vec2Model(nn.Module):
    """Raw waveform [B, T] → hidden frames [B, T', E]."""

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        E, C = cfg.hidden_size, cfg.conv_dims[-1]
        self.cfg = cfg
        self.feature_extractor = FeatureEncoder(cfg)
        self.feature_projection = Group(layer_norm=nn.LayerNorm(C, eps=cfg.layer_norm_eps),
                                        projection=nn.Linear(C, E))
        self.encoder = Group(
            pos_conv_embed=PositionalConvEmbedding(cfg),
            layer_norm=nn.LayerNorm(E, eps=cfg.layer_norm_eps),
            layers=nn.ModuleList(Wav2Vec2EncoderLayer(cfg) for _ in range(cfg.num_layers)))
        self.masked_spec_embed = nn.Parameter(torch.empty(E))

    def forward(self, waveform: torch.Tensor, dtype=torch.float32, gen=None) -> torch.Tensor:
        cfg, train = self.cfg, self.training
        feats = self.feature_extractor(waveform, dtype)
        fp = self.feature_projection
        x = linear(layer_norm(feats, fp.layer_norm, dtype), fp.projection, dtype)
        x = dropout(x, cfg.feat_proj_dropout, gen, train)
        if train and cfg.mask_time_prob > 0:
            if gen is None:
                raise ValueError("SpecAugment in training mode needs a torch.Generator")
            B, S, _ = x.shape
            masked = spec_augment_mask(B, S, cfg.mask_time_prob, cfg.mask_time_length, gen,
                                       x.device)
            x = torch.where(masked[..., None], self.masked_spec_embed.to(x.dtype), x)
        x = layer_norm(x + self.encoder.pos_conv_embed(x, dtype), self.encoder.layer_norm, dtype)
        x = dropout(x, cfg.hidden_dropout, gen, train)
        for layer in self.encoder.layers:
            x = layer(x, dtype, gen)
        return x
