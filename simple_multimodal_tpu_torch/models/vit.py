"""Vision Transformer frame backbone (port of simple_multimodal_tpu/models/vit.py).

google/vit-base-patch16-224's architecture with HF ViT state-dict names:
conv patch embedding, CLS token, learned positions, pre-LN layers, final
LayerNorm. Frames arrive channels-last [N, H, W, 3] (the JAX layout).

Layers 0..L-2 run as two fused kernels each: ``attention_block`` with the
pre-LN and residual fused, and ``ffn_block`` with the pre-LN. With
``cls_only`` the last layer computes only the CLS query row (k/v still span
every token) on the plain path, as the JAX model does, and the final LN
sees only that row.

ViT-base trains with no dropout (hidden and attention rates 0, as in the
JAX config), so train mode draws nothing here; the rates are passed to the
kernels all the same.
"""
import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import (compact_scores, dropout, fused_weights, gelu, kernel_seed,
                             layer_norm, linear)
from ..ops.hopper.attention_block import attention_block
from ..ops.hopper.ffn_block import ffn_block
from ._util import Group


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    layer_norm_eps: float = 1e-12
    hidden_dropout: float = 0.0
    attention_dropout: float = 0.0

    @staticmethod
    def base() -> "ViTConfig":
        return ViTConfig()

    @staticmethod
    def tiny() -> "ViTConfig":
        return ViTConfig(image_size=32, patch_size=16, hidden_size=32,
                         num_layers=2, num_heads=2, intermediate_size=64)

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


class ViTLayer(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        E, Fd = cfg.hidden_size, cfg.intermediate_size
        self.cfg = cfg
        self.layernorm_before = nn.LayerNorm(E, eps=cfg.layer_norm_eps)
        self.attention = Group(
            attention=Group(query=nn.Linear(E, E), key=nn.Linear(E, E),
                            value=nn.Linear(E, E)),
            output=Group(dense=nn.Linear(E, E)))
        self.layernorm_after = nn.LayerNorm(E, eps=cfg.layer_norm_eps)
        self.intermediate = Group(dense=nn.Linear(E, Fd))
        self.output = Group(dense=nn.Linear(Fd, E))

    def _attn_layers(self):
        a = self.attention
        return (a.attention.query, a.attention.key, a.attention.value, a.output.dense)

    def forward(self, hidden: torch.Tensor, dtype, gen=None) -> torch.Tensor:
        """Whole layer through the two fused kernels."""
        cfg = self.cfg
        ln1 = (self.layernorm_before.weight.to(dtype),
               self.layernorm_before.bias.to(dtype), cfg.layer_norm_eps)
        rate, seed = kernel_seed(gen, cfg.attention_dropout, self.training, hidden.device)
        h = attention_block(hidden, *fused_weights(self._attn_layers(), dtype),
                            num_heads=cfg.num_heads, ln=ln1, residual=True,
                            dropout_rate=rate, dropout_seed=seed)
        ln2 = (self.layernorm_after.weight.to(dtype),
               self.layernorm_after.bias.to(dtype), cfg.layer_norm_eps)
        w1, b1, w2, b2 = fused_weights((self.intermediate.dense, self.output.dense), dtype)
        rate, seed = kernel_seed(gen, cfg.hidden_dropout, self.training, hidden.device)
        return ffn_block(h, w1, b1, w2, b2, ln=ln2, ln_post=False, residual=True,
                         dropout_rate_out=rate, dropout_seed=seed)

    def forward_cls(self, hidden: torch.Tensor, dtype) -> torch.Tensor:
        """CLS-only layer: the first query row against every key, on the
        plain path. Returns [N, 1, E]."""
        cfg = self.cfg
        E, H = cfg.hidden_size, cfg.num_heads
        D = E // H
        N, S, _ = hidden.shape
        x = layer_norm(hidden, self.layernorm_before, dtype)
        wq, wk, wv, wo = self._attn_layers()
        q = linear(x[:, :1], wq, dtype).reshape(N, 1, H, D)
        k = linear(x, wk, dtype).reshape(N, S, H, D)
        v = linear(x, wv, dtype).reshape(N, S, H, D)
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (D ** -0.5)
        probs = torch.softmax(compact_scores(scores, dtype), dim=-1).to(dtype)
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float()).to(dtype)
        h = hidden[:, :1] + linear(ctx.reshape(N, 1, E), wo, dtype)
        y = layer_norm(h, self.layernorm_after, dtype)
        y = gelu(linear(y, self.intermediate.dense, dtype), dtype)
        return h + linear(y, self.output.dense, dtype)


class ViTModel(nn.Module):
    """Frames [N, H, W, 3] → LayerNormed token states [N, 1+P, E], or the
    CLS vector [N, E] with ``cls_only``."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        E = cfg.hidden_size
        self.cfg = cfg
        self.embeddings = Group(
            cls_token=nn.Parameter(torch.zeros(1, 1, E)),
            position_embeddings=nn.Parameter(torch.zeros(1, 1 + cfg.num_patches, E)),
            patch_embeddings=Group(projection=nn.Conv2d(
                3, E, kernel_size=cfg.patch_size, stride=cfg.patch_size)))
        self.encoder = Group(layer=nn.ModuleList(ViTLayer(cfg) for _ in range(cfg.num_layers)))
        self.layernorm = nn.LayerNorm(E, eps=cfg.layer_norm_eps)

    def forward(self, pixel_values: torch.Tensor, dtype=torch.float32,
                cls_only: bool = False, gen=None) -> torch.Tensor:
        cfg = self.cfg
        N, E = pixel_values.shape[0], cfg.hidden_size
        emb = self.embeddings
        conv = emb.patch_embeddings.projection
        x = F.conv2d(pixel_values.to(dtype).permute(0, 3, 1, 2), conv.weight.to(dtype),
                     conv.bias.to(dtype), stride=cfg.patch_size)
        x = x.flatten(2).transpose(1, 2)  # [N, P, E], patches row-major
        cls = emb.cls_token.to(dtype).expand(N, 1, E)
        x = (torch.cat([cls, x], dim=1) + emb.position_embeddings.to(dtype)).contiguous()
        x = dropout(x, cfg.hidden_dropout, gen, self.training)
        layers = self.encoder.layer
        split = len(layers) - 1 if cls_only and len(layers) > 1 else len(layers)
        for layer in layers[:split]:
            x = layer(x, dtype, gen)
        if split < len(layers):
            x = layers[split].forward_cls(x, dtype)
        x = layer_norm(x, self.layernorm, dtype)
        return x[:, 0] if cls_only else x
