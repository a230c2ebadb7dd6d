"""DeBERTa-v2/v3 text backbone (port of simple_multimodal_tpu/models/deberta.py).

microsoft/deberta-v3-base's architecture with HF DebertaV2 state-dict
names: word embeddings, ``emb_ln`` and the mask multiply, layer-normed
relative embeddings shared by every layer (``share_att_key``: the position
projections reuse each layer's own query/key projections), log-bucketed
disentangled attention through the ``deberta_attention`` kernel, and
post-LN layers whose FFN runs through the ``ffn_block`` kernel.

In training mode (``nn.Module.train()``) the JAX model's dropouts run:
the embedding dropout, per layer the dropout of the rel embeddings, the
attention-probability dropout inside ``deberta_attention`` and the
attention-output dropout, and the FFN output dropout inside ``ffn_block``
(hidden and attention rates 0.1). Every mask is drawn from the generator
the caller passes.

Only the fused path's semantics are ported (keys masked with -1e30, query
rows not masked); the JAX package's one-hot bias path is a TPU workaround.
"""
import dataclasses
from typing import Optional

import torch
import torch.nn as nn

from ..ops.attention import dropout, fused_weights, kernel_seed, layer_norm, linear
from ..ops.hopper.deberta_attention import deberta_attention
from ..ops.hopper.ffn_block import ffn_block
from ._util import Group


@dataclasses.dataclass(frozen=True)
class DebertaConfig:
    vocab_size: int = 128100
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    position_buckets: int = 256
    layer_norm_eps: float = 1e-7
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    # the reference's pooling rule reads this ('bert' in 'deberta-v2' → CLS)
    model_type: str = "deberta-v2"

    @staticmethod
    def base() -> "DebertaConfig":
        return DebertaConfig()

    @staticmethod
    def tiny() -> "DebertaConfig":
        return DebertaConfig(vocab_size=1024, hidden_size=32, num_layers=2,
                             num_heads=2, intermediate_size=64,
                             max_position_embeddings=64, position_buckets=16)


class DebertaLayer(nn.Module):
    def __init__(self, cfg: DebertaConfig):
        super().__init__()
        E, Fd, eps = cfg.hidden_size, cfg.intermediate_size, cfg.layer_norm_eps
        self.cfg = cfg
        self.attention = Group(
            self=Group(query_proj=nn.Linear(E, E), key_proj=nn.Linear(E, E),
                       value_proj=nn.Linear(E, E)),
            output=Group(dense=nn.Linear(E, E), LayerNorm=nn.LayerNorm(E, eps=eps)))
        self.intermediate = Group(dense=nn.Linear(E, Fd))
        self.output = Group(dense=nn.Linear(Fd, E), LayerNorm=nn.LayerNorm(E, eps=eps))

    def forward(self, hidden, rel_embeddings, attention_mask, dtype, gen=None):
        cfg = self.cfg
        B, S, E = hidden.shape
        H = cfg.num_heads
        train, dev = self.training, hidden.device
        sa = getattr(self.attention, "self")
        q = linear(hidden, sa.query_proj, dtype).reshape(B, S, H, E // H)
        k = linear(hidden, sa.key_proj, dtype).reshape(B, S, H, E // H)
        v = linear(hidden, sa.value_proj, dtype).reshape(B, S, H, E // H)
        rel_embeddings = dropout(rel_embeddings, cfg.hidden_dropout, gen, train)
        pos_k = linear(rel_embeddings, sa.key_proj, dtype)  # share_att_key
        pos_q = linear(rel_embeddings, sa.query_proj, dtype)
        rate, seed = kernel_seed(gen, cfg.attention_dropout, train, dev)
        ctx = deberta_attention(q, k, v, pos_k, pos_q, attention_mask,
                                span=cfg.position_buckets,
                                max_position=cfg.max_position_embeddings,
                                dropout_rate=rate, dropout_seed=seed)
        attn = linear(ctx.reshape(B, S, E), self.attention.output.dense, dtype)
        attn = dropout(attn, cfg.hidden_dropout, gen, train)
        hidden = layer_norm(attn + hidden, self.attention.output.LayerNorm, dtype)
        ln = self.output.LayerNorm
        w1, b1, w2, b2 = fused_weights((self.intermediate.dense, self.output.dense), dtype)
        rate, seed = kernel_seed(gen, cfg.hidden_dropout, train, dev)
        return ffn_block(hidden, w1, b1, w2, b2,
                         ln=(ln.weight.to(dtype), ln.bias.to(dtype), ln.eps),
                         ln_post=True, residual=True, dropout_rate_out=rate,
                         dropout_seed=seed)


class DebertaModel(nn.Module):
    """input_ids [B, S], attention_mask [B, S] → last_hidden_state [B, S, E]."""

    def __init__(self, cfg: DebertaConfig):
        super().__init__()
        E = cfg.hidden_size
        self.cfg = cfg
        self.embeddings = Group(word_embeddings=nn.Embedding(cfg.vocab_size, E),
                                LayerNorm=nn.LayerNorm(E, eps=cfg.layer_norm_eps))
        self.encoder = Group(
            rel_embeddings=nn.Embedding(2 * cfg.position_buckets, E),
            LayerNorm=nn.LayerNorm(E, eps=cfg.layer_norm_eps),
            layer=nn.ModuleList(DebertaLayer(cfg) for _ in range(cfg.num_layers)))

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                dtype=torch.float32, gen=None) -> torch.Tensor:
        B, S = input_ids.shape
        if attention_mask is None:
            attention_mask = torch.ones((B, S), dtype=torch.int32, device=input_ids.device)
        emb = self.embeddings.word_embeddings.weight.to(dtype)[input_ids.long()]
        emb = layer_norm(emb, self.embeddings.LayerNorm, dtype)
        hidden = emb * attention_mask[..., None].to(dtype)
        hidden = dropout(hidden, self.cfg.hidden_dropout, gen, self.training)
        rel = layer_norm(self.encoder.rel_embeddings.weight.to(dtype),
                         self.encoder.LayerNorm, dtype)
        for layer in self.encoder.layer:
            hidden = layer(hidden, rel, attention_mask, dtype, gen)
        return hidden
