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

Under a mesh with a model axis m > 1 (``parallel/tensor.py``) the attention
splits its heads over the model group, as the JAX kernel's ``shard_map``
does: the q/k/v projections (on their weights gathered whole) give this
process's H/m heads and their head-sharded position tables (the heads'
gradients gathered back in the backward),
``deberta_attention`` runs on them with its seed offset by the data and
model indices, and the heads' outputs are gathered for the output
projection; the word embeddings are vocab-parallel. The FFN takes its
weights gathered whole. So every product computes the bits one process
computes, and only the kernel's dropout masks are the mesh's.
"""
import dataclasses
from typing import Optional

import torch
import torch.nn as nn

from ..ops.attention import dropout, kernel_seed, kernel_weights, layer_norm, linear
from ..ops.hopper.deberta_attention import deberta_attention
from ..ops.hopper.ffn_block import ffn_block
from ..parallel.tensor import Shard, gather_param, placement, scatter_to_model, vocab_lookup
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

    @staticmethod
    def half() -> "DebertaConfig":
        """The distillation student's scale: half the width and depth."""
        return DebertaConfig(hidden_size=384, num_layers=6, num_heads=6,
                             intermediate_size=1536)


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
        self.split_heads_of = cfg.num_heads  # the model axis splits these

    def forward(self, hidden, rel_embeddings, attention_mask, dtype, gen=None):
        cfg = self.cfg
        B, S, E = hidden.shape
        train, dev = self.training, hidden.device
        sa = getattr(self.attention, "self")
        projs = (sa.query_proj, sa.key_proj, sa.value_proj)
        tp = placement(sa.query_proj.weight)
        mesh = None if tp is None else tp.mesh  # None: every head on this process
        H = cfg.num_heads // (1 if mesh is None else mesh.model)
        D = E // cfg.num_heads
        rel_embeddings = dropout(rel_embeddings, cfg.hidden_dropout, gen, train,
                                 batch_axis=False)  # one table, no batch axis

        def proj(x, layer):  # under the model axis this process's heads of it
            y = linear(x, layer, dtype)
            return y if mesh is None else scatter_to_model(y, Shard(y.ndim - 1), mesh)

        q = proj(hidden, sa.query_proj).reshape(B, S, H, D)
        k = proj(hidden, sa.key_proj).reshape(B, S, H, D)
        v = proj(hidden, sa.value_proj).reshape(B, S, H, D)
        pos_k = proj(rel_embeddings, sa.key_proj)  # share_att_key
        pos_q = proj(rel_embeddings, sa.query_proj)
        rate, seed = kernel_seed(gen, cfg.attention_dropout, train, dev, model_axis=True)
        ctx = deberta_attention(q, k, v, pos_k, pos_q, attention_mask,
                                span=cfg.position_buckets,
                                max_position=cfg.max_position_embeddings,
                                dropout_rate=rate, dropout_seed=seed)
        if mesh is not None:  # every head's output, on every process
            ctx = gather_param(ctx, Shard(2), mesh)
        attn = linear(ctx.reshape(B, S, E), self.attention.output.dense, dtype)
        attn = dropout(attn, cfg.hidden_dropout, gen, train)
        hidden = layer_norm(attn + hidden, self.attention.output.LayerNorm, dtype)
        ln = self.output.LayerNorm
        w1, b1, w2, b2 = kernel_weights(dtype, self.intermediate.dense, self.output.dense)
        rate, seed = kernel_seed(gen, cfg.hidden_dropout, train, dev)
        return ffn_block(hidden, w1, b1, w2, b2,
                         ln=(ln.weight.to(dtype), ln.bias.to(dtype), ln.eps),
                         ln_post=True, residual=True, dropout_rate_out=rate,
                         dropout_seed=seed)


class DebertaModel(nn.Module):
    """input_ids [B, S], attention_mask [B, S] → last_hidden_state [B, S, E];
    with ``prompt_embeds`` ([P, E] or [B, P, E], prompt tuning) those
    embeddings go ahead of the word embeddings and the mask gains P ones, so
    the output is [B, P + S, E]."""

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
                dtype=torch.float32, gen=None,
                prompt_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, S = input_ids.shape
        if attention_mask is None:
            attention_mask = torch.ones((B, S), dtype=torch.int32, device=input_ids.device)
        table = self.embeddings.word_embeddings.weight
        tp = placement(table)
        if tp is None:
            emb = table.to(dtype)[input_ids.long()]
        else:  # vocab-parallel
            emb = vocab_lookup(table, input_ids.long(), dtype, tp.mesh)
        if prompt_embeds is not None:
            P = prompt_embeds.shape[-2]
            if prompt_embeds.dim() == 2:
                prompt_embeds = prompt_embeds[None].expand(B, P, emb.shape[-1])
            emb = torch.cat([prompt_embeds.to(emb.dtype), emb], dim=1)
            attention_mask = torch.cat(
                [attention_mask.new_ones((B, P)), attention_mask], dim=1)
        emb = layer_norm(emb, self.embeddings.LayerNorm, dtype)
        hidden = emb * attention_mask[..., None].to(dtype)
        hidden = dropout(hidden, self.cfg.hidden_dropout, gen, self.training)
        rel = layer_norm(self.encoder.rel_embeddings.weight.to(dtype),
                         self.encoder.LayerNorm, dtype)
        for layer in self.encoder.layer:
            hidden = layer(hidden, rel, attention_mask, dtype, gen)
        return hidden
