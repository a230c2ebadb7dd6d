"""DeepSeek-V3's decoder (Moonlight-16B-A3B's shape) as a text backbone.

The layer equations of the ``modeling_deepseek.py`` published beside
moonshotai/Moonlight-16B-A3B's ``config.json`` (``model_type``
``deepseek_v3``), with its state-dict names under ``embed_tokens``,
``layers.{i}`` and ``norm``; no LM head (the recogniser pools the last
hidden states). For hidden state x at positions 0…S−1:

- pre-norm layers: h = x + MLA(RMSNorm(x)), x' = h + FFN(RMSNorm(h)), each
  RMSNorm in f32 with its weight;
- multi-head latent attention: q = q_proj(x) [S, H, nope + rope];
  ``kv_a_proj_with_mqa(x)`` gives the latent c (``kv_lora_rank``) and one
  rope key shared by the heads; ``kv_b_proj(RMSNorm(c))`` gives each
  head's nope key and value; RoPE (θ ``rope_theta``, no scaling) on the
  rope parts after DeepSeek's de-interleave (each vector viewed as
  [d/2, 2], transposed, flattened, then ``rotate_half``);
  softmax(q·kᵀ/√(nope + rope) + causal mask)·v, then ``o_proj``. With
  right padding the causal mask alone is exact for every real token;
- the first ``first_k_dense_replace`` layers' FFN is dense,
  down(silu(gate(x)) ⊙ up(x)); every later one is a mixture of experts:
  sigmoid scores of an f32 router, the top ``num_experts_per_tok`` of
  score + ``e_score_correction_bias`` chosen (the bias chooses and is not
  a weight; a buffer, not trained), the chosen scores divided by their sum
  (+1e-20) and × ``routed_scaling_factor``; the output is the shared
  experts (one FFN ``n_shared_experts`` times the expert width) plus the
  weighted experts.

Expert share (``expert_share`` = (index, count)): this process holds the
index-th of ``count`` equal blocks of each layer's routed experts, under
their global indices (``experts.{j}``), as one rank of ``count``-way
expert parallelism holds them. The router scores all experts; the output
adds only the held experts' terms, and what the other blocks' experts would
add is left out (no exchange runs, and nothing stands in for it). Each MoE
layer counts the rows routed to each held expert in ``routed_rows``, on
the device. Nothing in a layer reads the routing back to the host: the
counts, each held expert's rows in expert-sorted order and their offsets
stay on the device (``ops/hopper/moe_experts.py::dispatch``), and the held
experts run as one ``moe_experts`` call whose launches and shapes do not
depend on the routing. A held expert that gets no rows gets a zero
gradient.

The tower computes in ``dtype`` (bf16 on the card) over f32 parameters;
the router's logits, sigmoid, choice and weights in f32, as the published
code. Projections, the dense FFN and the shared experts run through
``ops/hopper/gemm.py``'s ``gemm_linear``, the routed experts through
``ops/hopper/moe_experts.py``'s ``moe_experts``; the attention core through
``F.scaled_dot_product_attention`` with the causal flag, the value padded
with zeros to the query width (the flash and memory-efficient kernels take
one head width) and cut back. While a profiler records, each layer's
attention is the span ``smm.mla`` and each MoE layer's parts the spans
``smm.moe.route``, ``smm.moe.experts`` and ``smm.moe.shared``.
"""
import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.hopper.gemm import gemm_linear
from ..ops.hopper.moe_experts import dispatch, moe_experts
from ..utils.profiling import annotate

MOONLIGHT = "moonshotai/Moonlight-16B-A3B"


@dataclasses.dataclass(frozen=True)
class DeepseekConfig:
    vocab_size: int = 163840
    hidden_size: int = 2048
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    n_routed_experts: int = 64
    num_experts_per_tok: int = 6
    n_shared_experts: int = 2
    first_k_dense_replace: int = 1
    routed_scaling_factor: float = 2.446
    rms_norm_eps: float = 1e-5
    rope_theta: float = 50000.0
    # the recogniser's pooling rule reads this (no 'bert' in it: the masked mean)
    model_type: str = "deepseek_v3"
    # (index, count): this process holds the index-th of count blocks of experts
    expert_share: Tuple[int, int] = (0, 1)

    def __post_init__(self):
        index, count = self.expert_share
        if count < 1 or not 0 <= index < count or self.n_routed_experts % count:
            raise ValueError(f"expert share {tuple(self.expert_share)}: the index must lie in "
                             f"[0, count) and count divide the {self.n_routed_experts} experts")

    @staticmethod
    def moonlight() -> "DeepseekConfig":
        """moonshotai/Moonlight-16B-A3B's published config.json."""
        return DeepseekConfig()

    @staticmethod
    def tiny() -> "DeepseekConfig":
        return DeepseekConfig(vocab_size=1000, hidden_size=64, intermediate_size=128,
                              moe_intermediate_size=32, num_hidden_layers=3,
                              num_attention_heads=2, kv_lora_rank=32, qk_nope_head_dim=16,
                              qk_rope_head_dim=8, v_head_dim=16, n_routed_experts=16,
                              num_experts_per_tok=4, n_shared_experts=1)

    @property
    def held_experts(self) -> range:
        """The global indices of the experts this process holds."""
        index, count = self.expert_share
        n = self.n_routed_experts // count
        return range(index * n, (index + 1) * n)


class Linear(nn.Linear):
    """A bias-free Linear with no initialisation of its own: the model's
    ``init_weights`` (or a loaded state) sets it, which spares a second
    pass over a tower of billions of weights."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__(in_features, out_features, bias=False)

    def reset_parameters(self) -> None:
        pass


class RMSNorm(nn.Module):
    def __init__(self, n: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n))
        self.eps = eps

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        x = x.float()
        return (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps)
                * self.weight).to(dtype)


def rope_tables(S: int, dim: int, theta: float, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos, sin [S, 1, dim] in f32: frequencies θ^(−2i/dim), each twice."""
    inv = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim)
    freqs = torch.outer(torch.arange(S, dtype=torch.float32, device=device), inv)
    emb = torch.cat([freqs, freqs], dim=-1)[:, None, :]
    return emb.cos(), emb.sin()


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """DeepSeek's ``apply_rotary_pos_emb`` on x [B, S, H, d], in f32: the
    de-interleave (pairs (2i, 2i+1) to (i, d/2 + i)), then x·cos +
    rotate_half(x)·sin."""
    *lead, d = x.shape
    x = x.float().reshape(*lead, d // 2, 2).transpose(-1, -2).reshape(*lead, d)
    rotated = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * cos + rotated * sin


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q·kᵀ/√d + causal mask)·v for q/k [B, S, H, d], v [B, S, H, dv]
    (dv ≤ d) → [B, S, H, dv]: the value padded with zeros to d, so the flash
    and memory-efficient kernels take it, and cut back."""
    d, dv = q.shape[-1], v.shape[-1]
    q, k, v = (t.transpose(1, 2) for t in (q, k, F.pad(v, (0, d - dv))))
    if q.is_cuda:
        from torch.nn.attention import SDPBackend, sdpa_kernel

        with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]):
            out = F.scaled_dot_product_attention(q, k, v, is_causal=True, scale=d ** -0.5)
    else:
        out = F.scaled_dot_product_attention(q, k, v, is_causal=True, scale=d ** -0.5)
    return out[..., :dv].transpose(1, 2)


class Attention(nn.Module):
    """Multi-head latent attention (``q_lora_rank`` null: q straight from x)."""

    def __init__(self, cfg: DeepseekConfig):
        super().__init__()
        E, H = cfg.hidden_size, cfg.num_attention_heads
        nope, rope, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        self.cfg = cfg
        self.q_proj = Linear(E, H * (nope + rope))
        self.kv_a_proj_with_mqa = Linear(E, cfg.kv_lora_rank + rope)
        self.kv_a_layernorm = RMSNorm(cfg.kv_lora_rank, cfg.rms_norm_eps)
        self.kv_b_proj = Linear(cfg.kv_lora_rank, H * (nope + dv))
        self.o_proj = Linear(H * dv, E)

    def forward(self, x, cos, sin, dtype):
        cfg = self.cfg
        B, S, _ = x.shape
        H, nope, rope, dv = (cfg.num_attention_heads, cfg.qk_nope_head_dim,
                             cfg.qk_rope_head_dim, cfg.v_head_dim)
        q = gemm_linear(x, self.q_proj.weight).reshape(B, S, H, nope + rope)
        q_nope, q_pe = q.split([nope, rope], dim=-1)
        c, k_pe = gemm_linear(x, self.kv_a_proj_with_mqa.weight).split(
            [cfg.kv_lora_rank, rope], dim=-1)
        kv = gemm_linear(self.kv_a_layernorm(c, dtype), self.kv_b_proj.weight)
        k_nope, v = kv.reshape(B, S, H, nope + dv).split([nope, dv], dim=-1)
        q = torch.cat([q_nope, apply_rope(q_pe, cos, sin).to(dtype)], dim=-1)
        k_pe = apply_rope(k_pe[:, :, None], cos, sin).to(dtype)
        k = torch.cat([k_nope, k_pe.expand(B, S, H, rope)], dim=-1)
        out = causal_attention(q, k, v)
        return gemm_linear(out.reshape(B, S, H * dv), self.o_proj.weight)


class MLP(nn.Module):
    """down(silu(gate(x)) ⊙ up(x)): the dense FFN, one expert, or the shared
    experts; gate and up in one product."""

    def __init__(self, E: int, width: int):
        super().__init__()
        self.gate_proj = Linear(E, width)
        self.up_proj = Linear(E, width)
        self.down_proj = Linear(width, E)

    def forward(self, x, dtype):
        gate, up = gemm_linear(x, self.gate_proj.weight, self.up_proj.weight).chunk(2, dim=-1)
        return gemm_linear((F.silu(gate.float()) * up.float()).to(dtype), self.down_proj.weight)


class MoEGate(Linear):
    """The router: ``weight`` [experts, E] and the choice-only
    ``e_score_correction_bias`` (a buffer: the aux-loss-free update that
    moves it belongs to pretraining)."""

    def __init__(self, E: int, experts: int):
        super().__init__(E, experts)
        self.register_buffer("e_score_correction_bias", torch.zeros(experts))


def route(logits: torch.Tensor, bias: torch.Tensor, k: int, scale: float):
    """(choice [T, k] of expert indices, weights [T, k] in f32) from f32
    router logits [T, experts]: the top k of sigmoid + bias, weighted by
    their sigmoid scores normalised to sum 1 (+1e-20) and × ``scale``."""
    scores = torch.sigmoid(logits)
    choice = torch.topk(scores.detach() + bias, k, dim=-1).indices
    weights = scores.gather(1, choice)
    return choice, weights / (weights.sum(dim=-1, keepdim=True) + 1e-20) * scale


class MoE(nn.Module):
    def __init__(self, cfg: DeepseekConfig):
        super().__init__()
        E = cfg.hidden_size
        self.cfg = cfg
        self.held = cfg.held_experts
        self.gate = MoEGate(E, cfg.n_routed_experts)
        self.experts = nn.ModuleDict({str(j): MLP(E, cfg.moe_intermediate_size)
                                      for j in self.held})
        self.shared_experts = MLP(E, cfg.moe_intermediate_size * cfg.n_shared_experts)
        self.register_buffer("routed_rows", torch.zeros(len(self.held), dtype=torch.long),
                             persistent=False)

    def forward(self, x, dtype):
        cfg = self.cfg
        shape = x.shape
        h = x.reshape(-1, shape[-1])
        with annotate("smm.moe.route"):
            logits = F.linear(h.float(), self.gate.weight)
            choice, weights = route(logits, self.gate.e_score_correction_bias,
                                    cfg.num_experts_per_tok, cfg.routed_scaling_factor)
            plan = dispatch(choice, self.held.start, len(self.held))
            self.routed_rows += plan.counts
        with annotate("smm.moe.experts"):
            experts = [self.experts[str(j)] for j in self.held]
            out = moe_experts(h, weights, plan, [e.gate_proj.weight for e in experts],
                              [e.up_proj.weight for e in experts],
                              [e.down_proj.weight for e in experts])
        with annotate("smm.moe.shared"):
            shared = self.shared_experts(h, dtype)
        return (shared.float() + out).to(dtype).reshape(shape)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: DeepseekConfig, index: int):
        super().__init__()
        E, eps = cfg.hidden_size, cfg.rms_norm_eps
        self.input_layernorm = RMSNorm(E, eps)
        self.self_attn = Attention(cfg)
        self.post_attention_layernorm = RMSNorm(E, eps)
        self.mlp = (MLP(E, cfg.intermediate_size) if index < cfg.first_k_dense_replace
                    else MoE(cfg))

    def forward(self, x, cos, sin, dtype):
        with annotate("smm.mla"):
            x = x + self.self_attn(self.input_layernorm(x, dtype), cos, sin, dtype)
        return x + self.mlp(self.post_attention_layernorm(x, dtype), dtype)


class DeepseekModel(nn.Module):
    """The decoder stack without its LM head: ids [B, S] → the final-normed
    hidden states [B, S, E] in ``dtype``. Under a mesh with a model axis
    above 1 ``parallel/tensor.py::shard_module`` refuses it."""

    refuses_model_axis = True

    def __init__(self, cfg: DeepseekConfig):
        super().__init__()
        self.cfg = cfg
        E = cfg.hidden_size
        self.embed_tokens = nn.Embedding(cfg.vocab_size, E,
                                         _weight=torch.empty(cfg.vocab_size, E))
        self.layers = nn.ModuleList([DecoderLayer(cfg, i) for i in range(cfg.num_hidden_layers)])
        self.norm = RMSNorm(E, cfg.rms_norm_eps)

    def forward(self, input_ids, attention_mask=None, dtype=torch.float32,
                gen: Optional[torch.Generator] = None,
                prompt_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``attention_mask`` and ``gen`` are not read (causal attention, no
        dropout: Moonlight's attention dropout is 0); ``prompt_embeds``
        [P, E] go ahead of the token embeddings."""
        del attention_mask, gen
        x = F.embedding(input_ids, self.embed_tokens.weight).to(dtype)
        if prompt_embeds is not None:
            x = torch.cat([prompt_embeds.to(dtype).expand(x.shape[0], -1, -1), x], dim=1)
        cos, sin = rope_tables(x.shape[1], self.cfg.qk_rope_head_dim, self.cfg.rope_theta,
                               x.device)
        for layer in self.layers:
            x = layer(x, cos, sin, dtype)
        return self.norm(x, dtype)

    def routed_rows(self) -> torch.Tensor:
        """[MoE layers, held experts] rows routed so far, on the device (no
        synchronisation until the caller reads it)."""
        return torch.stack([layer.mlp.routed_rows for layer in self.layers
                            if isinstance(layer.mlp, MoE)])

