"""Attention helpers and torch ``nn.MultiheadAttention`` semantics, written
out as plain matmuls (port of simple_multimodal_tpu/ops/attention.py).

Not ``nn.MultiheadAttention``'s fused fast path and not SDPA: the JAX
module's numerics are reproduced step by step (packed q/k/v projections,
1/√Dh scaling, f32 scores rounded to the compute dtype, f32 softmax,
probabilities in the compute dtype, head-averaged weights), so converted
weights give matching outputs.
"""
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.mesh import draw_rows, kernel_seed_offset
from ..parallel.tensor import weight
from .hopper.flash_attention import flash_attention

FLASH_MIN_LENGTH = 512  # queries and keys beyond this go through flash_attention


def resolve_dtype(config, device) -> torch.dtype:
    """Compute dtype: bf16 (``compute_dtype``) on CUDA under
    ``mixed_precision``, f32 elsewhere. Params stay f32."""
    if getattr(config, "mixed_precision", False) and torch.device(device).type == "cuda":
        return getattr(torch, getattr(config, "compute_dtype", "bfloat16"))
    return torch.float32


def require_device(device, who: str) -> torch.device:
    """``device`` as a ``torch.device``. The port's entry points run on the
    card by default; with no CUDA device they raise here instead of carrying
    on on the CPU, which a caller asks for with ``device="cpu"``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: no CUDA device for device={str(device)!r} (the default); "
                           'pass device="cpu" to run on the CPU')
    return device


def compact_scores(scores: torch.Tensor, dtype) -> torch.Tensor:
    """Round attention logits to the compute dtype before the f32 softmax
    (the JAX plain paths do this under bf16); identity in f32."""
    if dtype == torch.bfloat16:
        return scores.to(torch.bfloat16).float()
    return scores


def gelu(x: torch.Tensor, dtype) -> torch.Tensor:
    """erf-exact GELU in f32; the tanh approximation under bf16."""
    return F.gelu(x, approximate="tanh" if dtype == torch.bfloat16 else "none")


def linear(x: torch.Tensor, layer: nn.Linear, dtype) -> torch.Tensor:
    """A Linear layer computed in ``dtype`` from its f32 params (the flax
    ``nn.Dense(dtype=...)`` cast; a weight sharded over the mesh's model
    axis gathered whole, ``parallel/tensor.py::weight``)."""
    b = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), weight(layer.weight, dtype), b)


def layer_norm(x: torch.Tensor, layer: nn.LayerNorm, dtype) -> torch.Tensor:
    """LayerNorm with f32 statistics, output in ``dtype``."""
    return F.layer_norm(x.float(), layer.normalized_shape, layer.weight.float(),
                        layer.bias.float(), layer.eps).to(dtype)


def dropout(x: torch.Tensor, rate: float, gen: Optional[torch.Generator],
            training: bool, batch_axis: bool = True) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each element with probability 1 − rate and
    scale it by 1/(1 − rate), the mask drawn from ``gen`` (on x's device);
    the identity in eval mode or at rate 0. No global RNG is used. x's first
    axis is the batch (or batch-major) unless ``batch_axis`` is False: under
    a data-parallel mesh its mask is then this rank's rows of the global
    batch's (``parallel/mesh.py::draw_rows``)."""
    if not training or not rate:
        return x
    if gen is None:
        raise ValueError("dropout in training mode needs a torch.Generator")
    if batch_axis:
        rand = draw_rows(torch.rand, x.shape, generator=gen, device=x.device)
    else:
        rand = torch.rand(x.shape, generator=gen, device=x.device)
    keep = rand < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def kernel_seed(gen: Optional[torch.Generator], rate: float, training: bool,
                device, model_axis: bool = False) -> Tuple[float, Optional[torch.Tensor]]:
    """(rate, seed) for a fused kernel's hash dropout: an int32 [1] seed in
    [0, 2³¹ − 1) drawn from ``gen`` on the device (no host sync), as the
    JAX ``kernel_dropout_seed`` draws it; (0.0, None) in eval mode or at
    rate 0, without a draw. Under a mesh the draw is the same on every rank
    and the rank at data index i adds i · 1000003 (int32 wrap-around), and
    with ``model_axis`` (a kernel that splits heads over ``model``) model
    index j adds j · 7919 too, as the JAX kernels do inside their
    ``shard_map``: the kernels hash local batch and head indices, so no
    shard repeats another's masks."""
    if not training or not rate:
        return 0.0, None
    if gen is None:
        raise ValueError("dropout in training mode needs a torch.Generator")
    seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=gen, device=device,
                         dtype=torch.int32)
    offset = kernel_seed_offset(model_axis)
    if offset:
        seed = ((seed.long() + offset + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)
    return float(rate), seed


def kernel_weights(dtype, *layers) -> list:
    """[w, b] for each entry of ``layers``, as the fused kernels take them:
    in the Linear's own [out, in] layout, cast to ``dtype`` (a weight
    sharded over the mesh's model axis gathered whole,
    ``parallel/tensor.py::weight``). An entry that is a tuple of Linears
    (q, k, v) gives one packed weight [Σ out, in] and bias, concatenated
    here once a forward."""
    out = []
    for entry in layers:
        group = entry if isinstance(entry, tuple) else (entry,)
        ws = [weight(layer.weight, dtype) for layer in group]
        bs = [layer.bias.to(dtype) for layer in group]
        out += [ws[0], bs[0]] if len(group) == 1 else [torch.cat(ws), torch.cat(bs)]
    return out


class MultiHeadAttention(nn.Module):
    """torch MHA parameters (``in_proj_weight`` [3E, E], ``in_proj_bias``,
    ``out_proj``) with the JAX module's computation; in training mode the
    probabilities take dropout at ``dropout`` (drawn from ``gen``).

    A call that needs no weights, drops no probabilities (eval mode, or
    ``dropout`` 0) and has more than ``FLASH_MIN_LENGTH`` queries and keys
    goes through ``flash_attention``, the JAX module's gate: no [B, H, Q, K]
    tensor is formed there."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, query, key, value, dtype=torch.float32, need_weights: bool = True,
                gen: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """query [B, Q, E], key/value [B, K, E] → (output [B, Q, E],
        attention weights averaged over heads [B, Q, K] or None)."""
        E, H = self.embed_dim, self.num_heads
        Dh = E // H
        B, Q, K = query.shape[0], query.shape[1], key.shape[1]
        w = weight(self.in_proj_weight, dtype)
        b = self.in_proj_bias.to(dtype)
        q = F.linear(query.to(dtype), w[:E], b[:E]).reshape(B, Q, H, Dh)
        k = F.linear(key.to(dtype), w[E:2 * E], b[E:2 * E]).reshape(B, K, H, Dh)
        v = F.linear(value.to(dtype), w[2 * E:], b[2 * E:]).reshape(B, K, H, Dh)
        no_drop = not self.training or not self.dropout
        if not need_weights and no_drop and Q > FLASH_MIN_LENGTH and K > FLASH_MIN_LENGTH:
            out = flash_attention(q, k, v)
            return linear(out.reshape(B, Q, E), self.out_proj, dtype), None
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (Dh ** -0.5)
        logits = compact_scores(logits, dtype)
        probs = torch.softmax(logits, dim=-1).to(dtype)
        dropped = dropout(probs, self.dropout, gen, self.training)
        out = torch.einsum("bhqk,bkhd->bqhd", dropped.float(), v.float()).to(dtype)
        out = linear(out.reshape(B, Q, E), self.out_proj, dtype)
        if need_weights:
            return out, probs.mean(dim=1)
        return out, None
