"""Fused self-attention block: [pre-LN ->] qkv projection -> softmax(QKᵀ/√D)·V
-> output projection [+ x], over hidden states x [B, S, E].

Replaces the TPU kernel simple_multimodal_tpu/ops/pallas/attention_block.py
(``_kernel`` via ``_fused_call``). On a CUDA tensor the wrapper launches the
hand-written kernel chain in ``csrc/attention_block.cu``; on a CPU tensor it
runs ``attention_block_plain``, the port of that file's ``_xla_reference``.
Bounds and design of the CUDA version are noted in the .cu source: the four
projections are tensor-core GEMMs with fused epilogues; the streaming-softmax
attention core reads q/k/v from the packed projection buffer (tensor cores
in bf16, FMA loops in f32).
"""
import math
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build


def attention_block_plain(x, wq, bq, wk, bk, wv, bv, wo, bo, num_heads: int,
                          ln: Optional[tuple] = None, residual: bool = False):
    """Plain PyTorch version: the same math as the JAX ``_xla_reference``.

    Weights in flax layout (wq [E_in, E_out]); ``ln=(scale, bias, eps)``
    applies a pre-LayerNorm with f32 statistics. Scores and the softmax are
    f32; probabilities are rounded to x's dtype before ·V, as the reference
    rounds them.
    """
    B, S, E = x.shape
    H = num_heads
    D = E // H
    xn = x
    if ln is not None:
        g, b, eps = ln
        xn = F.layer_norm(x.float(), (E,), g.float(), b.float(), eps).to(x.dtype)
    q = (xn @ wq + bq).reshape(B, S, H, D)
    k = (xn @ wk + bk).reshape(B, S, H, D)
    v = (xn @ wv + bv).reshape(B, S, H, D)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(D)
    p = torch.softmax(s, dim=-1).to(x.dtype)
    ctx = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, S, E)
    out = (ctx @ wo + bo).float()
    if residual:
        out = out + x.float()
    return out.to(x.dtype)


def _linear_weight(w: torch.Tensor) -> torch.Tensor:
    """flax [in, out] → torch Linear [out, in], without a copy when ``w``
    is already the transposed view of a contiguous Linear weight."""
    return w.t().contiguous()


def attention_block(x, wq, bq, wk, bk, wv, bv, wo, bo, num_heads: int,
                    ln: Optional[tuple] = None, residual: bool = False):
    """Fused attention block over x [B, S, E]; same arguments and layouts as
    the JAX ``attention_block`` (weights [E_in, E_out], biases [E]).

    CPU tensors run the plain version; CUDA tensors launch the kernel or
    raise. Returns [B, S, E] in x's dtype.
    """
    if x.device.type == "cpu":
        return attention_block_plain(x, wq, bq, wk, bk, wv, bv, wo, bo,
                                     num_heads, ln=ln, residual=residual)
    if x.device.type != "cuda":
        raise RuntimeError(f"attention_block: no kernel for device {x.device}")
    B, S, E = x.shape
    if E % num_heads or E // num_heads not in (16, 32, 64, 128):
        raise ValueError(f"attention_block: head width {E}/{num_heads} not "
                         "in (16, 32, 64, 128)")
    if E % 8:
        raise ValueError(f"attention_block: E={E} must be a multiple of 8")
    dt = x.dtype
    code = _build.dtype_code(x)
    lib = _build.library()
    x = x.contiguous()
    ws = [_linear_weight(w.to(dt)) for w in (wq, wk, wv, wo)]
    bs = [b.to(dt).contiguous() for b in (bq, bk, bv, bo)]
    for t in ws + bs:
        if t.device != x.device or t.shape[-1] != E:
            raise ValueError("attention_block: weights must be [E, E] and "
                             "biases [E] on the input's device")
    M = B * S
    ln_g = ln_b = xn = None
    eps = 0.0
    if ln is not None:
        ln_g = ln[0].to(dt).contiguous()
        ln_b = ln[1].to(dt).contiguous()
        eps = float(ln[2])
        xn = torch.empty((M, E), dtype=dt, device=x.device)
    qkv = torch.empty((M, 3 * E), dtype=dt, device=x.device)
    ctx = torch.empty((M, E), dtype=dt, device=x.device)
    out = torch.empty_like(x)
    p = _build.ptr
    err = lib.smm_attention_block(
        code, p(x), p(ws[0]), p(bs[0]), p(ws[1]), p(bs[1]), p(ws[2]), p(bs[2]),
        p(ws[3]), p(bs[3]), p(ln_g), p(ln_b), eps, int(residual), B, S, E,
        num_heads, p(xn), p(qkv), p(ctx), p(out), _build.stream_ptr(x))
    _build.check(lib, err, "attention_block")
    attention_block.launches += 1
    return out


attention_block.launches = 0
