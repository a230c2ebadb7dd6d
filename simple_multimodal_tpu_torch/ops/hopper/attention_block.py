"""Fused self-attention block: [pre-LN ->] qkv projection -> softmax(QKᵀ/√D)
[hash dropout] ·V -> output projection [+ x], over hidden states x [B, S, E].

Replaces the TPU kernels of simple_multimodal_tpu/ops/pallas/attention_block.py:
the forward (``_kernel`` via ``_fused_call``) and the backward
(``_bwd_kernel`` via ``_block_bwd``). On a CUDA tensor the wrapper runs
``AttentionBlockFn``, whose forward launches the kernel chain in
``csrc/attention_block.cu`` (in bf16 at the base widths: the wgmma GEMM of
``csrc/gemm_wgmma.cu`` for q|k|v in one launch and for the out-projection,
the wgmma core of ``csrc/attention_core_wgmma.cu`` between them) and whose
backward launches the one in ``csrc/attention_block_bwd.cu`` (in bf16 at head
widths 64 and 128: the same GEMM, the wgmma forward core re-run for the row
statistics, and the wgmma dq and dk/dv kernels of
``csrc/attention_core_bwd_wgmma.cu``); on a CPU tensor it runs
``attention_block_plain``, the port of that file's ``_xla_reference``, and
autograd differentiates it. Bounds and design of the CUDA versions are
noted in the .cu sources.
"""
import math
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build
from .dropout import apply_keep, attention_keep, threshold
from .gemm import aligned16


def attention_block_plain(x, wq, bq, wk, bk, wv, bv, wo, bo, num_heads: int,
                          ln: Optional[tuple] = None, residual: bool = False,
                          dropout_rate: float = 0.0, dropout_seed=None):
    """Plain PyTorch version: the same math as the JAX ``_xla_reference``.

    Weights in flax layout (wq [E_in, E_out]); ``ln=(scale, bias, eps)``
    applies a pre-LayerNorm with f32 statistics. Scores and the softmax are
    f32; the probabilities take the hash dropout (``dropout.attention_keep``)
    and are rounded to x's dtype before ·V, as the reference does.
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
    p = torch.softmax(s, dim=-1)
    if dropout_rate:
        p = apply_keep(p, attention_keep(dropout_seed, B, H, S, S, dropout_rate,
                                         device=x.device), dropout_rate)
    p = p.to(x.dtype)
    ctx = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, S, E)
    out = (ctx @ wo + bo).float()
    if residual:
        out = out + x.float()
    return out.to(x.dtype)


def _seed_tensor(seed, device) -> torch.Tensor:
    """The kernels read the dropout seed from device memory: an int32 [1]."""
    return torch.as_tensor(seed, device=device).reshape(1).to(torch.int32).contiguous()


def _flax_t(w: torch.Tensor) -> torch.Tensor:
    """flax [in, out] → [out, in] contiguous and 16-byte aligned (the wgmma
    GEMM reads it through a TMA tensor map), without a copy when ``w`` is the
    transposed view of a contiguous, aligned Linear weight."""
    return aligned16(w.t().contiguous())


class AttentionBlockFn(torch.autograd.Function):
    """The CUDA forward and backward of the block. Saves only the inputs:
    the backward recomputes LN, q/k/v and the probabilities, as the TPU
    kernel does."""

    @staticmethod
    def forward(ctx, x, wq, bq, wk, bk, wv, bv, wo, bo, ln_g, ln_b, seed,
                num_heads, eps, residual, rate):
        B, S, E = x.shape
        dt = x.dtype
        lib = _build.library()
        ws = [_flax_t(w) for w in (wq, wk, wv, wo)]
        bs = [aligned16(b.contiguous()) for b in (bq, bk, bv, bo)]
        x = aligned16(x)
        M = B * S
        xn = torch.empty((M, E), dtype=dt, device=x.device) if ln_g is not None else None
        qkv = torch.empty((M, 3 * E), dtype=dt, device=x.device)
        cbuf = torch.empty((M, E), dtype=dt, device=x.device)
        out = torch.empty_like(x)
        p = _build.ptr
        err = lib.smm_attention_block(
            _build.dtype_code(x), p(x), p(ws[0]), p(bs[0]), p(ws[1]), p(bs[1]),
            p(ws[2]), p(bs[2]), p(ws[3]), p(bs[3]), p(ln_g), p(ln_b), eps,
            int(residual), B, S, E, num_heads, p(seed),
            threshold(rate), _drop_scale(rate), p(xn), p(qkv), p(cbuf), p(out),
            _build.stream_ptr(x))
        _build.check(lib, err, "attention_block")
        attention_block.launches += 1
        ctx.save_for_backward(x, wq, bq, wk, bk, wv, bv, wo, ln_g, ln_b, seed)
        ctx.cfg = (num_heads, eps, residual, rate)
        return out

    @staticmethod
    def backward(ctx, gy):
        x, wq, bq, wk, bk, wv, bv, wo, ln_g, ln_b, seed = ctx.saved_tensors
        num_heads, eps, residual, rate = ctx.cfg
        B, S, E = x.shape
        M = B * S
        dt, dev = x.dtype, x.device
        gy = aligned16(gy.to(dt).contiguous())  # the LayerNorm backward reads 16-byte rows
        lib = _build.library()
        w_proj = [_flax_t(w) for w in (wq, wk, wv)]      # [out, in]: recompute q/k/v
        w_cat = torch.cat([wq, wk, wv], dim=1).contiguous()  # [E, 3E]: dxn
        wo_c = wo.contiguous()                           # [E, E]: da = gy·Woᵀ
        f32 = torch.float32
        has_ln = ln_g is not None
        xn = torch.empty((M, E), dtype=dt, device=dev) if has_ln else None
        qkv = torch.empty((M, 3 * E), dtype=dt, device=dev)
        da = torch.empty((M, E), dtype=dt, device=dev)
        a = torch.empty((M, E), dtype=dt, device=dev)
        stats = torch.empty((3, B * num_heads * S), dtype=f32, device=dev)
        dqkv = torch.empty((M, 3 * E), dtype=dt, device=dev)
        dxn = torch.empty((M, E), dtype=f32, device=dev) if has_ln else None
        dx = torch.empty((M, E), dtype=dt, device=dev)
        part = (torch.empty((_build.ln_bwd_blocks(M), 2 * E), dtype=f32, device=dev)
                if has_ln else None)
        dln = torch.empty((2, E), dtype=f32, device=dev) if has_ln else None
        p = _build.ptr
        err = lib.smm_attention_block_bwd(
            _build.dtype_code(x), p(x), p(gy), p(w_proj[0]), p(bq), p(w_proj[1]),
            p(bk), p(w_proj[2]), p(bv), p(w_cat), p(wo_c), p(ln_g), p(ln_b), eps,
            int(residual), B, S, E, num_heads, p(seed),
            threshold(rate), _drop_scale(rate), p(xn), p(qkv), p(da), p(a),
            p(stats), p(dqkv), p(dxn), p(dx), p(part), p(dln), _build.stream_ptr(x))
        _build.check(lib, err, "attention_block_bwd")
        attention_block_bwd.launches += 1
        # weight grads: (B, S)-contractions outside the kernel, as in the JAX
        # _block_bwd
        xin = xn if has_ln else x.reshape(M, E)
        dW = (xin.t() @ dqkv).to(wq.dtype)
        db = dqkv.float().sum(0)
        g2 = gy.reshape(M, E)
        dwo = (a.t() @ g2).to(wo.dtype)
        dbo = g2.float().sum(0).to(bq.dtype)
        dln_g = dln[0].to(ln_g.dtype) if has_ln else None
        dln_b = dln[1].to(ln_b.dtype) if has_ln else None
        return (dx.reshape(B, S, E), dW[:, :E], db[:E].to(bq.dtype), dW[:, E:2 * E],
                db[E:2 * E].to(bk.dtype), dW[:, 2 * E:], db[2 * E:].to(bv.dtype),
                dwo, dbo, dln_g, dln_b, None, None, None, None, None)


def attention_wgmma_route(dtype: torch.dtype, head_width: int, rel: bool) -> int:
    """Which body an attention core runs, as ``attention_wgmma_takes``
    (``csrc/attention.cuh``) decides it and ``smm_attention_wgmma_route``
    reports it: 1 for the wgmma kernels (bf16, head width 64, or 128 without
    position tables), 0 for the WMMA / f32 kernels of ``csrc/attention.cuh``
    and ``csrc/attention_bwd.cuh``. ``rel``: deberta_attention's core, whose
    forward and backward both follow it; else attention_block's backward."""
    wide = head_width == 64 or (head_width == 128 and not rel)
    return int(dtype == torch.bfloat16 and wide)


def _drop_scale(rate: float) -> float:
    return 1.0 / (1.0 - rate) if rate else 1.0


def attention_block(x, wq, bq, wk, bk, wv, bv, wo, bo, num_heads: int,
                    ln: Optional[tuple] = None, residual: bool = False,
                    dropout_rate: float = 0.0, dropout_seed=None):
    """Fused attention block over x [B, S, E]; same arguments and layouts as
    the JAX ``attention_block`` (weights [E_in, E_out], biases [E]).
    ``dropout_rate`` > 0 drops attention probabilities by the stateless
    hash of ``dropout_seed`` (an int32 scalar or [1] tensor).

    CPU tensors run the plain version; CUDA tensors launch the kernels
    (forward, and backward under autograd) or raise. Returns [B, S, E] in
    x's dtype.
    """
    rate = float(dropout_rate)
    if rate and dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed")
    if x.device.type == "cpu":
        return attention_block_plain(x, wq, bq, wk, bk, wv, bv, wo, bo, num_heads,
                                     ln=ln, residual=residual, dropout_rate=rate,
                                     dropout_seed=dropout_seed)
    if x.device.type != "cuda":
        raise RuntimeError(f"attention_block: no kernel for device {x.device}")
    B, S, E = x.shape
    if E % num_heads or E // num_heads not in (16, 32, 64, 128):
        raise ValueError(f"attention_block: head width {E}/{num_heads} not "
                         "in (16, 32, 64, 128)")
    if E % 8 or E > 1024:
        raise ValueError(f"attention_block: E={E} must be a multiple of 8, at most 1024")
    dt = x.dtype
    _build.dtype_code(x)
    ws = [w.to(dt) for w in (wq, bq, wk, bk, wv, bv, wo, bo)]
    for t in ws:
        if t.device != x.device or t.shape[-1] != E:
            raise ValueError("attention_block: weights must be [E, E] and "
                             "biases [E] on the input's device")
    ln_g = ln_b = None
    eps = 0.0
    if ln is not None:
        # 16-byte aligned: the LayerNorm backward reads them in 16-byte chunks
        ln_g, ln_b, eps = aligned16(ln[0].to(dt)), aligned16(ln[1].to(dt)), float(ln[2])
    seed = _seed_tensor(dropout_seed, x.device) if rate else None
    return AttentionBlockFn.apply(x.contiguous(), *ws, ln_g, ln_b, seed, num_heads,
                                  eps, bool(residual), rate)


def attention_block_bwd():
    """Launch counter of the backward chain (``AttentionBlockFn.backward``)."""


attention_block.launches = 0
attention_block_bwd.launches = 0
