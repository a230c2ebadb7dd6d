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
from .dropout import apply_keep, attention_keep, drop_scale, seed_tensor, threshold
from .gemm import aligned16


def attention_block_plain(x, w_qkv, b_qkv, wo, bo, num_heads: int,
                          ln: Optional[tuple] = None, residual: bool = False,
                          dropout_rate: float = 0.0, dropout_seed=None):
    """Plain PyTorch version: the same math as the JAX ``_xla_reference``.

    Same arguments as ``attention_block``; ``ln=(scale, bias, eps)``
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
    q, k, v = ((xn @ w.t() + b).reshape(B, S, H, D)
               for w, b in zip(w_qkv.split(E), b_qkv.split(E)))
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(D)
    p = torch.softmax(s, dim=-1)
    if dropout_rate:
        p = apply_keep(p, attention_keep(dropout_seed, B, H, S, S, dropout_rate,
                                         device=x.device), dropout_rate)
    p = p.to(x.dtype)
    ctx = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, S, E)
    out = (ctx @ wo.t() + bo).float()
    if residual:
        out = out + x.float()
    return out.to(x.dtype)


class AttentionBlockFn(torch.autograd.Function):
    """The CUDA forward and backward of the block. Saves only the inputs:
    the backward recomputes LN, q/k/v and the probabilities, as the TPU
    kernel does."""

    @staticmethod
    def forward(ctx, x, w_qkv, b_qkv, wo, bo, ln_g, ln_b, seed, num_heads, eps, residual, rate):
        B, S, E = x.shape
        dt = x.dtype
        lib = _build.library()
        x = aligned16(x)
        M = B * S
        xn = torch.empty((M, E), dtype=dt, device=x.device) if ln_g is not None else None
        qkv = torch.empty((M, 3 * E), dtype=dt, device=x.device)
        cbuf = torch.empty((M, E), dtype=dt, device=x.device)
        out = torch.empty_like(x)
        # q, k and v are row blocks of the packed weight and bias (16-byte
        # aligned: E is a multiple of 8)
        wq, wk, wv = w_qkv.split(E)
        bq, bk, bv = b_qkv.split(E)
        p = _build.ptr
        err = lib.smm_attention_block(
            _build.dtype_code(x), p(x), p(wq), p(bq), p(wk), p(bk), p(wv), p(bv), p(wo), p(bo),
            p(ln_g), p(ln_b), eps, int(residual), B, S, E, num_heads, p(seed),
            threshold(rate), drop_scale(rate), p(xn), p(qkv), p(cbuf), p(out),
            _build.stream_ptr(x))
        _build.check(lib, err, "attention_block")
        attention_block.launches += 1
        ctx.save_for_backward(x, w_qkv, b_qkv, wo, ln_g, ln_b, seed)
        ctx.cfg = (num_heads, eps, residual, rate)
        return out

    @staticmethod
    def backward(ctx, gy):
        x, w_qkv, b_qkv, wo, ln_g, ln_b, seed = ctx.saved_tensors
        num_heads, eps, residual, rate = ctx.cfg
        B, S, E = x.shape
        M = B * S
        dt, dev = x.dtype, x.device
        gy = aligned16(gy.to(dt).contiguous())  # the LayerNorm backward reads 16-byte rows
        lib = _build.library()
        wq, wk, wv = w_qkv.split(E)
        bq, bk, bv = b_qkv.split(E)
        # dxn = dqkv·W_qkv and da = gy·Wo read the weights as their GEMM
        # operand [N, K] (K-major), which is the transpose: one copy each
        w_qkv_t, wo_t = w_qkv.t().contiguous(), wo.t().contiguous()
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
            _build.dtype_code(x), p(x), p(gy), p(wq), p(bq), p(wk), p(bk), p(wv), p(bv),
            p(w_qkv_t), p(wo_t), p(ln_g), p(ln_b), eps,
            int(residual), B, S, E, num_heads, p(seed),
            threshold(rate), drop_scale(rate), p(xn), p(qkv), p(da), p(a),
            p(stats), p(dqkv), p(dxn), p(dx), p(part), p(dln), _build.stream_ptr(x))
        _build.check(lib, err, "attention_block_bwd")
        attention_block_bwd.launches += 1
        # weight grads: (B, S)-contractions outside the kernel, as in the JAX
        # _block_bwd
        xin = xn if has_ln else x.reshape(M, E)
        g2 = gy.reshape(M, E)
        dw_qkv = (dqkv.t() @ xin).to(w_qkv.dtype)
        db_qkv = dqkv.float().sum(0).to(b_qkv.dtype)
        dwo = (g2.t() @ a).to(wo.dtype)
        dbo = g2.float().sum(0).to(b_qkv.dtype)
        dln_g = dln[0].to(ln_g.dtype) if has_ln else None
        dln_b = dln[1].to(ln_b.dtype) if has_ln else None
        return (dx.reshape(B, S, E), dw_qkv, db_qkv, dwo, dbo, dln_g, dln_b,
                None, None, None, None, None)


def attention_block(x, w_qkv, b_qkv, wo, bo, num_heads: int,
                    ln: Optional[tuple] = None, residual: bool = False,
                    dropout_rate: float = 0.0, dropout_seed=None):
    """Fused attention block over x [B, S, E]: q|k|v packed as ``w_qkv``
    [3E, E] and ``b_qkv`` [3E], the out-projection ``wo`` [E, E] and ``bo``
    [E], weights in torch ``nn.Linear`` layout. ``dropout_rate`` > 0 drops
    attention probabilities by the stateless hash of ``dropout_seed`` (an
    int32 scalar or [1] tensor).

    CPU tensors run the plain version; CUDA tensors launch the kernels
    (forward, and backward under autograd) or raise. Returns [B, S, E] in
    x's dtype.
    """
    rate = float(dropout_rate)
    if rate and dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed")
    if x.device.type == "cpu":
        return attention_block_plain(x, w_qkv, b_qkv, wo, bo, num_heads, ln=ln,
                                     residual=residual, dropout_rate=rate,
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
    # 16-byte aligned: the wgmma GEMM reads the weights through TMA tensor maps
    ws = [aligned16(w.to(dt).contiguous()) for w in (w_qkv, b_qkv, wo, bo)]
    shapes = ((3 * E, E), (3 * E,), (E, E), (E,))
    if any(t.device != x.device or tuple(t.shape) != s for t, s in zip(ws, shapes)):
        raise ValueError(f"attention_block: expected w_qkv [{3 * E}, {E}], b_qkv [{3 * E}], "
                         f"wo [{E}, {E}] and bo [{E}] on the input's device")
    ln_g = ln_b = None
    eps = 0.0
    if ln is not None:
        # 16-byte aligned: the LayerNorm backward reads them in 16-byte chunks
        ln_g, ln_b, eps = aligned16(ln[0].to(dt)), aligned16(ln[1].to(dt)), float(ln[2])
    seed = seed_tensor(dropout_seed, x.device) if rate else None
    return AttentionBlockFn.apply(x.contiguous(), *ws, ln_g, ln_b, seed, num_heads,
                                  eps, bool(residual), rate)


def attention_block_bwd():
    """Launch counter of the backward chain (``AttentionBlockFn.backward``)."""


attention_block.launches = 0
attention_block_bwd.launches = 0
