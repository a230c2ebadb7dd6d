"""Fused transformer FFN block: [pre-LN ->] x@W1+b1 -> GELU [-> drop] ->
@W2+b2 [-> drop] [+x] [-> post-LN], over hidden states x [B, S, E].

Replaces the TPU kernels of simple_multimodal_tpu/ops/pallas/ffn_block.py:
the forward (``_kernel`` via ``_fused_call``) and the backward
(``_bwd_kernel`` via ``_ffn_bwd``). On a CUDA tensor the wrapper runs
``FFNBlockFn``: its forward launches the chain in ``csrc/ffn_block.cu``
(LN row kernel, two tensor-core GEMMs with bias/GELU/dropout and
bias/dropout/residual epilogues, LN), its backward the chain in
``csrc/ffn_block_bwd.cu``. On a CPU tensor it runs ``ffn_block_plain``, the
port of that file's ``_xla_reference``, and autograd differentiates it.

LayerNorm placement covers the three encoders: pre-LN + residual (ViT),
post-LN of the residual sum (DeBERTa, wav2vec2), or none. GELU is
erf-exact in f32 and the tanh form in bf16, as in the JAX package. The two
dropouts use the FFN scheme of ``dropout.ffn_keep`` over (b, s, column);
the kernels see rows flattened to B·S and are told S to recover (b, s).
"""
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build
from .attention_block import _drop_scale, _flax_t, _seed_tensor
from .dropout import SALT_MID, SALT_OUT, apply_keep, ffn_keep, threshold


def ffn_block_plain(x, w1, b1, w2, b2, ln: Optional[tuple] = None,
                    ln_post: bool = False, residual: bool = True,
                    dropout_rate_mid: float = 0.0, dropout_rate_out: float = 0.0,
                    dropout_seed=None):
    """Plain PyTorch version: the same math as the JAX ``_xla_reference``.
    Both matmuls accumulate in f32 (the reference's
    preferred_element_type), the intermediate is rounded to x's dtype after
    its dropout; the output dropout acts on the f32 sum before the
    residual."""
    f32 = torch.float32
    B, S, E = x.shape
    approximate = "tanh" if x.dtype == torch.bfloat16 else "none"
    xf = x.float()
    if ln is not None and not ln_post:
        g, b, eps = ln
        xin = F.layer_norm(xf, (E,), g.float(), b.float(), eps).to(x.dtype)
    else:
        xin = x
    h = xin.to(f32) @ w1.to(f32) + b1.to(f32)
    h = F.gelu(h, approximate=approximate)
    if dropout_rate_mid:
        h = apply_keep(h, ffn_keep(dropout_seed, SALT_MID, B, S, h.shape[-1],
                                   dropout_rate_mid, device=x.device), dropout_rate_mid)
    h = h.to(x.dtype)
    y = h.to(f32) @ w2.to(f32) + b2.to(f32)
    if dropout_rate_out:
        y = apply_keep(y, ffn_keep(dropout_seed, SALT_OUT, B, S, E, dropout_rate_out,
                                   device=x.device), dropout_rate_out)
    if residual:
        y = y + xf
    if ln is not None and ln_post:
        g, b, eps = ln
        y = F.layer_norm(y, (E,), g.float(), b.float(), eps)
    return y.to(x.dtype)


def _ln_mode(ln_g, ln_post: bool) -> int:
    return 0 if ln_g is None else (2 if ln_post else 1)


class FFNBlockFn(torch.autograd.Function):
    """The CUDA forward and backward of the FFN block. Saves only the
    inputs; the backward recomputes LN and the pre-activation, as the TPU
    kernel does."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, ln_g, ln_b, seed, eps, ln_post, residual,
                rate_mid, rate_out):
        B, S, E = x.shape
        Fd = w1.shape[1]
        M = B * S
        dt, dev = x.dtype, x.device
        lib = _build.library()
        mode = _ln_mode(ln_g, ln_post)
        xn = torch.empty((M, E), dtype=dt, device=dev) if mode == 1 else None
        y32 = torch.empty((M, E), dtype=torch.float32, device=dev) if mode == 2 else None
        h = torch.empty((M, Fd), dtype=dt, device=dev)
        out = torch.empty_like(x)
        w1t, w2t = _flax_t(w1), _flax_t(w2)  # referenced until the launch
        p = _build.ptr
        err = lib.smm_ffn_block(
            _build.dtype_code(x), p(x), p(w1t), p(b1), p(w2t), p(b2),
            p(ln_g), p(ln_b), eps, mode, int(residual), M, E, Fd, S,
            p(seed), threshold(rate_mid),
            _drop_scale(rate_mid), int(rate_mid > 0), threshold(rate_out),
            _drop_scale(rate_out), int(rate_out > 0), p(xn), p(h), p(y32), p(out),
            _build.stream_ptr(x))
        _build.check(lib, err, "ffn_block")
        ffn_block.launches += 1
        ctx.save_for_backward(x, w1, b1, w2, b2, ln_g, ln_b, seed)
        ctx.cfg = (eps, ln_post, residual, rate_mid, rate_out)
        return out

    @staticmethod
    def backward(ctx, gy):
        x, w1, b1, w2, b2, ln_g, ln_b, seed = ctx.saved_tensors
        eps, ln_post, residual, rate_mid, rate_out = ctx.cfg
        B, S, E = x.shape
        Fd = w1.shape[1]
        M = B * S
        dt, dev, f32 = x.dtype, x.device, torch.float32
        gy = gy.to(dt).contiguous()
        lib = _build.library()
        mode = _ln_mode(ln_g, ln_post)
        xn = torch.empty((M, E), dtype=dt, device=dev) if mode == 1 else None
        hpre = torch.empty((M, Fd), dtype=f32, device=dev)
        h = torch.empty((M, Fd), dtype=dt, device=dev)
        y32 = torch.empty((M, E), dtype=f32, device=dev) if mode == 2 else None
        dy0 = torch.empty((M, E), dtype=dt, device=dev)
        dhp = torch.empty((M, Fd), dtype=dt, device=dev)
        dxn = torch.empty((M, E), dtype=f32, device=dev) if mode == 1 else None
        dx = torch.empty((M, E), dtype=dt, device=dev)
        part = (torch.empty((_build.ln_bwd_blocks(M), 2 * E), dtype=f32, device=dev)
                if mode else None)
        dln = torch.empty((2, E), dtype=f32, device=dev) if mode else None
        # operands referenced until the launch: torch layout for the
        # recompute, flax layout (K-major) for dh and dxn
        w1t, w2t, w1f, w2f = _flax_t(w1), _flax_t(w2), w1.contiguous(), w2.contiguous()
        p = _build.ptr
        err = lib.smm_ffn_block_bwd(
            _build.dtype_code(x), p(x), p(gy), p(w1t), p(b1), p(w2t),
            p(b2), p(w1f), p(w2f), p(ln_g), p(ln_b), eps, mode,
            int(residual), M, E, Fd, S, p(seed),
            threshold(rate_mid), _drop_scale(rate_mid), int(rate_mid > 0),
            threshold(rate_out), _drop_scale(rate_out), int(rate_out > 0),
            p(xn), p(hpre), p(h), p(y32), p(dy0), p(dhp), p(dxn), p(dx), p(part),
            p(dln), _build.stream_ptr(x))
        _build.check(lib, err, "ffn_block_bwd")
        ffn_block_bwd.launches += 1
        # weight grads: (B, S)-contractions outside the kernel, as in the JAX
        # _ffn_bwd
        xin = xn if mode == 1 else x.reshape(M, E)
        dw1 = (xin.t() @ dhp).to(w1.dtype)
        db1 = dhp.float().sum(0).to(b1.dtype)
        dw2 = (h.t() @ dy0).to(w2.dtype)
        db2 = dy0.float().sum(0).to(b2.dtype)
        dln_g = dln[0].to(ln_g.dtype) if mode else None
        dln_b = dln[1].to(ln_b.dtype) if mode else None
        return (dx.reshape(B, S, E), dw1, db1, dw2, db2, dln_g, dln_b, None, None,
                None, None, None, None)


def ffn_block(x, w1, b1, w2, b2, ln: Optional[tuple] = None,
              ln_post: bool = False, residual: bool = True,
              dropout_rate_mid: float = 0.0, dropout_rate_out: float = 0.0,
              dropout_seed=None):
    """Fused FFN block over x [B, S, E]; same arguments and layouts as the
    JAX ``ffn_block`` (w1 [E, F], b1 [F], w2 [F, E], b2 [E]).
    ``ln=(scale, bias, eps)``: pre-LN when ``ln_post`` is False, post-LN of
    the residual sum when True. ``dropout_rate_mid`` drops the post-GELU
    intermediate, ``dropout_rate_out`` the output before the residual, by
    the stateless hash of ``dropout_seed``.

    CPU tensors run the plain version; CUDA tensors launch the kernels
    (forward, and backward under autograd) or raise. Returns [B, S, E] in
    x's dtype.
    """
    rate_mid, rate_out = float(dropout_rate_mid), float(dropout_rate_out)
    if (rate_mid or rate_out) and dropout_seed is None:
        raise ValueError("dropout rates > 0 require dropout_seed")
    if x.device.type == "cpu":
        return ffn_block_plain(x, w1, b1, w2, b2, ln=ln, ln_post=ln_post,
                               residual=residual, dropout_rate_mid=rate_mid,
                               dropout_rate_out=rate_out, dropout_seed=dropout_seed)
    if x.device.type != "cuda":
        raise RuntimeError(f"ffn_block: no kernel for device {x.device}")
    E = x.shape[-1]
    Fd = w1.shape[1]
    if E % 8 or Fd % 8 or E > 1024:
        raise ValueError(f"ffn_block: E={E} and F={Fd} must be multiples of 8, E at most 1024")
    if w1.shape != (E, Fd) or w2.shape != (Fd, E):
        raise ValueError(f"ffn_block: expected w1 [{E}, F] and w2 [F, {E}], "
                         f"got {tuple(w1.shape)} and {tuple(w2.shape)}")
    dt = x.dtype
    _build.dtype_code(x)
    ln_g = ln_b = None
    eps = 0.0
    if ln is not None:
        ln_g, ln_b, eps = ln[0].to(dt), ln[1].to(dt), float(ln[2])
    seed = _seed_tensor(dropout_seed, x.device) if (rate_mid or rate_out) else None
    return FFNBlockFn.apply(x.contiguous(), w1.to(dt), b1.to(dt), w2.to(dt), b2.to(dt),
                            ln_g, ln_b, seed, eps, bool(ln_post), bool(residual),
                            rate_mid, rate_out)


def ffn_block_bwd():
    """Launch counter of the backward chain (``FFNBlockFn.backward``)."""


ffn_block.launches = 0
ffn_block_bwd.launches = 0
