"""Fused transformer FFN block: [pre-LN ->] x@W1+b1 -> GELU -> @W2+b2 [+x]
[-> post-LN], over hidden states x [B, S, E].

Replaces the TPU kernel simple_multimodal_tpu/ops/pallas/ffn_block.py
(``_kernel`` via ``_fused_call``). On a CUDA tensor the wrapper launches
the hand-written chain in ``csrc/ffn_block.cu`` (LN row kernel, two
tensor-core GEMMs with bias/GELU and bias/residual epilogues, LN); on a CPU
tensor it runs ``ffn_block_plain``, the port of that file's
``_xla_reference``. In this version the [rows, F] intermediate round-trips
device memory between the two GEMMs (see the .cu source).

LayerNorm placement covers the three encoders: pre-LN + residual (ViT),
post-LN of the residual sum (DeBERTa, wav2vec2), or none. GELU is
erf-exact in f32 and the tanh form in bf16, as in the JAX package.
"""
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build


def ffn_block_plain(x, w1, b1, w2, b2, ln: Optional[tuple] = None,
                    ln_post: bool = False, residual: bool = True):
    """Plain PyTorch version: the same math as the JAX ``_xla_reference``.
    Both matmuls accumulate in f32 (the reference's
    preferred_element_type), the intermediate is rounded to x's dtype."""
    f32 = torch.float32
    E = x.shape[-1]
    approximate = "tanh" if x.dtype == torch.bfloat16 else "none"
    xf = x.float()
    if ln is not None and not ln_post:
        g, b, eps = ln
        xin = F.layer_norm(xf, (E,), g.float(), b.float(), eps).to(x.dtype)
    else:
        xin = x
    h = xin.to(f32) @ w1.to(f32) + b1.to(f32)
    h = F.gelu(h, approximate=approximate).to(x.dtype)
    y = h.to(f32) @ w2.to(f32) + b2.to(f32)
    if residual:
        y = y + xf
    if ln is not None and ln_post:
        g, b, eps = ln
        y = F.layer_norm(y, (E,), g.float(), b.float(), eps)
    return y.to(x.dtype)


def ffn_block(x, w1, b1, w2, b2, ln: Optional[tuple] = None,
              ln_post: bool = False, residual: bool = True):
    """Fused FFN block over x [B, S, E]; same arguments and layouts as the
    JAX ``ffn_block`` (w1 [E, F], b1 [F], w2 [F, E], b2 [E]).
    ``ln=(scale, bias, eps)``: pre-LN when ``ln_post`` is False, post-LN of
    the residual sum when True.

    CPU tensors run the plain version; CUDA tensors launch the kernel or
    raise. Returns [B, S, E] in x's dtype.
    """
    if x.device.type == "cpu":
        return ffn_block_plain(x, w1, b1, w2, b2, ln=ln, ln_post=ln_post,
                               residual=residual)
    if x.device.type != "cuda":
        raise RuntimeError(f"ffn_block: no kernel for device {x.device}")
    E = x.shape[-1]
    Fdim = w1.shape[1]
    if E % 8 or Fdim % 8:
        raise ValueError(f"ffn_block: E={E} and F={Fdim} must be multiples of 8")
    if w1.shape != (E, Fdim) or w2.shape != (Fdim, E):
        raise ValueError(f"ffn_block: expected w1 [{E}, F] and w2 [F, {E}], "
                         f"got {tuple(w1.shape)} and {tuple(w2.shape)}")
    dt = x.dtype
    code = _build.dtype_code(x)
    lib = _build.library()
    x = x.contiguous()
    M = x.numel() // E
    w1t = w1.to(dt).t().contiguous()
    w2t = w2.to(dt).t().contiguous()
    b1c = b1.to(dt).contiguous()
    b2c = b2.to(dt).contiguous()
    ln_mode, ln_g, ln_b, eps = 0, None, None, 0.0
    xn = y32 = None
    if ln is not None:
        ln_mode = 2 if ln_post else 1
        ln_g = ln[0].to(dt).contiguous()
        ln_b = ln[1].to(dt).contiguous()
        eps = float(ln[2])
        if ln_post:
            y32 = torch.empty((M, E), dtype=torch.float32, device=x.device)
        else:
            xn = torch.empty((M, E), dtype=dt, device=x.device)
    h = torch.empty((M, Fdim), dtype=dt, device=x.device)
    out = torch.empty_like(x)
    p = _build.ptr
    err = lib.smm_ffn_block(
        code, p(x), p(w1t), p(b1c), p(w2t), p(b2c), p(ln_g), p(ln_b), eps,
        ln_mode, int(residual), M, E, Fdim, p(xn), p(h), p(y32), p(out),
        _build.stream_ptr(x))
    _build.check(lib, err, "ffn_block")
    ffn_block.launches += 1
    return out


ffn_block.launches = 0
