"""Fused transformer FFN block: [pre-LN ->] x@W1+b1 -> GELU [-> drop] ->
@W2+b2 [-> drop] [+x] [-> post-LN], over hidden states x [B, S, E].

Replaces the TPU kernels of simple_multimodal_tpu/ops/pallas/ffn_block.py:
the forward (``_kernel`` via ``_fused_call``) and the backward
(``_bwd_kernel`` via ``_ffn_bwd``). On a CUDA tensor the wrapper runs
``FFNBlockFn``: its forward launches the chain in ``csrc/ffn_block.cu``
(LN row kernel, two tensor-core GEMMs with bias/GELU/dropout and
bias/dropout/residual epilogues, LN; in bf16 at the base widths both GEMMs
are the wgmma/TMA kernel of ``csrc/gemm_wgmma.cu``), its backward the chain in
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
from .gemm import aligned16, gelu_grad

STRIP = 128  # rows of the two-product kernel's block tile: one db1 partial per strip


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


def ffn_bwd_route(dtype: torch.dtype, E: int, Fd: int) -> int:
    """Which chain ``FFNBlockFn.backward`` runs, as ``ffn_bwd_wgmma_takes``
    (``csrc/ffn_block_bwd_wgmma.cuh``) decides it and ``smm_ffn_bwd_route``
    reports it: 1 for the wgmma chain (bf16, E a multiple of 64 and F of 128,
    the two-product kernel's tile: every base-width site), 0 for the chain of
    ``csrc/gemm.cuh``'s kernels (f32, the tiny preset's widths, other F)."""
    return int(dtype == torch.bfloat16 and 0 < E <= 1024 and Fd > 0
               and E % 64 == 0 and Fd % 128 == 0)


def ffn_bwd_part_floats(route: int, M: int, E: int, Fd: int) -> int:
    """Floats of the backward's partials buffer: the LayerNorm backward's
    [row blocks, 2E] and, on the wgmma chain, db1's [strips, F] and db2's
    [row blocks, E] after it (``run_wgmma`` in ``csrc/ffn_block_bwd.cu``)."""
    blocks = _build.row_partition(M)[1]
    ln = blocks * 2 * E
    return ln + -(-M // STRIP) * Fd + blocks * E if route else ln


def fold_columns(part: torch.Tensor) -> torch.Tensor:
    """``fold_columns_kernel`` (``csrc/gemm.cuh``) in PyTorch, in its order:
    part [rows, C] f32 → [C], eight contiguous eighths of the rows each
    summed in row order, then the eight sums in order."""
    rows = part.shape[0]
    sums = []
    for w in range(8):
        s = torch.zeros(part.shape[1], dtype=torch.float32, device=part.device)
        for r in range(rows * w // 8, rows * (w + 1) // 8):
            s = s + part[r]
        sums.append(s)
    out = sums[0]
    for s in sums[1:]:
        out = out + s
    return out


def strip_partials(v: torch.Tensor) -> torch.Tensor:
    """db1's partials as the two-product kernel leaves them: [M, F] →
    [ceil(M / 128), F], the column sums of each 128-row strip."""
    M, C = v.shape
    pad = torch.zeros((-M % STRIP, C), dtype=v.dtype, device=v.device)
    return torch.cat([v, pad]).reshape(-1, STRIP, C).sum(1)


def row_block_partials(v: torch.Tensor) -> torch.Tensor:
    """The partials of the row kernels (LayerNorm backward, drop_cast_sum):
    [M, C] → [row blocks, C], the column sums of each block's contiguous
    rows (``_build.row_partition``)."""
    per, blocks = _build.row_partition(v.shape[0])
    return torch.stack([v[b * per:(b + 1) * per].sum(0) for b in range(blocks)])


def _ln_bwd_rows(dy, x, g, eps):
    """The LayerNorm backward of the row kernel on f32 rows: (dx, dln [2, E])
    with dln the fold of its per-block partials."""
    E = x.shape[1]
    xc = x - x.mean(1, keepdim=True)
    rstd = torch.rsqrt((xc * xc).mean(1, keepdim=True) + eps)
    xh, dh = xc * rstd, dy * g
    dx = rstd * (dh - dh.mean(1, keepdim=True) - xh * (dh * xh).mean(1, keepdim=True))
    part = row_block_partials(torch.cat([dy * xh, dy], 1))
    return dx, fold_columns(part).reshape(2, E)


def ffn_block_bwd_plain(x, w1, b1, w2, b2, gy, ln: Optional[tuple] = None,
                        ln_post: bool = False, residual: bool = True,
                        dropout_rate_mid: float = 0.0, dropout_rate_out: float = 0.0,
                        dropout_seed=None):
    """The wgmma chain of ``csrc/ffn_block_bwd.cu`` step by step in PyTorch,
    in f32 with x's dtype where the chain rounds: (dx, dw1, db1, dw2, db2,
    dln_g, dln_b), the bias and LayerNorm gradients folded from the kernels'
    partials (``strip_partials``, ``row_block_partials``, ``fold_columns``).
    Same arguments as ``ffn_block`` plus the cotangent ``gy``."""
    f32, dt = torch.float32, x.dtype
    B, S, E = x.shape
    Fd, M = w1.shape[1], B * S
    tanh = dt == torch.bfloat16

    def drop(v, salt, rate):
        if not rate:
            return v
        keep = ffn_keep(dropout_seed, salt, B, S, v.shape[1], rate, device=x.device)
        return apply_keep(v, keep.reshape(M, -1), rate)

    def gelu(v):
        return F.gelu(v, approximate="tanh" if tanh else "none")

    xf, g = x.reshape(M, E).float(), gy.reshape(M, E).to(dt).float()
    w1f, b1f, w2f, b2f = w1.to(dt).float(), b1.to(dt).float(), w2.to(dt).float(), b2.to(dt).float()
    lg, lb, eps = (ln[0].to(dt).float(), ln[1].to(dt).float(), ln[2]) if ln is not None else (None,) * 3
    dln = None
    a = xf
    if ln is not None and not ln_post:
        a = F.layer_norm(xf, (E,), lg, lb, eps).to(dt).float()
    dy1 = g
    if ln is not None and ln_post:
        h = drop(gelu(a @ w1f + b1f), SALT_MID, dropout_rate_mid).to(dt).float()
        y = drop(h @ w2f + b2f, SALT_OUT, dropout_rate_out) + (xf if residual else 0.0)
        dy1, dln = _ln_bwd_rows(g, y, lg, eps)
    dy0 = drop(dy1, SALT_OUT, dropout_rate_out)
    db2 = fold_columns(row_block_partials(dy0))
    dy0 = dy0.to(dt).float()
    hpre = a @ w1f + b1f
    h = drop(gelu(hpre), SALT_MID, dropout_rate_mid).to(dt).float()
    dhp = (drop(dy0 @ w2f.t(), SALT_MID, dropout_rate_mid) * gelu_grad(hpre, tanh)).to(dt).float()
    db1 = fold_columns(strip_partials(dhp))
    dxn = dhp @ w1f.t()
    if ln is not None and not ln_post:
        dx, dln = _ln_bwd_rows(dxn, xf, lg, eps)
        dx = dx + g if residual else dx
    else:
        dx = dxn + dy1 if residual else dxn
    out = [dx.reshape(B, S, E), a.t() @ dhp, db1, h.t() @ dy0, db2]
    out += [None, None] if dln is None else [dln[0], dln[1]]
    return tuple(None if t is None else t.to(dt) for t in out)


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
        x, b1, b2 = aligned16(x), aligned16(b1.contiguous()), aligned16(b2.contiguous())
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
        gy = aligned16(gy.to(dt).contiguous())
        lib = _build.library()
        mode = _ln_mode(ln_g, ln_post)
        route = ffn_bwd_route(dt, E, Fd)

        def empty(shape, dtype=dt, when=True):
            return torch.empty(shape, dtype=dtype, device=dev) if when else None

        xn = empty((M, E), when=mode == 1)
        hpre = empty((M, Fd), f32, when=not route)  # the wgmma chain keeps it in registers
        h, dy0, dhp, dx = empty((M, Fd)), empty((M, E)), empty((M, Fd)), empty((M, E))
        y32 = empty((M, E), f32, when=mode == 2)
        dxn = empty((M, E), f32, when=mode == 1)
        part = empty((ffn_bwd_part_floats(route, M, E, Fd),), f32, when=bool(route or mode))
        dsum = empty((2 * E + (Fd + E if route else 0),), f32, when=bool(route or mode))
        # operands referenced until the launch: torch layout (the model's own, no
        # copy there) for the recompute and, on the wgmma chain, for both
        # products of the two-product kernel (W2 read MN-major); flax layout
        # (K-major) for dxn and, on the gemm.cuh chain, dh
        w1t, w2t, w1f = _flax_t(w1), _flax_t(w2), aligned16(w1.contiguous())
        w2f = None if route else aligned16(w2.contiguous())
        p = _build.ptr
        err = lib.smm_ffn_block_bwd(
            _build.dtype_code(x), p(x), p(gy), p(w1t), p(b1), p(w2t),
            p(b2), p(w1f), p(w2f), p(ln_g), p(ln_b), eps, mode,
            int(residual), M, E, Fd, S, p(seed),
            threshold(rate_mid), _drop_scale(rate_mid), int(rate_mid > 0),
            threshold(rate_out), _drop_scale(rate_out), int(rate_out > 0),
            p(xn), p(hpre), p(h), p(y32), p(dy0), p(dhp), p(dxn), p(dx), p(part),
            p(dsum), _build.stream_ptr(x))
        _build.check(lib, err, "ffn_block_bwd")
        ffn_block_bwd.launches += 1
        # weight grads: (B, S)-contractions outside the kernel, as in the JAX
        # _ffn_bwd; the bias sums are the chain's folds on the wgmma chain
        xin = xn if mode == 1 else x.reshape(M, E)
        dw1 = (xin.t() @ dhp).to(w1.dtype)
        dw2 = (h.t() @ dy0).to(w2.dtype)
        if route:
            db1, db2 = dsum[2 * E:2 * E + Fd], dsum[2 * E + Fd:]
        else:
            db1, db2 = dhp.float().sum(0), dy0.float().sum(0)
        dln_g = dsum[:E].to(ln_g.dtype) if mode else None
        dln_b = dsum[E:2 * E].to(ln_b.dtype) if mode else None
        return (dx.reshape(B, S, E), dw1, db1.to(b1.dtype), dw2, db2.to(b2.dtype), dln_g, dln_b,
                None, None, None, None, None, None)


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
        # 16-byte aligned: the LayerNorm backward reads them in 16-byte chunks
        ln_g, ln_b, eps = aligned16(ln[0].to(dt)), aligned16(ln[1].to(dt)), float(ln[2])
    seed = _seed_tensor(dropout_seed, x.device) if (rate_mid or rate_out) else None
    return FFNBlockFn.apply(x.contiguous(), w1.to(dt), b1.to(dt), w2.to(dt), b2.to(dt),
                            ln_g, ln_b, seed, eps, bool(ln_post), bool(residual),
                            rate_mid, rate_out)


def ffn_block_bwd():
    """Launch counter of the backward chain (``FFNBlockFn.backward``)."""


ffn_block.launches = 0
ffn_block_bwd.launches = 0
