"""wav2vec2's positional convolution: the grouped 'same' 1-D convolution of
NWC frames, x [B, L, E] → y [B, L, E] with y[t] = bias + Σ_k x[t + k − K//2]
· W_k per group, frames outside [0, L) read as zeros; for an even K the
trailing extra frame of torch's ``padding=K//2`` is dropped, as the model's
SamePad does.

Replaces no TPU kernel: the JAX package leaves this convolution to XLA
(``simple_multimodal_tpu/models/wav2vec2.py``, ``PositionalConvEmbedding``:
``lax.conv_general_dilated`` with ``feature_group_count``). On a CUDA tensor
the wrapper runs ``GroupedConvSameFn``: its forward launches
``csrc/pos_conv.cu``, its backward the same kernel on the cotangent with the
taps mirrored and transposed per group (the input gradient), cuDNN's
weight-gradient call (``torch.nn.grad.conv1d_weight``) for the weight and a
sum for the bias. On a CPU tensor it runs ``grouped_conv_same_plain``,
``F.conv1d`` on the NCW view. Bounds and design are noted in the .cu
source.
"""
import torch
import torch.nn.functional as F

from . import _build
from .gemm import aligned16

WIDTHS = (16, 32, 48, 64, 96, 128)  # the kernel's wgmma widths (csrc/pos_conv.cu)


def tile_width(cg: int) -> int:
    """The wgmma width a group of ``cg`` channels is padded to (zero weights,
    zero input channels), or 0 where the kernel takes no such group: ``cg``
    not a multiple of 8, or above 128."""
    if cg < 8 or cg % 8:
        return 0
    return next((p for p in WIDTHS if cg <= p), 0)


def grouped_conv_same_plain(x, w, bias, groups: int):
    """Plain PyTorch version: ``F.conv1d`` over the NCW view with
    ``padding=K//2`` and ``groups``, the trailing frame dropped for an even
    K; x [B, L, E], w [E, E/G, K] (torch layout), bias [E] or None."""
    K = w.shape[-1]
    out = F.conv1d(x.transpose(1, 2), w, bias, padding=K // 2, groups=groups)
    if K % 2 == 0:
        out = out[..., :-1]
    return out.transpose(1, 2)


def tap_layout(w, groups: int, backward: bool = False):
    """The weight as the kernel reads it, [G, K, P/8, P, 8] with P =
    ``tile_width(E/G)``: tap k of group g is the P × P matrix whose row n is
    output channel n and whose column c is contracted, stored as P/8 blocks
    of [P][8] (wgmma's no-swizzle layout), zero past the group's width. The
    forward's tap k is W[n, c, k]; the input gradient's is W[c, n, K−1−k]
    (output channel c, contracting over the forward's outputs n)."""
    E, cg, K = w.shape
    G, P = groups, tile_width(cg)
    v = w.reshape(G, cg, cg, K)  # [g, out n, in c, k]
    if backward:
        v = v.flip(3).transpose(1, 2)
    v = F.pad(v, (0, 0, 0, P - cg, 0, P - cg))
    return v.reshape(G, P, P // 8, 8, K).permute(0, 4, 2, 1, 3).contiguous()


def conv_taps_plain(x, taps, bias, groups: int, pad: int):
    """What the kernel computes from ``tap_layout``'s tensor, in plain
    PyTorch: y[t] = bias + Σ_k x[t + k − pad] · tap_kᵀ per group. The CPU
    check of the layout and of the input gradient's mirrored taps."""
    B, L, E = x.shape
    G, K, P = groups, taps.shape[1], taps.shape[3]
    cg = E // G
    m = taps.permute(0, 1, 3, 2, 4).reshape(G, K, P, P)[:, :, :cg, :cg]  # [g, k, n, c]
    xp = F.pad(x.reshape(B, L, G, cg), (0, 0, 0, 0, pad, K - 1 - pad))
    y = sum(torch.einsum("blgc,gnc->blgn", xp[:, k:k + L], m[:, k]) for k in range(K))
    y = y.reshape(B, L, E)
    return y if bias is None else y + bias


def weight_grad(x, dy, w_shape, groups: int):
    """dW of the forward for the cotangent ``dy`` [B, L, E], through cuDNN's
    weight-gradient call on the NCW views (the dropped trailing frame of an
    even K takes a zero cotangent)."""
    K = w_shape[-1]
    gy = F.pad(dy, (0, 0, 0, 1)) if K % 2 == 0 else dy
    return torch.nn.grad.conv1d_weight(x.transpose(1, 2), w_shape, gy.transpose(1, 2),
                                       padding=K // 2, groups=groups)


def _launch(x, taps, bias, groups: int, pad: int):
    B, L, E = x.shape
    K = taps.shape[1]
    lib = _build.library()
    y = torch.empty_like(x)
    b = None if bias is None else bias.float().contiguous()
    p = _build.ptr
    err = lib.smm_pos_conv(_build.dtype_code(x), p(x), p(taps), p(b), p(y), B, L, E, groups,
                           K, pad, _build.stream_ptr(x))
    _build.check(lib, err, "grouped_conv_same")
    return y


def _forward(x, w, bias, groups: int):
    y = _launch(aligned16(x.contiguous()), tap_layout(w, groups), bias, groups,
                w.shape[-1] // 2)
    grouped_conv_same.launches += 1
    return y


class GroupedConvSameFn(torch.autograd.Function):
    """The kernel forward; backward the kernel for dx, cuDNN for dW."""

    @staticmethod
    def forward(ctx, x, w, bias, groups):
        ctx.save_for_backward(x, w)
        ctx.groups = groups
        ctx.bias_dtype = None if bias is None else bias.dtype
        return _forward(x, w, bias, groups)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        G, K = ctx.groups, w.shape[-1]
        dy = aligned16(dy.to(w.dtype).contiguous())
        needs = ctx.needs_input_grad
        dx = dw = db = None
        if needs[0]:
            dx = _launch(dy, tap_layout(w, G, backward=True), None, G, K - 1 - K // 2)
            grouped_conv_same_bwd.launches += 1
        if needs[1]:
            dw = weight_grad(x, dy, w.shape, G)
        if needs[2] and ctx.bias_dtype is not None:
            acc = torch.promote_types(dy.dtype, torch.float32)  # f32 sums for bf16
            db = dy.sum(dim=(0, 1), dtype=acc).to(ctx.bias_dtype)
        return dx, dw, db, None


def grouped_conv_same(x, w, bias, groups: int):
    """The grouped 'same' convolution of NWC frames x [B, L, E] with the
    torch-layout weight w [E, E/G, K] and bias [E] (or None); returns y
    [B, L, E] in x's dtype. CPU tensors run the plain version; CUDA tensors
    launch the kernel (float32 or bfloat16, E/G a multiple of 8 up to 128,
    any K and L), forward and input gradient, or raise. With no gradient to
    record the forward launches without the autograd.Function around it.
    """
    if x.device.type == "cpu":
        return grouped_conv_same_plain(x, w, bias, groups)
    if x.device.type != "cuda":
        raise RuntimeError(f"grouped_conv_same: no kernel for device {x.device}")
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError("grouped_conv_same: x [B, L, E] and w [E, E/G, K]")
    E = x.shape[2]
    if groups < 1 or E % groups or w.shape[:2] != (E, E // groups) or w.shape[2] < 1:
        raise ValueError(f"grouped_conv_same: w {tuple(w.shape)} is not [{E}, {E}/G, K] for "
                         f"G = {groups}")
    cg = E // groups
    if not tile_width(cg):
        raise ValueError(f"grouped_conv_same: C_g = {cg} channels a group is not a multiple "
                         f"of 8 up to 128")
    _build.dtype_code(x)
    if w.dtype != x.dtype:
        raise TypeError(f"grouped_conv_same: x is {x.dtype}, w {w.dtype}")
    for t in (w, bias):
        if t is not None and t.device != x.device:
            raise ValueError("grouped_conv_same: every input must be on x's device")
    if bias is not None and bias.shape != (E,):
        raise ValueError(f"grouped_conv_same: bias must be [{E}]")
    if not (torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                            for t in (x, w, bias))):
        return _forward(x, w, bias, int(groups))
    return GroupedConvSameFn.apply(x, w, bias, int(groups))


def grouped_conv_same_bwd():
    """Launch counter of ``GroupedConvSameFn``'s backward kernel (one per
    backward call that needs the input gradient)."""


grouped_conv_same.launches = 0
grouped_conv_same_bwd.launches = 0
