"""Flash attention: softmax(q·kᵀ/√D + bias)·v for q [B, Sq, H, D] and k, v
[B, Sk, H, D], without a [B, H, Sq, Sk] tensor in device memory.

Replaces the TPU kernels of simple_multimodal_tpu/ops/pallas/flash_attention.py:
the forward (``_fwd_kernel`` via ``_flash_forward``) and the backward
(``_bwd_dkv_kernel`` and ``_bwd_dq_kernel`` via ``_flash_backward``). On a
CUDA tensor the wrapper runs ``FlashAttentionFn``, whose forward enters
``csrc/flash_attention.cu`` and whose backward enters
``csrc/flash_attention_bwd.cu``; on a CPU tensor it runs
``flash_attention_plain`` and autograd differentiates it.

The body is picked from the element type and the head width alone, in the
C entry points; no argument or environment variable changes it:

- bf16 at D = 64, 96, 128 (the long-clip path is 8 heads of 96): the wgmma
  kernels ``csrc/flash_attention_wgmma.cu``,
  ``flash_attention_bwd_dq_wgmma.cu`` and ``flash_attention_bwd_dkv_wgmma.cu``
  on the building blocks of ``csrc/hopper.cuh``. Bound by operations
  (4·Sq·Sk·D FLOP forward, 10 backward, per batch and head); every product is
  a warpgroup ``wgmma`` on 64 rows, the softmax, P and dS stay in the
  accumulator registers and feed the next product as its A operand, and K/V
  (or Q/dO) tiles arrive by TMA through a two-stage mbarrier ring fed by a
  producer warp. q, k, v and dout are read in place through tensor maps
  built per call from their batch and token strides (``_rows`` guarantees
  the 16-byte alignment the maps need). The bias is read with a key stride
  of 1 (``_kernel_bias``).
- bf16 at D = 16, 32: the WMMA bodies; f32 at any width and D = 4, 8 in any
  type: the exact FMA bodies (the 1e-3 checks and the tiny preset).

Masks are finite: a masked key carries a bias of -1e30 (as the JAX package
builds them), never -inf. A row whose every key is masked that way attends
uniformly over its Sk keys, in the plain version and in the kernel alike,
and its gradients are those of that uniform softmax. (The TPU kernel's
backward recomputes such a row's probabilities as 1 instead of 1/Sk: its
saved logsumexp −1e30 + log Sk rounds to −1e30 in f32.)
"""
import ctypes
import math
from typing import Optional

import torch

from . import _build

HEAD_WIDTHS = (4, 8, 16, 32, 64, 96, 128)  # 4 and 8: the tiny preset's heads


def flash_attention_plain(q, k, v, bias: Optional[torch.Tensor] = None):
    """Plain PyTorch version: f32 scores and softmax, the probabilities
    rounded to q's dtype before ·V, as the TPU kernel rounds them."""
    D = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(D)
    if bias is not None:
        s = s + bias.float()
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float()).to(q.dtype)


def _rows(t: torch.Tensor) -> torch.Tensor:
    """A [B, S, H, D] tensor the kernels can read in place: each token's
    H·D values dense, no batch or token axis broadcast, and every row
    16-byte aligned (the WMMA bodies' vector loads and the wgmma kernels'
    tensor maps need that); else a copy."""
    D = t.shape[-1]
    dense = (t.stride(3) == 1 and t.stride(2) == D
             and all(t.stride(i) > 0 or t.shape[i] == 1 for i in (0, 1)))
    per16 = 16 // t.element_size()
    aligned = (t.stride(0) % per16 == 0 and t.stride(1) % per16 == 0
               and t.data_ptr() % 16 == 0)
    if dense and aligned:
        return t
    return t.clone(memory_format=torch.contiguous_format)  # a fresh, aligned block


WGMMA_WIDTHS = (64, 96, 128)  # bf16 head widths of the wgmma kernels (csrc/flash_attention.cuh)


def _kernel_bias(bias, q, Sk: int):
    """The bias as the kernels of q's (dtype, head width) read it: f32,
    expanded to [B, H, Sq, Sk] through strides (0 on the axes it broadcasts
    over; nothing is materialised). The wgmma kernels read it with a key
    stride of 1: a bias whose key axis is strided or broadcast is copied."""
    if bias is None:
        return None
    B, Sq, H, D = q.shape
    bias_x = bias.detach().float().expand(B, H, Sq, Sk)
    wgmma = q.dtype == torch.bfloat16 and D in WGMMA_WIDTHS
    if wgmma and Sk > 1 and bias_x.stride(3) != 1:
        bias_x = bias_x.contiguous()
    return bias_x


def _strides(*tensors, bias=None):
    """Host int64 array: (batch, token) strides per tensor, then the bias's
    four strides (0 on an axis it broadcasts over)."""
    vals = []
    for t in tensors:
        vals += [t.stride(0), t.stride(1)]
    vals += list(bias.stride()) if bias is not None else [0, 0, 0, 0]
    return (ctypes.c_longlong * len(vals))(*vals)


def _reduce_to(ds: torch.Tensor, shape) -> torch.Tensor:
    """Sum the [B, H, Sq, Sk] score gradient over the axes the bias
    broadcast over (leading axes it lacks, and its axes of size 1)."""
    lead = ds.dim() - len(shape)
    dims = list(range(lead)) + [lead + i for i, n in enumerate(shape)
                                if n == 1 and ds.shape[lead + i] != 1]
    if dims:
        ds = ds.sum(dim=dims, keepdim=True)
    return ds.reshape(shape)


class FlashAttentionFn(torch.autograd.Function):
    """The CUDA forward and backward. Saves q, k, v, the bias, the output
    and each row's softmax maximum and sum (together the logsumexp); the
    backward recomputes the probabilities from them."""

    @staticmethod
    def forward(ctx, q, k, v, bias):
        B, Sq, H, D = q.shape
        Sk = k.shape[1]
        lib = _build.library()
        q, k, v = _rows(q), _rows(k), _rows(v)
        bias_x = _kernel_bias(bias, q, Sk)
        out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
        stats = torch.empty((2, B, H, Sq), dtype=torch.float32, device=q.device)
        p = _build.ptr
        err = lib.smm_flash_attention(
            _build.dtype_code(q), p(q), p(k), p(v), p(out), p(stats), p(bias_x),
            _strides(q, k, v, out, bias=bias_x), B, Sq, Sk, H, D, _build.stream_ptr(q))
        _build.check(lib, err, "flash_attention")
        flash_attention.launches += 1
        ctx.save_for_backward(q, k, v, bias, out, stats)
        return out

    @staticmethod
    def backward(ctx, gy):
        q, k, v, bias, out, stats = ctx.saved_tensors
        B, Sq, H, D = q.shape
        Sk = k.shape[1]
        dev, f32 = q.device, torch.float32
        lib = _build.library()
        gy = _rows(gy.to(q.dtype))
        bias_x, ds = _kernel_bias(bias, q, Sk), None
        if bias is not None and ctx.needs_input_grad[3]:
            ds = torch.empty((B, H, Sq, Sk), dtype=f32, device=dev)
        delta = torch.empty((B, H, Sq), dtype=f32, device=dev)
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        p = _build.ptr
        err = lib.smm_flash_attention_bwd(
            _build.dtype_code(q), p(q), p(k), p(v), p(out), p(gy), p(stats), p(bias_x),
            p(delta), p(dq), p(dk), p(dv), p(ds),
            _strides(q, k, v, out, gy, dq, dk, dv, bias=bias_x), B, Sq, Sk, H, D,
            _build.stream_ptr(q))
        _build.check(lib, err, "flash_attention_bwd")
        flash_attention_bwd.launches += 1
        dbias = None if ds is None else _reduce_to(ds, bias.shape).to(bias.dtype)
        return dq, dk, dv, dbias


def flash_attention(q, k, v, bias: Optional[torch.Tensor] = None):
    """softmax(q·kᵀ/√D + bias)·v, differentiable in q, k, v and bias; the
    JAX ``flash_attention``'s signature and layout.

    q [B, Sq, H, D], k/v [B, Sk, H, D], bias broadcastable to
    [B, H, Sq, Sk] or None; returns [B, Sq, H, D] in q's dtype; the scale
    is 1/√D. CPU tensors run the plain version; CUDA tensors launch the
    kernels (forward, and backward under autograd) or raise.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, bias)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention: no kernel for device {q.device}")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError("flash_attention: q [B, Sq, H, D] and k, v [B, Sk, H, D]")
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    if (k.shape[0], k.shape[2], k.shape[3]) != (B, H, D):
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if D not in HEAD_WIDTHS:
        raise ValueError(f"flash_attention: head width {D} not in {HEAD_WIDTHS}")
    _build.dtype_code(q)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k and v must share one dtype")
    for t in (k, v, bias):
        if t is not None and t.device != q.device:
            raise ValueError("flash_attention: every input must be on q's device")
    if bias is not None:
        if torch.broadcast_shapes(bias.shape, (B, H, Sq, Sk)) != (B, H, Sq, Sk):
            raise ValueError(f"flash_attention: bias {tuple(bias.shape)} does not "
                             f"broadcast to {(B, H, Sq, Sk)}")
    return FlashAttentionFn.apply(q, k, v, bias)


def flash_attention_bwd():
    """Launch counter of the backward (``FlashAttentionFn.backward``)."""


flash_attention.launches = 0
flash_attention_bwd.launches = 0
