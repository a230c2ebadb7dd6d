"""The GEMM with a fused epilogue that ``ffn_block`` and ``attention_block``
chain, on its own:

    out[M, N] = drop(act(a[M, K] @ w[N, K]ᵀ + bias)) · gelu'(aux) + res

``gemm`` launches ``smm_gemm`` (``csrc/gemm_wgmma.cu``) on bf16 CUDA tensors:
the wgmma/TMA kernel where ``gemm_route`` says so, the WMMA kernel of
``csrc/gemm.cuh`` otherwise. ``chip_smoke.py`` and the GPU tests hold it
against ``gemm_plain``; the blocks' C chains call the same ``launch_gemm``
directly. ``gemm_linear`` is a bias-free linear layer on it whose backward's
two products run on it too (over transposed copies of the operands): the
DeepSeek text tower's projections, dense FFN and shared experts
(``models/deepseek.py``) go through it. ``accumulator_owner`` mirrors the register layout of a wgmma
accumulator, in which the kernel's epilogue and the attention core's
dropout address their elements.
"""
import math
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build
from .dropout import apply_keep, ffn_keep, threshold

ACTS = {"none": 0, "gelu_erf": 1, "gelu_tanh": 2, "dgelu_erf": 3, "dgelu_tanh": 4}
SMS = 132  # the H100's streaming multiprocessors


def gemm_route(M: int, N: int, K: int, lda: Optional[int] = None, ldw: Optional[int] = None,
               aligned: bool = True, sms: int = SMS) -> int:
    """Which kernel a bf16 product of these shapes runs, as
    ``gemm_wgmma_takes`` and ``gemm_wgmma_tile_n`` (``csrc``) decide it: 0
    for the WMMA kernel, else the tile width (64 or 128) of the wgmma
    kernel. The wgmma kernel needs N and K in multiples of 64, row strides
    in multiples of 8 elements and 16-byte aligned bases (``aligned``); it
    takes 128-column tiles unless 64-column ones cut the busiest SM's share
    of the tiles by an eighth or more, or N is no multiple of 128."""
    lda = K if lda is None else lda
    ldw = K if ldw is None else ldw
    if not (aligned and N > 0 and K > 0 and N % 64 == 0 and K % 64 == 0
            and lda % 8 == 0 and ldw % 8 == 0):
        return 0
    if N % 128:
        return 64
    t128 = -(-M // 128) * (N // 128)
    wide, narrow = -(-t128 // sms) * 2, -(-2 * t128 // sms)  # in 128 x 64 tiles
    return 64 if narrow * 8 <= wide * 7 else 128


def aligned16(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """``t`` itself when its first element lies on a 16-byte boundary (what
    a TMA tensor map requires of its base), else a fresh copy, which the
    allocator aligns."""
    if t is None or t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def accumulator_owner(n: int):
    """The accumulator layout of one ``wgmma`` m64n``n``k16 product
    (``csrc/hopper.cuh``): a list over (thread 0..127, register 0..n/2-1) of
    the (row, column) of the 64 x n tile that register holds. Thread t (warp
    w = t // 32, lane l = t % 32) holds, for each 8-column block j,
    d[4j], d[4j+1] = row 16w + l//4, columns 8j + 2(l%4), +1 and d[4j+2],
    d[4j+3] = the same columns eight rows further down."""
    owner = []
    for t in range(128):
        w, lane = t // 32, t % 32
        for reg in range(n // 2):
            j, e = reg // 4, reg % 4
            owner.append((t, reg, 16 * w + lane // 4 + 8 * (e // 2), 8 * j + 2 * (lane % 4) + e % 2))
    return owner


def gelu_grad(x: torch.Tensor, tanh: bool) -> torch.Tensor:
    """d/dx of the GELU (erf-exact or the tanh form), in f32."""
    x = x.float()
    if not tanh:
        return 0.5 * (1.0 + torch.erf(x * 0.7071067811865476)) \
            + x * 0.3989422804014327 * torch.exp(-0.5 * x * x)
    c = math.sqrt(2.0 / math.pi)
    t = torch.tanh(c * (x + 0.044715 * x ** 3))
    return 0.5 * (1.0 + t) + 0.5 * x * (1.0 - t * t) * c * (1.0 + 3.0 * 0.044715 * x * x)


def gemm_plain(a, w, bias=None, act: str = "none", dropout: Optional[tuple] = None,
               aux=None, res=None, out_dtype=None):
    """Plain PyTorch version, in f32: ``a`` [M, K], ``w`` [N, K], ``bias``
    [N]; ``act`` one of ``ACTS``; ``dropout = (rate, seed, salt, S)`` drops
    by the FFN scheme of ``dropout.ffn_keep`` over (row // S, row % S,
    column); ``aux`` [M, N] f32 is the pre-activation the ``dgelu_*``
    epilogues differentiate at; ``res`` [M, N] is added last."""
    M, N = a.shape[0], w.shape[0]
    y = a.float() @ w.float().t()
    if bias is not None:
        y = y + bias.float()
    if act in ("gelu_erf", "gelu_tanh"):
        y = F.gelu(y, approximate="tanh" if act == "gelu_tanh" else "none")
    if dropout is not None:
        rate, seed, salt, S = dropout
        keep = ffn_keep(seed, salt, -(-M // S), S, N, rate, device=a.device)
        y = apply_keep(y, keep.reshape(-1, N)[:M], rate)
    if act in ("dgelu_erf", "dgelu_tanh"):
        y = y * gelu_grad(aux, act == "dgelu_tanh")
    if res is not None:
        y = y + res.float()
    return y.to(out_dtype or a.dtype)


def gemm(a, w, bias=None, act: str = "none", dropout: Optional[tuple] = None,
         aux=None, res=None, out_dtype=None):
    """The same function on the card: bf16 ``a``, ``w``, ``bias``; ``res``
    bf16 or f32; the output bf16 or f32 (``out_dtype``). CPU tensors run
    ``gemm_plain``; CUDA tensors launch the kernel or raise."""
    if a.device.type == "cpu":
        return gemm_plain(a, w, bias, act, dropout, aux, res, out_dtype)
    if a.device.type != "cuda":
        raise RuntimeError(f"gemm: no kernel for device {a.device}")
    bf16, f32 = torch.bfloat16, torch.float32
    out_dtype = out_dtype or bf16
    if a.dtype != bf16 or w.dtype != bf16 or (bias is not None and bias.dtype != bf16):
        raise TypeError("gemm: a, w and bias must be bfloat16")
    if out_dtype not in (bf16, f32) or (res is not None and res.dtype not in (bf16, f32)):
        raise TypeError("gemm: the output and the residual are bfloat16 or float32")
    (M, K), N = a.shape, w.shape[0]
    if w.shape[1] != K or a.stride(1) != 1 or w.stride(1) != 1 or K % 8:
        raise ValueError("gemm: a [M, K] and w [N, K] with dense rows, K a multiple of 8")
    if act.startswith("dgelu") != (aux is not None):
        raise ValueError("gemm: aux goes with the dgelu_* epilogues")
    if aux is not None and (aux.dtype != f32 or aux.shape != (M, N) or not aux.is_contiguous()):
        raise ValueError("gemm: aux must be contiguous float32 [M, N]")
    if res is not None and (res.shape != (M, N) or res.stride(1) != 1):
        raise ValueError("gemm: res must be [M, N] with dense rows")
    a, w, bias = aligned16(a), aligned16(w), aligned16(bias)
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    rate, seed, salt, S = dropout if dropout is not None else (0.0, None, 0, 1)
    seed_t = (torch.as_tensor(seed, device=a.device).reshape(1).to(torch.int32)
              if dropout is not None else None)
    lib, p = _build.library(), _build.ptr
    err = lib.smm_gemm(p(a), a.stride(0), p(w), w.stride(0), p(bias), p(res),
                       res.stride(0) if res is not None else 0,
                       int(res is not None and res.dtype == f32), p(out), N,
                       int(out_dtype == f32), ACTS[act], p(aux), p(seed_t), threshold(rate),
                       1.0 / (1.0 - rate) if rate else 1.0, salt, S, M, N, K,
                       _build.stream_ptr(a))
    _build.check(lib, err, "gemm")
    return out


def _rows_padded_t(t: torch.Tensor) -> torch.Tensor:
    """``t`` [M, C] transposed to [C, M'] with zero columns up to M' (a
    multiple of 64), so that M is the inner dimension of a product the
    wgmma kernel takes; zero terms add nothing."""
    M, C = t.shape
    out = t.new_zeros((C, -(-M // 64) * 64))
    out[:, :M] = t.t()
    return out


class _GemmLinear(torch.autograd.Function):
    """y = x wᵀ for bf16 ``x`` [M, K] and the bf16 cast ``w`` [N, K] of f32
    weights stacked by rows; dx = dy w and dW = dyᵀ x in f32, each one
    ``gemm``; dW is split back to the weights' rows."""

    @staticmethod
    def forward(ctx, x, *weights):
        w = torch.cat([p.to(x.dtype) for p in weights]) if len(weights) > 1 \
            else weights[0].to(x.dtype)
        ctx.save_for_backward(x, w)
        ctx.rows = [p.shape[0] for p in weights]
        return gemm(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        dx = gemm(dy, w.t().contiguous()) if ctx.needs_input_grad[0] else None
        if not any(ctx.needs_input_grad[1:]):
            return (dx,) + (None,) * len(ctx.rows)
        dw = gemm(_rows_padded_t(dy), _rows_padded_t(x), out_dtype=torch.float32)
        return (dx,) + tuple(dw.split(ctx.rows))


def gemm_linear(x: torch.Tensor, *weights: torch.Tensor) -> torch.Tensor:
    """``x`` [..., K] times the f32 weights [N_i, K] stacked by rows (one
    product for several layers that read the same input), in ``x``'s dtype,
    bias-free, forward and backward on ``gemm``: bf16 on the card (any other
    dtype there raises, as ``gemm`` does), ``gemm_plain`` on the CPU."""
    lead, K = x.shape[:-1], x.shape[-1]
    if x.device.type == "cuda" and x.dtype != torch.bfloat16:
        raise TypeError(f"gemm_linear: no {x.dtype} kernel on the card; x must be bfloat16 "
                        f"(the model's mixed_precision)")
    y = _GemmLinear.apply(x.reshape(-1, K), *weights)
    return y.reshape(*lead, y.shape[-1])
