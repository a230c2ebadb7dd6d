"""The routed experts of one MoE layer (``models/deepseek.py``'s ``MoE``)
without a host read of the routing:

    out[t] = Σ_j w_j[t] · down_j(silu(gate_j(h[t])) ⊙ up_j(h[t]))   (f32)

over the n experts this process holds, in ascending j, with w_j[t] the
routing weight of token t's choice of expert j (no term where t did not
choose it).

``dispatch`` turns the router's choice into the device-side plan the
kernels read: each held expert's row count, its first row in the
expert-sorted order (segments padded to multiples of ``TILE``), each
(token, choice)'s row. Nothing is read back to the host, and every buffer is
sized for the bound T · min(k, n) + ``TILE`` · n (``rows_bound``), so no
shape depends on the routing.

``moe_experts`` runs ``moe_experts_plain`` on the CPU (a loop over the held
experts, each over all T rows with its per-token weight, 0 where the
expert was not chosen) and, for CUDA tensors, ``_MoEExperts`` on the kernels
of ``csrc/moe_experts_wgmma.cu``: the weight cast, a gather, two grouped
products and a fixed-order combine forward; a gather, four grouped products
and a fixed-order sum over each token's rows backward (bf16, E and F
multiples of 128, at most 64 held experts and 8 choices a token; anything
else on the card raises). The expert weights stay f32 parameters under
their own names; their gradients are contiguous views of two stacked f32
buffers, zeros for an expert with no rows. ``moe_experts.launches`` counts
the card's forward calls, one a layer forward.
"""
import ctypes
import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F

from . import _build

TILE = 128  # an expert's segment of the sorted rows is padded to a multiple (csrc kBM)
MAX_EXPERTS, MAX_K = 64, 8  # csrc kMaxExperts, kMaxK
GATE_UP, DOWN, DACT, DX, DW1, DW2 = range(6)  # csrc Mode


def rows_bound(T: int, k: int, n: int) -> int:
    """Rows of every per-row buffer: the most rows T tokens can send to n of
    the experts at k distinct choices each, plus each segment's padding."""
    return -(-T * min(k, n) // TILE) * TILE + TILE * n


@dataclasses.dataclass
class Dispatch:
    """The routing of one layer's T tokens over its n held experts, on the
    routing's device."""
    slot: torch.Tensor     # [T, k] int64: the held expert's index (0..n−1) of each choice, n if not held
    counts: torch.Tensor   # [n] int32: the rows routed to each held expert
    offsets: torch.Tensor  # [n + 1] int32: each expert's first row in the sorted order (the last: all)
    pos: torch.Tensor      # [T, k] int32: the row of each held choice, −1 for the others
    entry: torch.Tensor    # [rows + 1] int32: each real row's choice t·k + s (the rest unset)
    rows: int              # rows_bound(T, k, n)


def dispatch(choice: torch.Tensor, start: int, n: int) -> Dispatch:
    """The plan for ``choice`` [T, k] (global expert indices) when this
    process holds experts start … start + n − 1: a held expert's rows are
    its choices in (token, choice) order, its segment padded with empty rows
    to a multiple of ``TILE``."""
    T, k = choice.shape
    dev = choice.device
    local = choice - start
    slot = torch.where((local >= 0) & (local < n), local, n)
    flat = slot.reshape(-1)
    # [n + 1, T·k]: choices of each slot so far (a scan along the inner axis: along the
    # outer one the card's scan takes milliseconds)
    seen = (flat == torch.arange(n + 1, device=dev)[:, None]).cumsum(1, dtype=torch.int32)
    counts = seen[:n, -1].contiguous()
    rank = seen.gather(0, flat[None]).squeeze(0) - 1
    padded = torch.div(counts + (TILE - 1), TILE, rounding_mode="floor") * TILE
    offsets = F.pad(padded.cumsum(0, dtype=torch.int32), (1, 0))
    held = flat < n
    pos = torch.where(held, offsets.gather(0, flat.clamp(max=n - 1)) + rank, -1).to(torch.int32)
    rows = rows_bound(T, k, n)
    entry = torch.empty(rows + 1, dtype=torch.int32, device=dev)
    entry.scatter_(0, torch.where(held, pos.long(), rows),
                   torch.arange(T * k, dtype=torch.int32, device=dev))
    return Dispatch(slot, counts, offsets, pos.reshape(T, k), entry, rows)


def moe_experts_plain(h: torch.Tensor, weights: torch.Tensor, slot: torch.Tensor,
                      gates: Sequence[torch.Tensor], ups: Sequence[torch.Tensor],
                      downs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Plain PyTorch version, f32 [T, E]: ``h`` [T, E], ``weights`` [T, k]
    f32, ``slot`` [T, k] (``Dispatch.slot``), each expert's gate and up [F,
    E] and down [E, F]. The kernels' roundings in ``h``'s dtype: the weights,
    gate and up, and the SiLU product; the down product, the routing weight
    and the sum in f32. Every expert runs over all T rows, weighted 0 where
    it was not chosen."""
    dt, n = h.dtype, len(gates)
    share = (slot[..., None] == torch.arange(n, device=slot.device)) * weights[..., None]
    w = share.sum(1)  # [T, n]: one term at most
    x = h.float()
    out = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
    for j in range(n):
        w1 = torch.cat([gates[j], ups[j]]).to(dt).float()
        g, u = (x @ w1.t()).to(dt).float().chunk(2, dim=-1)
        a = (F.silu(g) * u).to(dt).float()
        out = out + (a @ downs[j].to(dt).float().t()) * w[:, j:j + 1]
    return out


_p = _build.ptr


def _empty(like: torch.Tensor, *shape: int, dtype=torch.bfloat16) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=like.device)


def _gemm(lib, mode, a, b, n, E, F_, *, gu=None, ws=None, out0=None, out1=None, part=None,
          offsets=None):
    """One grouped product (``csrc`` Mode): ``a`` is a per-row buffer [rows, ·]."""
    err = lib.smm_moe_gemm(mode, _p(a), _p(b), _p(gu), _p(ws), _p(out0), _p(out1), _p(part),
                           _p(offsets), n, a.shape[0], E, F_, _build.stream_ptr(a))
    _build.check(lib, err, "moe_experts")


class _MoEExperts(torch.autograd.Function):
    """``moe_experts`` on the card: ``h`` [T, E] bf16, ``weights`` [T, k]
    f32, the dispatch's int32 tensors, then the n gate, n up and n down f32
    weights; → out [T, E] f32. Saves the bf16 gate|up [rows, 2F], the rows'
    routing weights, the stacked bf16 weights and the dispatch; the backward
    gathers h's rows again."""

    @staticmethod
    def forward(ctx, h, weights, pos, entry, counts, offsets, rows, *params):
        n = len(params) // 3
        T, E = h.shape
        k, F_ = weights.shape[1], params[0].shape[0]
        lib, st = _build.library(), _build.stream_ptr(h)
        w1s, w2s = _empty(h, n, 2 * F_, E), _empty(h, n, E, F_)
        table = (ctypes.c_void_p * (3 * n))(*[p.data_ptr() for p in params])
        _build.check(lib, lib.smm_moe_cast(ctypes.addressof(table), n, E, F_, _p(w1s), _p(w2s),
                                           st), "moe_experts")
        xs, ws = _empty(h, rows, E), _empty(h, rows, dtype=torch.float32)
        _build.check(lib, lib.smm_moe_gather(_p(h), _p(weights), None, _p(entry), _p(counts),
                                             _p(offsets), n, k, E, rows, _p(xs), _p(ws), None,
                                             st), "moe_experts")
        gu, act = _empty(h, rows, 2 * F_), _empty(h, rows, F_)
        _gemm(lib, GATE_UP, xs, w1s, n, E, F_, out0=gu, out1=act, offsets=offsets)
        del xs
        ys = _empty(h, rows, E, dtype=torch.float32)
        _gemm(lib, DOWN, act, w2s, n, E, F_, ws=ws, out0=ys, offsets=offsets)
        del act
        out = _empty(h, T, E, dtype=torch.float32)
        _build.check(lib, lib.smm_moe_combine(_p(ys), _p(pos), T, k, E, _p(out), st),
                     "moe_experts")
        ctx.save_for_backward(h, gu, ws, w1s, w2s, pos, entry, counts, offsets)
        ctx.n = n
        return out

    @staticmethod
    def backward(ctx, dout):
        h, gu, ws, w1s, w2s, pos, entry, counts, offsets = ctx.saved_tensors
        n = ctx.n
        (T, E), k, F_, rows = h.shape, pos.shape[1], w2s.shape[2], gu.shape[0]
        needs = ctx.needs_input_grad
        lib, st = _build.library(), _build.stream_ptr(h)
        dout = dout.float().contiguous()
        xs, dys = _empty(h, rows, E), _empty(h, rows, E)
        _build.check(lib, lib.smm_moe_gather(_p(h), None, _p(dout), _p(entry), _p(counts),
                                             _p(offsets), n, k, E, rows, _p(xs), None, _p(dys),
                                             st), "moe_experts")
        dgu, aw = _empty(h, rows, 2 * F_), _empty(h, rows, F_)
        part = _empty(h, rows, F_ // TILE, dtype=torch.float32)
        _gemm(lib, DACT, dys, w2s, n, E, F_, gu=gu, ws=ws, out0=dgu, out1=aw, part=part,
              offsets=offsets)
        grads = [None] * (3 * n)
        if any(needs[7:]):
            dw1 = _empty(h, n, 2, F_, E, dtype=torch.float32)
            _gemm(lib, DW1, dgu, xs, n, E, F_, out0=dw1, offsets=offsets)
            dw2 = _empty(h, n, E, F_, dtype=torch.float32)
            _gemm(lib, DW2, dys, aw, n, E, F_, out0=dw2, offsets=offsets)
            grads = [dw1[j, 0] for j in range(n)] + [dw1[j, 1] for j in range(n)] + list(dw2)
        del xs, dys, aw
        dh = dweights = None
        if needs[0] or needs[1]:
            dxs = None
            if needs[0]:
                dxs = _empty(h, rows, E)
                _gemm(lib, DX, dgu, w1s, n, E, F_, out0=dxs, offsets=offsets)
                dh = _empty(h, T, E)
            dweights = _empty(h, T, k, dtype=torch.float32)
            _build.check(lib, lib.smm_moe_token_grad(_p(dxs), _p(part), _p(pos), T, k, E, F_,
                                                     _p(dh), _p(dweights), st), "moe_experts")
        return (dh, dweights if needs[1] else None, None, None, None, None, None, *grads)


def _check(h, weights, plan, params):
    if h.dtype != torch.bfloat16:
        raise TypeError(f"moe_experts: no {h.dtype} kernel on the card; h must be bfloat16 (the "
                        f"model's mixed_precision)")
    T, E = h.shape
    n = len(params) // 3
    F_ = params[0].shape[0]
    k = weights.shape[1]
    if not 1 <= n <= MAX_EXPERTS or not 1 <= k <= MAX_K or E % TILE or F_ % TILE:
        raise ValueError(f"moe_experts: the kernels take E and F in multiples of {TILE}, at most "
                         f"{MAX_EXPERTS} held experts and {MAX_K} choices a token; got E {E}, "
                         f"F {F_}, {n} experts, k {k}")
    for i, p in enumerate(params):
        want = (E, F_) if i >= 2 * n else (F_, E)
        if (p.dtype != torch.float32 or tuple(p.shape) != want or not p.is_contiguous()
                or p.device != h.device or p.data_ptr() % 16):
            raise ValueError(f"moe_experts: expert weight {i} must be a contiguous, 16-byte "
                             f"aligned float32 {list(want)} on {h.device}")
    if (weights.dtype != torch.float32 or weights.shape != (T, k) or plan.pos.shape != (T, k)
            or plan.entry.numel() != plan.rows + 1):
        raise ValueError("moe_experts: weights [T, k] float32 and the dispatch of these T tokens")


def moe_experts(h: torch.Tensor, weights: torch.Tensor, plan: Dispatch,
                gates: Sequence[torch.Tensor], ups: Sequence[torch.Tensor],
                downs: Sequence[torch.Tensor]) -> torch.Tensor:
    """The held experts' weighted sum, f32 [T, E], for ``h`` [T, E] routed
    by ``plan`` (``dispatch``) with ``weights`` [T, k] f32: the plain
    version on the CPU, the kernels on the card (or a raise)."""
    if h.device.type == "cpu":
        return moe_experts_plain(h, weights, plan.slot, gates, ups, downs)
    if h.device.type != "cuda":
        raise RuntimeError(f"moe_experts: no kernel for device {h.device}")
    params = [*gates, *ups, *downs]
    h, weights = h.contiguous(), weights.contiguous()
    if h.data_ptr() % 16:
        h = h.clone()
    _check(h, weights, plan, params)
    out = _MoEExperts.apply(h, weights, plan.pos, plan.entry, plan.counts, plan.offsets,
                            plan.rows, *params)
    moe_experts.launches += 1
    return out


moe_experts.launches = 0
