"""DeBERTa disentangled attention:
softmax((QKᵀ + c2p + p2c)/√(3D), masked keys = -1e30)·V with

    c2p[q, k] = q_q · pos_k[clip(bucket(q − k) + span)]
    p2c[q, k] = k_k · pos_q[clip(−bucket(k − q) + span)]

(the second equals clip(bucket(q − k) + span), as the bucket map is
antisymmetric).

Replaces the TPU kernels of simple_multimodal_tpu/ops/pallas/deberta_attention.py:
the forward (``_kernel`` via ``_fused_call``) and the backward
(``_bwd_kernel`` via ``_bwd_call``). On a CUDA tensor the wrapper runs
``DebertaAttentionFn``: its forward launches ``csrc/deberta_attention.cu``,
its backward ``csrc/deberta_attention_bwd.cu``. In bf16 at head width 64
(``smm_attention_wgmma_route``) the forward is the wgmma kernel of
``csrc/deberta_attention_fwd_wgmma.cu``, which in training also keeps each
row's maximum and sum, and the backward takes those and the output instead of
re-running the forward; its other kernels are ``csrc/deberta_attention_bwd_dq_wgmma.cu``
and ``csrc/deberta_attention_bwd_dkv_wgmma.cu``, which form the two
relative-position terms in the accumulator layout (``csrc/deberta_scores_wgmma.cuh``).
f32 and head widths 16 and 32 keep ``csrc/attention.cuh``'s kernel (one block
per (query tile, head, batch) that gathers the position-table rows each key
tile needs through the host-built index maps below), which the backward
re-runs. On a CPU tensor it runs ``deberta_attention_plain``, the port of
that file's ``_xla_reference`` with a gather in place of the TPU's rel-shift
skew, and autograd differentiates it.
"""
import functools
import math
from typing import Optional

import numpy as np
import torch

from . import _build
from .dropout import apply_keep, attention_keep, drop_scale, seed_tensor, threshold
from .gemm import aligned16

NEG_INF = -1e30  # finite fill: an all-masked row attends uniformly


def log_bucket(rel: np.ndarray, bucket_size: int, max_position: int) -> np.ndarray:
    """DeBERTa's log-bucket map, elementwise over relative positions:
    within ±bucket_size/2 exact, farther ones log-spaced into the remaining
    buckets. Antisymmetric: b(−x) = −b(x)."""
    mid = bucket_size // 2
    sign = np.sign(rel)
    abs_pos = np.where((rel < mid) & (rel > -mid), mid - 1, np.abs(rel))
    with np.errstate(divide="ignore", invalid="ignore"):
        log_pos = (
            np.ceil(np.log(abs_pos / mid) / np.log((max_position - 1) / mid) * (mid - 1))
            + mid
        )
    bucket = np.where(abs_pos <= mid, rel.astype(np.float64), log_pos * sign)
    return bucket.astype(np.int32)


@functools.lru_cache(maxsize=32)
def rel_index_maps(S: int, span: int, max_position: int):
    """Position-table row for every relative offset r = q − k in
    [−(S−1), S−1], stored at r + S − 1: (idx_c, idx_p), int32 [2S − 1].

    Built as ``build_rel_tables`` builds its tables: c2p over rows = q with
    rel = q − k, p2c over rows = k with rel = k − q and the bucket negated.
    """
    r = np.arange(-(S - 1), S)
    idx_c = np.clip(log_bucket(r, span, max_position) + span, 0, 2 * span - 1)
    idx_p = np.clip(-log_bucket(-r, span, max_position) + span, 0, 2 * span - 1)
    return idx_c.astype(np.int32), idx_p.astype(np.int32)


def fold_order(idx: np.ndarray, rows: int):
    """CSR of the many-to-one map offset → table row: ``order`` lists the
    offsets r (as r + S − 1) grouped by table row, in increasing r, and
    ``offsets[t]:offsets[t+1]`` is row t's slice. The backward folds the
    per-offset table gradients through it in a fixed order."""
    order = np.argsort(idx, kind="stable").astype(np.int32)
    offsets = np.searchsorted(idx[order], np.arange(rows + 1)).astype(np.int32)
    return order, offsets


@functools.lru_cache(maxsize=32)
def _device_maps(S: int, span: int, max_position: int, device: torch.device):
    """idx_c, idx_p and their fold CSRs, as int32 tensors on ``device``."""
    idx_c, idx_p = rel_index_maps(S, span, max_position)
    arrays = (idx_c, idx_p, *fold_order(idx_c, 2 * span), *fold_order(idx_p, 2 * span))
    return tuple(torch.from_numpy(m).to(device) for m in arrays)


def deberta_attention_plain(q, k, v, pos_k, pos_q, attention_mask, span: int,
                            max_position: int, dropout_rate: float = 0.0,
                            dropout_seed=None):
    """Plain PyTorch version of the JAX ``_xla_reference``: materializes the
    [B, H, S, S] scores and gathers the two bias terms from
    [B, H, S, 2·span] table products; the probabilities take the hash
    dropout before ·V. Same arguments as the wrapper."""
    B, S, H, D = q.shape
    f32 = torch.float32
    pk = pos_k.to(q.dtype).reshape(2 * span, H, D).to(f32)
    pq = pos_q.to(q.dtype).reshape(2 * span, H, D).to(f32)
    qf, kf = q.to(f32), k.to(f32)
    idx_c, idx_p = (torch.from_numpy(m).to(q.device).long()
                    for m in rel_index_maps(S, span, max_position))
    pos = torch.arange(S, device=q.device)
    rel = pos[:, None] - pos[None, :] + (S - 1)                    # [q, k]
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    qp = torch.einsum("bqhd,phd->bhqp", qf, pk)                    # [B,H,q,P]
    s = s + torch.gather(qp, 3, idx_c[rel].expand(B, H, S, S))
    kp = torch.einsum("bkhd,phd->bhkp", kf, pq)                    # [B,H,k,P]
    s = s + torch.gather(kp, 3, idx_p[rel.t()].expand(B, H, S, S)).transpose(2, 3)
    s = s * (1.0 / math.sqrt(3.0 * D))
    if attention_mask is not None:
        s = torch.where(attention_mask[:, None, None, :] > 0, s,
                        torch.full_like(s, NEG_INF))
    probs = torch.softmax(s, dim=-1)
    if dropout_rate:
        probs = apply_keep(probs, attention_keep(dropout_seed, B, H, S, S, dropout_rate,
                                                 device=q.device), dropout_rate)
    probs = probs.to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(f32), v.to(f32))
    return out.to(q.dtype)


class DebertaAttentionFn(torch.autograd.Function):
    """The CUDA forward and backward of the disentangled attention. Saves
    the inputs and, where the forward is the wgmma kernel (``route`` 1) and
    a backward can follow (``keep``), its output and row statistics, which
    that backward takes; else the backward re-runs the forward."""

    @staticmethod
    def forward(ctx, q, k, v, pk, pq, mask, seed, span, max_position, rate, route, keep):
        B, S, H, D = q.shape
        lib = _build.library()
        idx_c, idx_p = _device_maps(S, span, max_position, q.device)[:2]
        out = torch.empty_like(q)
        stats = torch.empty((2, B * H * S), dtype=torch.float32, device=q.device) if keep else None
        p = _build.ptr
        err = lib.smm_deberta_attention(
            _build.dtype_code(q), p(q), p(k), p(v), H * D, p(pk), p(pq), H * D,
            p(idx_c), p(idx_p), p(mask), B, S, H, D, p(seed),
            threshold(rate), drop_scale(rate), p(out), p(stats), _build.stream_ptr(q))
        _build.check(lib, err, "deberta_attention")
        deberta_attention.launches += 1
        ctx.save_for_backward(q, k, v, pk, pq, mask, seed, out if keep else None, stats)
        ctx.cfg = (span, max_position, rate, route)
        return out

    @staticmethod
    def backward(ctx, gy):
        q, k, v, pk, pq, mask, seed, out, stats = ctx.saved_tensors
        span, max_position, rate, wgmma = ctx.cfg
        B, S, H, D = q.shape
        dev, f32 = q.device, torch.float32
        if wgmma and stats is None:  # the wgmma backward re-runs nothing: it needs the kept ones
            raise RuntimeError("deberta_attention_bwd: the forward kept no row statistics")
        gy = aligned16(gy.to(q.dtype).contiguous())
        lib = _build.library()
        idx_c, idx_p, ord_c, off_c, ord_p, off_p = _device_maps(S, span, max_position, dev)
        if not wgmma:  # attention.cuh's forward: scratch the backward re-runs it into
            out = torch.empty_like(q)
            stats = torch.empty((2, B * H * S), dtype=f32, device=dev)
        delta = torch.empty((B * H * S,), dtype=f32, device=dev)
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        g_rel = torch.empty(rel_scratch_shape(wgmma, B, S, H, D), dtype=f32, device=dev)
        dpk = torch.empty((2 * span, H * D), dtype=f32, device=dev)
        dpq = torch.empty((2 * span, H * D), dtype=f32, device=dev)
        p = _build.ptr
        err = lib.smm_deberta_attention_bwd(
            _build.dtype_code(q), p(q), p(k), p(v), H * D, p(pk), p(pq), H * D,
            p(idx_c), p(idx_p), p(mask), B, S, H, D, p(seed),
            threshold(rate), drop_scale(rate), p(gy), p(out), p(stats), p(delta), p(dq),
            p(dk), p(dv), p(g_rel), p(ord_c), p(off_c), p(ord_p), p(off_p), 2 * span,
            p(dpk), p(dpq), _build.stream_ptr(q))
        _build.check(lib, err, "deberta_attention_bwd")
        deberta_attention_bwd.launches += 1
        return (dq, dk, dv, dpk.to(pk.dtype), dpq.to(pq.dtype), None, None, None,
                None, None, None, None)


def rel_scratch_shape(route: int, B: int, S: int, H: int, D: int) -> tuple:
    """Shape of the backward's f32 scratch for the per-offset table sums:
    one row per offset and (batch, head) for the kernels of
    ``csrc/attention_bwd.cuh``; where the wgmma kernels run (``route`` 1,
    as ``smm_attention_wgmma_route`` reports it: bf16 at head width 64), one
    partial per 64-row tile, in ``T + 1`` blocks of 64 offsets (``T`` tiles
    along the sequence)."""
    if route:
        T = -(-S // 64)
        return (2, B, H, T, T + 1, 64, D)
    return (2, B, H, 2 * S - 1, D)


def partial_row(r: int, tile: int, tiles: int, by_key: bool):
    """Where the wgmma backward kernels leave the per-offset sum of offset
    ``r = q − k`` in the partial of 64-row tile ``tile`` (a query tile for
    the pos_k cotangent, a key tile with ``by_key`` for pos_q's):
    (block, row) in its ``tiles + 1`` blocks of 64 offsets, or None where
    the tile's pairs never reach ``r``. The pair (query tile i, key tile j)
    covers the offsets 64(i − j) − 63 + u, u < 128; its half that the next
    streamed pair shares is carried on and written once, complete, as that
    pair's block (``fold_partials_kernel`` in ``csrc/deberta_attention_bwd.cu``
    applies the same rule)."""
    if by_key:
        w = r + 64 * tile + 63
        return (w >> 6, w & 63) if 0 <= w < 64 * (tiles + 1) else None
    w = 64 * tile + 1 - r
    if w < -63 or w > 64 * tiles:
        return None
    blk = (w + 63) >> 6
    return blk, 64 * blk - w


def deberta_attention(q, k, v, pos_k, pos_q,
                      attention_mask: Optional[torch.Tensor], span: int,
                      max_position: int, dropout_rate: float = 0.0,
                      dropout_seed=None):
    """Fused disentangled attention; same arguments and layouts as the JAX
    ``deberta_attention``: q/k/v [B, S, H, D], pos_k/pos_q [2·span, H·D] or
    [2·span, H, D], attention_mask [B, S] (1 = attend) or None. Applies
    the 1/√(3D) scaling; ``dropout_rate`` > 0 drops probabilities by the
    stateless hash of ``dropout_seed``. Returns [B, S, H, D].

    CPU tensors run the plain version; CUDA tensors launch the kernels
    (forward, and backward under autograd) or raise.
    """
    rate = float(dropout_rate)
    if rate and dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed")
    if q.device.type == "cpu":
        return deberta_attention_plain(q, k, v, pos_k, pos_q, attention_mask, span,
                                       max_position, dropout_rate=rate,
                                       dropout_seed=dropout_seed)
    if q.device.type != "cuda":
        raise RuntimeError(f"deberta_attention: no kernel for device {q.device}")
    B, S, H, D = q.shape
    if D not in (16, 32, 64):
        raise ValueError(f"deberta_attention: head width {D} not in (16, 32, 64)")
    dt = q.dtype
    _build.dtype_code(q)
    # 16-byte aligned bases: the wgmma backward reads them through TMA tensor maps
    q, k, v = (aligned16(t.to(dt).contiguous()) for t in (q, k, v))
    pk = aligned16(pos_k.to(dt).reshape(2 * span, H * D).contiguous())
    pq = aligned16(pos_q.to(dt).reshape(2 * span, H * D).contiguous())
    if attention_mask is None:
        mask = torch.ones((B, S), dtype=torch.int32, device=q.device)
    else:
        mask = attention_mask.to(device=q.device, dtype=torch.int32).contiguous()
    seed = seed_tensor(dropout_seed, q.device) if rate else None
    route = _build.library().smm_attention_wgmma_route(_build.dtype_code(q), D, 1)
    # the forward keeps its output and row statistics where the backward takes them
    keep = bool(route and torch.is_grad_enabled()
                and any(t.requires_grad for t in (q, k, v, pk, pq)))
    return DebertaAttentionFn.apply(q, k, v, pk, pq, mask, seed, span, max_position, rate,
                                    route, keep)


def deberta_attention_bwd():
    """Launch counter of the backward chain (``DebertaAttentionFn.backward``)."""


deberta_attention.launches = 0
deberta_attention_bwd.launches = 0
