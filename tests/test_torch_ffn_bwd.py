"""The FFN block's backward in the port: the plain version's gradients and
the wgmma chain's plain statement (``ffn_block_bwd_plain``) against the JAX
package's Pallas ``_ffn_bwd`` in interpret mode (SMM_FFN_BWD=1), in the three
LayerNorm modes with both dropouts, all gradients at 1e-4 in f32; and, torch
only, the host side the CUDA chain stands on: which body a call takes (the
FFN backward's and DeBERTa's forward's), the row partition of the row
kernels, where each tile and row block leaves its db1, db2 and LayerNorm
partials, the fixed fold order, and DeBERTa's wgmma backward refusing to run
without the forward's kept statistics. The kernels themselves run on the
card only (chip_smoke.py).
"""
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from simple_multimodal_tpu.ops.pallas import ffn_block as jfb
from simple_multimodal_tpu_torch.ops.hopper import _build
from simple_multimodal_tpu_torch.ops.hopper import ffn_block as fb
from simple_multimodal_tpu_torch.ops.hopper.attention_block import attention_wgmma_route
from simple_multimodal_tpu_torch.ops.hopper.deberta_attention import DebertaAttentionFn

GTOL = dict(atol=1e-4, rtol=1e-4)
RATE, SEED = 0.1, 20260516


def _ffn_args(B, S, E, Fd, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, E)).astype(np.float32)
    w1 = (rng.standard_normal((E, Fd)) / np.sqrt(E)).astype(np.float32)
    b1 = (0.1 * rng.standard_normal((Fd,))).astype(np.float32)
    w2 = (rng.standard_normal((Fd, E)) / np.sqrt(Fd)).astype(np.float32)
    b2 = (0.1 * rng.standard_normal((E,))).astype(np.float32)
    g = (1.0 + 0.1 * rng.standard_normal((E,))).astype(np.float32)
    b = (0.1 * rng.standard_normal((E,))).astype(np.float32)
    ct = rng.standard_normal((B, S, E)).astype(np.float32)
    return [x, w1, b1, w2, b2, g, b], ct


@pytest.mark.parametrize("ln_mode", ["none", "pre", "post"])
def test_plain_backward_matches_jax_pallas_ffn_bwd(ln_mode, monkeypatch):
    """Autograd of ``ffn_block_plain`` and the chain ``ffn_block_bwd_plain``
    against ``jax.grad`` through the Pallas ``_ffn_bwd`` kernel (interpret
    mode), with both hash dropouts at 0.1: every gradient (dx, dW1, db1,
    dW2, db2 and, with a LayerNorm, its scale and bias) at 1e-4."""
    monkeypatch.setenv("SMM_FFN_BWD", "1")  # the Pallas backward is opt-in in the JAX package
    jax.clear_caches()
    B, S, E, Fd = 2, 13, 32, 64
    args, ct = _ffn_args(B, S, E, Fd, seed=11)
    post, eps = ln_mode == "post", 1e-7
    n = 5 if ln_mode == "none" else 7
    drop = dict(dropout_rate_mid=RATE, dropout_rate_out=RATE, dropout_seed=SEED)

    def jloss(*a):
        ln = (a[5], a[6], eps) if n == 7 else None
        out = jfb.ffn_block(*a[:5], ln=ln, ln_post=post, residual=True, interpret=True, **drop)
        return (out * ct).sum()

    want = jax.grad(jloss, argnums=tuple(range(n)))(*args[:n])
    ts = [torch.from_numpy(a).requires_grad_() for a in args[:n]]
    ln = (ts[5], ts[6], eps) if n == 7 else None
    out = fb.ffn_block(*ts[:5], ln=ln, ln_post=post, residual=True, **drop)
    out.backward(torch.from_numpy(ct))
    chain = fb.ffn_block_bwd_plain(*[torch.from_numpy(a) for a in args[:5]],
                                   torch.from_numpy(ct), ln=None if n == 5 else (
                                       torch.from_numpy(args[5]), torch.from_numpy(args[6]), eps),
                                   ln_post=post, residual=True, **drop)
    for i, w in enumerate(want):
        w = np.asarray(w).reshape(args[i].shape)
        np.testing.assert_allclose(ts[i].grad.numpy(), w, **GTOL, err_msg=f"autograd, grad {i}")
        np.testing.assert_allclose(chain[i].numpy(), w, **GTOL, err_msg=f"chain, grad {i}")


@pytest.mark.parametrize("residual", [False, True])
def test_plain_chain_without_dropout_matches_autograd(residual):
    """The chain's plain statement against autograd of ``ffn_block_plain``
    without dropout, ragged rows (3 x 45 = 135: one full 128-row strip and 7
    rows), f32 at 1e-4, in the three LayerNorm modes."""
    B, S, E, Fd = 3, 45, 64, 128
    args, ct = _ffn_args(B, S, E, Fd, seed=12)
    for ln_mode in ("none", "pre", "post"):
        ts = [torch.from_numpy(a).requires_grad_() for a in args]
        ln = None if ln_mode == "none" else (ts[5], ts[6], 1e-5)
        out = fb.ffn_block_plain(*ts[:5], ln=ln, ln_post=ln_mode == "post", residual=residual)
        out.backward(torch.from_numpy(ct))
        chain = fb.ffn_block_bwd_plain(*[t.detach() for t in ts[:5]], torch.from_numpy(ct),
                                       ln=None if ln is None else (ts[5].detach(),
                                                                   ts[6].detach(), 1e-5),
                                       ln_post=ln_mode == "post", residual=residual)
        for i, got in enumerate(chain):
            if got is not None:
                torch.testing.assert_close(got, ts[i].grad, **GTOL, msg=f"{ln_mode} grad {i}")


def test_ffn_bwd_route_takes_wgmma_at_the_base_widths_only():
    bf16, f32 = torch.bfloat16, torch.float32
    for E, Fd in ((768, 3072), (64, 128), (1024, 4096), (128, 256)):
        assert fb.ffn_bwd_route(bf16, E, Fd) == 1
        assert fb.ffn_bwd_route(f32, E, Fd) == 0
    for E, Fd in ((32, 64), (96, 160), (768, 192), (768, 3000), (800, 3072), (2048, 8192)):
        # the tiny preset, F off the kernel's 128-column tile, odd widths, E past 1024
        assert fb.ffn_bwd_route(bf16, E, Fd) == 0


def test_deberta_forward_route_takes_wgmma_in_bf16_at_head_width_64():
    """DeBERTa's forward follows the rule of the attention backwards with the
    position tables (``rel``): the wgmma kernel in bf16 at head width 64."""
    assert attention_wgmma_route(torch.bfloat16, 64, True) == 1
    assert attention_wgmma_route(torch.float32, 64, True) == 0
    for D in (16, 32):
        assert attention_wgmma_route(torch.bfloat16, D, True) == 0
        assert attention_wgmma_route(torch.float32, D, True) == 0


def test_deberta_wgmma_backward_without_kept_statistics_raises():
    """On the wgmma route the backward takes the forward's output and row
    statistics and re-runs nothing; without them it raises before it builds
    or launches anything, rather than read uninitialised buffers."""
    q = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16)
    ctx = SimpleNamespace(saved_tensors=(q, q, q, None, None, None, None, None, None),
                          cfg=(4, 16, 0.0))
    with pytest.raises(RuntimeError, match="kept no row statistics"):
        DebertaAttentionFn.backward(ctx, q)


@pytest.mark.parametrize("M", [1, 26, 130, 3992, 4096, 47280])
def test_row_partition_gives_every_row_to_one_block(M):
    """Contiguous row ranges, at most 264 blocks, none empty; warp w of a
    block takes rows w, w + 8, ... of its range."""
    per, blocks = _build.row_partition(M)
    assert 1 <= blocks <= 264 and (blocks - 1) * per < M <= blocks * per
    owner = torch.full((M,), -1)
    for b in range(blocks):
        for w in range(8):
            rows = list(range(b * per + w, min((b + 1) * per, M), 8))
            assert bool((owner[rows] == -1).all())
            owner[rows] = b
    assert bool((owner >= 0).all())
    assert _build.ln_bwd_blocks(M) == blocks
    assert blocks > min(-(-M // 8), 264) // 2  # the SMs stay busy: ~two blocks on each


@pytest.mark.parametrize("M", [7, 130, 300, 513])
def test_partials_fold_to_the_plain_column_sums(M):
    """db1's strip partials, db2's and the LayerNorm's row-block partials,
    folded in the kernels' fixed order, equal the plain column sums; each
    strip's partial is the sum of its own 128 rows and nothing else."""
    g = torch.Generator().manual_seed(M)
    v = torch.randn(M, 192, generator=g)
    strips = fb.strip_partials(v)
    assert strips.shape == (-(-M // 128), 192)
    for i in range(strips.shape[0]):
        torch.testing.assert_close(strips[i], v[128 * i:128 * (i + 1)].sum(0))
    blocks = fb.row_block_partials(v)
    assert blocks.shape == (_build.row_partition(M)[1], 192)
    for part in (strips, blocks):
        torch.testing.assert_close(fb.fold_columns(part), v.sum(0), atol=1e-4, rtol=1e-5)


def test_fold_order_is_eight_row_ranges_then_warp_order():
    """The fold adds rows r in [rows w / 8, rows (w + 1) / 8) in order for each
    warp w, then the eight sums in order: bit for bit that sequence of f32
    additions (sums that rounding tells apart from other orders)."""
    rows = 37
    part = torch.tensor([[1e8 if r % 5 == 0 else 1.0 + r * 1e-3] for r in range(rows)],
                        dtype=torch.float32)
    want = None
    for w in range(8):
        s = torch.zeros(1)
        for r in range(rows * w // 8, rows * (w + 1) // 8):
            s = s + part[r]
        want = s if want is None else want + s
    assert torch.equal(fb.fold_columns(part), want)


def test_part_floats_hold_the_chains_partials():
    M, E, Fd = 47280, 768, 3072
    _, blocks = _build.row_partition(M)
    assert blocks == 263
    assert fb.ffn_bwd_part_floats(1, M, E, Fd) == blocks * 2 * E + 370 * Fd + blocks * E
    assert fb.ffn_bwd_part_floats(0, M, E, Fd) == blocks * 2 * E


def test_plain_ln_backward_of_the_row_kernel_matches_autograd():
    """The row kernel's LayerNorm backward (two-pass statistics, dgamma and
    dbeta folded from row-block partials) against autograd of F.layer_norm."""
    g = torch.Generator().manual_seed(3)
    M, E = 300, 96
    x = torch.randn(M, E, generator=g).requires_grad_()
    w = (1 + 0.1 * torch.randn(E, generator=g)).requires_grad_()
    b = (0.1 * torch.randn(E, generator=g)).requires_grad_()
    dy = torch.randn(M, E, generator=g)
    F.layer_norm(x, (E,), w, b, 1e-5).backward(dy)
    dx, dln = fb._ln_bwd_rows(dy, x.detach(), w.detach(), 1e-5)
    torch.testing.assert_close(dx, x.grad, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(dln[0], w.grad, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(dln[1], b.grad, atol=1e-4, rtol=1e-5)
