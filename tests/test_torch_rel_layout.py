"""Host-side pieces the wgmma backward kernels of attention_block and
deberta_attention stand on (the CUDA kernels run on the card only): which
body a call takes, the table rows a 64 x 64 tile pair reaches through
``rel_index_maps``, the fold CSR, and where the kernels leave the per-offset
sums in their per-tile partials. Torch and numpy only.
"""
import numpy as np
import pytest
import torch

from simple_multimodal_tpu_torch.ops.hopper import deberta_attention as da
from simple_multimodal_tpu_torch.ops.hopper.attention_block import attention_wgmma_route

LENGTHS = (64, 197, 499, 512)
SPAN, MAX_POSITION = 256, 512  # DeBERTa-v3-base


def test_backward_route_takes_wgmma_at_the_base_widths_only():
    bf16, f32 = torch.bfloat16, torch.float32
    assert attention_wgmma_route(bf16, 64, False) == 1 and attention_wgmma_route(bf16, 128, False) == 1
    assert attention_wgmma_route(bf16, 64, True) == 1
    assert attention_wgmma_route(bf16, 128, True) == 0   # no position tables at 128
    assert attention_wgmma_route(f32, 64, False) == 0 and attention_wgmma_route(f32, 64, True) == 0
    for D in (16, 32, 96):
        assert attention_wgmma_route(bf16, D, False) == 0 and attention_wgmma_route(bf16, D, True) == 0


@pytest.mark.parametrize("S", LENGTHS)
def test_rel_scratch_shape_follows_the_route(S):
    T = -(-S // 64)
    assert da.rel_scratch_shape(torch.bfloat16, 8, S, 12, 64) == (2, 8, 12, T, T + 1, 64, 64)
    assert da.rel_scratch_shape(torch.float32, 8, S, 12, 64) == (2, 8, 12, 2 * S - 1, 64)
    assert da.rel_scratch_shape(torch.bfloat16, 8, S, 4, 16) == (2, 8, 4, 2 * S - 1, 16)


@pytest.mark.parametrize("S", LENGTHS)
def test_a_tile_pair_reaches_one_contiguous_range_of_table_rows(S):
    """Per 64-query x 64-key tile the offsets q - k cover 127 consecutive
    values; the bucket maps are monotone with steps of at most one row, so
    the table rows they reach are one contiguous range of at most 127 rows
    (far fewer away from the diagonal, where the buckets are logarithmic)."""
    idx_c, idx_p = da.rel_index_maps(S, SPAN, MAX_POSITION)
    assert idx_c.shape == idx_p.shape == (2 * S - 1,)
    widest = 0
    for idx in (idx_c, idx_p):
        steps = np.diff(idx.astype(np.int64))
        assert steps.min() >= 0 and steps.max() <= 1
        assert idx.min() >= 0 and idx.max() < 2 * SPAN
        for q0 in range(0, S, 64):
            for k0 in range(0, S, 64):
                q = np.arange(q0, min(q0 + 64, S))[:, None]
                k = np.arange(k0, min(k0 + 64, S))[None, :]
                rows = np.unique(idx[(q - k) + S - 1])
                assert rows[-1] - rows[0] + 1 == len(rows) <= 127, (q0, k0)
                widest = max(widest, len(rows))
                # the kernels stage row u for offset rel0 + u, u < 127
                rel0 = q0 - k0 - 63
                assert ((q - k) - rel0).min() >= 0 and ((q - k) - rel0).max() <= 126
    assert widest == min(127, 2 * S - 1)
    if S == 512:  # log buckets are reached, and both signs differ
        assert idx_c[0] < SPAN - SPAN // 2 and idx_c[-1] > SPAN + SPAN // 2
        assert len(np.unique(idx_c)) < 2 * S - 1


@pytest.mark.parametrize("S", LENGTHS)
def test_fold_order_covers_every_offset_once(S):
    for idx in da.rel_index_maps(S, SPAN, MAX_POSITION):
        order, offsets = da.fold_order(idx, 2 * SPAN)
        assert offsets[0] == 0 and offsets[-1] == 2 * S - 1 and (np.diff(offsets) >= 0).all()
        assert sorted(order.tolist()) == list(range(2 * S - 1))
        for t in range(2 * SPAN):
            mine = order[offsets[t]:offsets[t + 1]]
            assert (idx[mine] == t).all() and (np.diff(mine) > 0).all()


@pytest.mark.parametrize("S", LENGTHS)
@pytest.mark.parametrize("by_key", [False, True])
def test_partial_rows_hold_every_pair_once(S, by_key):
    """The blocks the kernels write (the half a pair shares with the next
    streamed pair is carried on and written as that pair's block) against
    ``partial_row``, the rule the fold reads them by: every (q, k) lands in
    the row the fold looks up, and no two offsets share a row."""
    T = -(-S // 64)
    for own in range(T):          # the tile the block owns
        seen = {}
        for streamed in range(T):  # the tiles it streams, in order
            i, j = (streamed, own) if by_key else (own, streamed)
            rel0 = 64 * (i - j) - 63
            for u in range(127):
                # key tile owner: the lower half completes this pair's block, the
                # upper is carried to the next; query tile owner: the other way
                if by_key:
                    blk, rr = (streamed, u) if u < 64 else (streamed + 1, u - 64)
                else:
                    blk, rr = (streamed, u - 64) if u >= 64 else (streamed + 1, u)
                r = rel0 + u
                assert da.partial_row(r, own, T, by_key) == (blk, rr), (own, streamed, u)
                assert seen.setdefault((blk, rr), r) == r
        lo, hi = ((-(64 * own + 63), 64 * (T - own) - 1) if by_key
                  else (64 * (own - T) + 1, 64 * own + 63))
        for r in range(-(S - 1), S):
            assert (da.partial_row(r, own, T, by_key) is not None) >= (lo <= r <= hi)
