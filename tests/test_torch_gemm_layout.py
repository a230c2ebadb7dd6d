"""The host side of the wgmma GEMM and attention core of the port, on the
CPU with torch alone: the accumulator register layout in which the kernels'
epilogues address their elements, the dropout masks formed in that order,
the choice of kernel by shape and alignment, the weights a block's forward
hands the kernels, and the plain GEMM with its epilogue against the blocks'
plain versions.
"""
import pytest
import torch
import torch.nn.functional as F

from simple_multimodal_tpu_torch.models import vit
from simple_multimodal_tpu_torch.models.deberta import DebertaConfig
from simple_multimodal_tpu_torch.models.vit import ViTConfig, ViTLayer
from simple_multimodal_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from simple_multimodal_tpu_torch.ops.hopper import _build
from simple_multimodal_tpu_torch.ops.hopper import attention_block as ab
from simple_multimodal_tpu_torch.ops.hopper import ffn_block as fb
from simple_multimodal_tpu_torch.ops.hopper import gemm as G
from simple_multimodal_tpu_torch.ops.hopper.dropout import (
    SALT_MID, SALT_OUT, attention_keep, ffn_keep, hash_row, hash_row_keep, hash_u32, threshold)


@pytest.mark.parametrize("n", [64, 96, 128])
def test_accumulator_layout_covers_a_tile_exactly_once(n):
    """Every (row, column) of the 64 x n tile is held by one (thread,
    register); a thread holds n/2 registers on two rows eight apart, in
    pairs of neighbouring columns."""
    owner = G.accumulator_owner(n)
    assert len(owner) == 128 * (n // 2) == 64 * n
    assert sorted((r, c) for _, _, r, c in owner) == [(r, c) for r in range(64) for c in range(n)]
    assert sorted((t, reg) for t, reg, _, _ in owner) == [(t, reg) for t in range(128)
                                                          for reg in range(n // 2)]
    by_thread = {}
    for t, reg, r, c in owner:
        by_thread.setdefault(t, {})[reg] = (r, c)
    for t, regs in by_thread.items():
        rows = sorted({r for r, _ in regs.values()})
        assert rows == [16 * (t // 32) + (t % 32) // 4, 16 * (t // 32) + (t % 32) // 4 + 8]
        for reg, (r, c) in regs.items():
            assert r == rows[(reg % 4) // 2]
            if reg % 2:
                assert regs[reg - 1] == (r, c - 1) and c % 2 == 1


def test_split_hash_equals_the_tensor_hash():
    """hash_row + hash_row_keep on Python ints (the CUDA split) against
    hash_u32 on tensors, at indices that overflow 32 bits in the products."""
    g = torch.Generator().manual_seed(0)
    idx = torch.randint(0, 2 ** 31, (4, 200), generator=g)
    seed, (head, q, k, _) = 0xDEADBEEF, idx
    want = hash_u32(seed, head, q, k)
    for thresh in (threshold(0.1), threshold(0.5)):
        got = [hash_row_keep(hash_row(seed, int(h), int(a)), int(b), thresh)
               for h, a, b in zip(head, q, k)]
        assert got == (want >= thresh).tolist()


@pytest.mark.parametrize("S,rows,cols,tile_n,salt", [
    (197, 2 * 197, 128, 128, SALT_MID),   # 394 rows: three full 128-row tiles and 10 rows
    (197, 197 + 60, 64, 64, SALT_OUT),    # rows end inside a batch item
    (50, 130, 192, 64, SALT_MID),         # three column tiles
])
def test_ffn_mask_in_accumulator_order_equals_ffn_keep(S, rows, cols, tile_n, salt):
    """The GEMM epilogue's dropout mask, built element by element as the
    kernel walks it (block tile -> 64-row chain -> thread -> register, (b, s)
    = divmod(row, S) and the hash's row part once per row, rows past the end
    skipped), equals dropout.ffn_keep over (b, s, column)."""
    seed, rate = 20260516, 0.1
    thresh, owner = threshold(rate), G.accumulator_owner(tile_n)
    got = torch.zeros(rows, cols, dtype=torch.bool)
    seen = torch.zeros(rows, cols, dtype=torch.int32)
    for m0 in range(0, rows, 128):
        for n0 in range(0, cols, tile_n):
            for chain in range(2):
                row_part = {}
                for _, _, r, c in owner:
                    row = m0 + 64 * chain + r
                    if row >= rows:
                        continue
                    if row not in row_part:
                        row_part[row] = hash_row((seed + salt) & 0xFFFFFFFF, row // S, row % S)
                    got[row, n0 + c] = hash_row_keep(row_part[row], n0 + c, thresh)
                    seen[row, n0 + c] += 1
    assert bool((seen == 1).all())
    want = ffn_keep(seed, salt, -(-rows // S), S, cols, rate).reshape(-1, cols)[:rows]
    assert torch.equal(got, want)
    assert 0.05 < 1.0 - float(got.float().mean()) < 0.15


def test_attention_mask_in_accumulator_order_equals_attention_keep():
    """The attention core's dropout mask for S = 197 (two query tiles of 128
    rows, each two 64-row warpgroups; key tiles of 128), built in the
    accumulator order with head = b H + h, equals dropout.attention_keep."""
    B, H, S, seed, rate = 2, 3, 197, 77, 0.1
    thresh, owner = threshold(rate), G.accumulator_owner(128)
    want = attention_keep(seed, B, H, S, S, rate)
    for b, h in ((0, 0), (1, 2)):
        got = torch.zeros(S, S, dtype=torch.bool)
        seen = torch.zeros(S, S, dtype=torch.int32)
        for q0 in range(0, S, 128):
            for wg in range(2):
                for k0 in range(0, S, 128):
                    for _, _, r, c in owner:
                        q, k = q0 + 64 * wg + r, k0 + c
                        if q >= S or k >= S:
                            continue
                        got[q, k] = hash_row_keep(hash_row(seed, b * H + h, q), k, thresh)
                        seen[q, k] += 1
        assert bool((seen == 1).all())
        assert torch.equal(got, want[b, h])


BASE = [ViTConfig.base(), DebertaConfig.base(), Wav2Vec2Config.base()]
TINY = [ViTConfig.tiny(), DebertaConfig.tiny(), Wav2Vec2Config.tiny()]


@pytest.mark.parametrize("rows", [47280, 4096, 3992, 130])
def test_gemm_route_takes_wgmma_at_the_base_widths(rows):
    """Every product of both blocks at the base widths goes to the wgmma
    kernel, in 128-column tiles unless 64-column ones take an eighth off the
    busiest SM's share of the tiles."""
    for cfg in BASE:
        E, Fd = cfg.hidden_size, cfg.intermediate_size
        for N, K in ((E, E), (3 * E, E), (Fd, E), (E, Fd), (E, 3 * E)):
            route = G.gemm_route(rows, N, K)
            t128 = -(-rows // 128) * (N // 128)
            wide, narrow = 2 * -(-t128 // G.SMS), -(-2 * t128 // G.SMS)
            assert route == (64 if narrow <= 0.875 * wide else 128)
    assert G.gemm_route(47280, 3072, 768) == 128 and G.gemm_route(47280, 768, 3072) == 128
    assert G.gemm_route(3992, 2304, 768) == 128 and G.gemm_route(3992, 3072, 768) == 128
    # 192 tiles of 128 columns: two on the busiest SM; 384 of 64 columns: three halves
    assert G.gemm_route(3992, 768, 768) == 64 and G.gemm_route(4096, 768, 3072) == 64
    assert G.gemm_route(130, 768, 768) == 64


def test_gemm_route_takes_wmma_at_the_tiny_widths_and_odd_layouts():
    for cfg in TINY:
        E, Fd = cfg.hidden_size, cfg.intermediate_size
        for N, K in ((E, E), (Fd, E), (E, Fd), (E, 3 * E)):
            assert G.gemm_route(400, N, K) == 0
    assert G.gemm_route(4096, 768, 768, aligned=False) == 0      # a base off a 16-byte boundary
    assert G.gemm_route(4096, 768, 768, lda=772) == 0            # rows off a 16-byte boundary
    assert G.gemm_route(4096, 800, 768) == 0 and G.gemm_route(4096, 768, 800) == 0
    assert G.gemm_route(4096, 192, 768) == 64                    # N a multiple of 64 only


def test_misaligned_view_is_cloned_and_aligned_one_is_not():
    base = torch.zeros(4 * 64 + 8, dtype=torch.bfloat16)
    base = base[(-base.data_ptr() // 2) % 8:]  # starts on a 16-byte boundary
    assert base.data_ptr() % 16 == 0
    same = base[:256].view(4, 64)
    assert G.aligned16(same) is same and G.aligned16(None) is None
    odd = base[1:257].view(4, 64)  # 2 bytes further
    assert odd.data_ptr() % 16 == 2
    fixed = G.aligned16(odd)
    assert fixed is not odd and fixed.data_ptr() % 16 == 0 and torch.equal(fixed, odd)


class _Library:
    """Stands in for the kernel library on the CPU: records each entry
    point's arguments and launches nothing."""

    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        def call(*args):
            self.calls[name] = args
            return 0
        return call


@pytest.mark.parametrize("block", ["attention_block", "ffn_block"])
def test_forward_hands_the_models_weight_storage_to_the_kernel(block, monkeypatch):
    """A ViT layer's f32 weights reach the kernel as their own storage, with
    no transposed copy on the way: q|k|v as the rows of the one weight
    packed in the layer's forward, the out-projection and the FFN's Linears
    as the model's parameters themselves. The layer's calls are recorded on
    the CPU, then given to the block's autograd.Function under a stand-in
    library that records the pointers."""
    seen = {}

    def record(name, fn):
        def call(*args, **kw):
            seen[name] = args
            return fn(*args, **kw)
        return call

    for name in ("attention_block", "ffn_block"):
        monkeypatch.setattr(vit, name, record(name, getattr(vit, name)))
    cfg = ViTConfig.tiny()
    layer = ViTLayer(cfg).eval()
    layer(torch.randn(2, 5, cfg.hidden_size), torch.float32)
    lib = _Library()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)
    x, *ws = seen[block]
    E = cfg.hidden_size
    if block == "attention_block":
        monkeypatch.setattr(ab.attention_block, "launches", ab.attention_block.launches)
        ab.AttentionBlockFn.apply(x, *ws, None, None, None, cfg.num_heads, 0.0, False, 0.0)
        q, k, v, o = layer._attn_layers()
        w_qkv, b_qkv = ws[:2]
        assert torch.equal(w_qkv, torch.cat([q.weight, k.weight, v.weight]))
        assert torch.equal(b_qkv, torch.cat([q.bias, k.bias, v.bias]))
        want = []
        for i in range(3):  # wq, bq, wk, bk, wv, bv: rows of the packed tensors
            want += [w_qkv.data_ptr() + 4 * i * E * E, b_qkv.data_ptr() + 4 * i * E]
        want += [o.weight.data_ptr(), o.bias.data_ptr()]
        assert list(lib.calls["smm_attention_block"][2:10]) == want
    else:
        monkeypatch.setattr(fb.ffn_block, "launches", fb.ffn_block.launches)
        fb.FFNBlockFn.apply(x, *ws, None, None, None, 0.0, False, True, 0.0, 0.0)
        l1, l2 = layer.intermediate.dense, layer.output.dense
        want = [l1.weight.data_ptr(), l1.bias.data_ptr(), l2.weight.data_ptr(),
                l2.bias.data_ptr()]
        assert list(lib.calls["smm_ffn_block"][2:6]) == want


@pytest.mark.parametrize("tanh", [False, True])
def test_gelu_grad_matches_autograd(tanh):
    x = torch.linspace(-6, 6, 241, dtype=torch.float64).requires_grad_()
    F.gelu(x, approximate="tanh" if tanh else "none").sum().backward()
    torch.testing.assert_close(G.gelu_grad(x.detach(), tanh), x.grad.float(), atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("ln_post", [False, True])
def test_plain_gemm_chain_equals_ffn_block_plain(ln_post):
    """ffn_block as the chain the CUDA forward launches (LN, GEMM1 with bias
    + GELU + mid dropout, GEMM2 with bias + out dropout + residual, f32
    before a post-LN), on gemm_plain: equal to ffn_block_plain in f32 at
    1e-5, ragged rows (3 x 37)."""
    g = torch.Generator().manual_seed(0)
    B, S, E, Fd, seed, rate = 3, 37, 64, 128, 5, 0.1
    x = torch.randn(B, S, E, generator=g)
    w1, b1 = torch.randn(Fd, E, generator=g) * E ** -0.5, torch.randn(Fd, generator=g) * 0.1
    w2, b2 = torch.randn(E, Fd, generator=g) * Fd ** -0.5, torch.randn(E, generator=g) * 0.1
    ln = (1 + 0.1 * torch.randn(E, generator=g), 0.1 * torch.randn(E, generator=g), 1e-6)
    want = fb.ffn_block_plain(x, w1, b1, w2, b2, ln=ln, ln_post=ln_post, dropout_rate_mid=rate,
                              dropout_rate_out=rate, dropout_seed=seed)
    rows = x.reshape(B * S, E)
    xin = rows if ln_post else F.layer_norm(rows, (E,), ln[0], ln[1], ln[2])
    h = G.gemm(xin, w1, b1, act="gelu_erf", dropout=(rate, seed, SALT_MID, S))
    y = G.gemm(h, w2, b2, dropout=(rate, seed, SALT_OUT, S), res=rows)
    if ln_post:
        y = F.layer_norm(y, (E,), ln[0], ln[1], ln[2])
    torch.testing.assert_close(y.reshape(B, S, E), want, atol=1e-5, rtol=1e-5)


def test_plain_gemm_dgelu_epilogue_is_the_ffn_backward_of_the_intermediate():
    """dh_pre = gelu'(h_pre) * mask_mid * (dy . W2^T), the FFN backward's
    dh epilogue, on gemm_plain against autograd through the intermediate."""
    g = torch.Generator().manual_seed(1)
    M, E, Fd, S, seed, rate = 74, 32, 64, 37, 9, 0.1
    hpre = torch.randn(M, Fd, generator=g).requires_grad_()
    w2 = torch.randn(Fd, E, generator=g) * Fd ** -0.5
    dy = torch.randn(M, E, generator=g)
    keep = ffn_keep(seed, SALT_MID, M // S, S, Fd, rate).reshape(M, Fd)
    h = torch.where(keep, F.gelu(hpre) / (1 - rate), torch.zeros(()))
    (h @ w2).backward(dy)
    got = G.gemm(dy, w2, act="dgelu_erf", aux=hpre.detach(), dropout=(rate, seed, SALT_MID, S))
    torch.testing.assert_close(got, hpre.grad, atol=1e-5, rtol=1e-5)
