"""wav2vec2's positional convolution (``ops/hopper/pos_conv.py``) on the CPU:
the plain version against a direct loop over the taps in float64, forward
and gradients; the kernel's weight layout and its mirrored taps for the
input gradient, through the plain emulation of what the kernel computes;
``GroupedConvSameFn`` end to end with that emulation in the kernel's place;
and ``PositionalConvEmbedding`` against the ``F.conv1d`` form it had before
the wrapper. Torch only; the kernel itself is held in
``tests/test_torch_gpu.py``."""
import pytest
import torch
import torch.nn.functional as F

from simple_multimodal_tpu_torch.models.wav2vec2 import PositionalConvEmbedding, Wav2Vec2Config
from simple_multimodal_tpu_torch.ops.attention import gelu
from simple_multimodal_tpu_torch.ops.hopper import pos_conv as pc

# (B, L, G, C_g, K): even and odd K, K > L, C_g of 8, 16 and 24, B > 1
CASES = [(2, 37, 2, 8, 8), (3, 29, 3, 16, 7), (2, 5, 2, 24, 9), (2, 4, 1, 8, 10),
         (1, 19, 2, 16, 1)]


def _inputs(B, L, G, cg, K, dtype=torch.float64, seed=0):
    g = torch.Generator().manual_seed(seed)
    E = G * cg
    x = torch.randn(B, L, E, generator=g, dtype=dtype)
    w = torch.randn(E, cg, K, generator=g, dtype=dtype) * (cg * K) ** -0.5
    bias = torch.randn(E, generator=g, dtype=dtype) * 0.1
    return x, w, bias


def _tap_loop(x, w, bias, G):
    """y[b, t, g·C_g + n] = bias + Σ_k Σ_c x[b, t + k − K//2, g·C_g + c] ·
    w[g·C_g + n, c, k], frames outside the clip read as zeros."""
    B, L, E = x.shape
    cg, K = E // G, w.shape[-1]
    y = bias.expand(B, L, E).clone()
    for k in range(K):
        shift = k - K // 2
        xs = torch.zeros_like(x)
        lo, hi = max(0, -shift), min(L, L - shift)
        if lo < hi:
            xs[:, lo:hi] = x[:, lo + shift:hi + shift]
        for g in range(G):
            sl = slice(g * cg, (g + 1) * cg)
            y[..., sl] = y[..., sl] + torch.einsum("blc,nc->bln", xs[..., sl], w[sl, :, k])
    return y


def _grads(fn, inputs, gy):
    inputs = [t.detach().clone().requires_grad_(True) for t in inputs]
    y = fn(*inputs)
    y.backward(gy)
    return [y.detach()] + [t.grad for t in inputs]


@pytest.mark.parametrize("B,L,G,cg,K", CASES)
def test_plain_matches_tap_loop(B, L, G, cg, K):
    """Forward and all three gradients of the plain version against the
    direct loop over taps, in float64."""
    x, w, bias = _inputs(B, L, G, cg, K)
    gy = torch.randn(B, L, G * cg, generator=torch.Generator().manual_seed(1),
                     dtype=torch.float64)
    got = _grads(lambda *a: pc.grouped_conv_same_plain(*a, G), (x, w, bias), gy)
    want = _grads(lambda *a: _tap_loop(*a, G), (x, w, bias), gy)
    assert got[0].shape == (B, L, G * cg)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-12, rtol=1e-12)


@pytest.mark.parametrize("B,L,G,cg,K", CASES)
def test_tap_layout_both_ways(B, L, G, cg, K):
    """The kernel's contract on the host side: the forward from
    ``tap_layout(w)`` at pad K//2 is the convolution, and the kernel run on
    the cotangent with ``tap_layout(w, backward=True)`` at pad K − 1 − K//2
    is the input gradient (zero-padded to the kernel's width)."""
    x, w, bias = _inputs(B, L, G, cg, K)
    taps = pc.tap_layout(w, G)
    P = pc.tile_width(cg)
    assert taps.shape == (G, K, P // 8, P, 8) and taps.is_contiguous()
    torch.testing.assert_close(pc.conv_taps_plain(x, taps, bias, G, K // 2),
                               _tap_loop(x, w, bias, G), atol=1e-12, rtol=1e-12)
    gy = torch.randn(B, L, G * cg, generator=torch.Generator().manual_seed(2),
                     dtype=torch.float64)
    dx = _grads(lambda a: pc.grouped_conv_same_plain(a, w, bias, G), (x,), gy)[1]
    back = pc.tap_layout(w, G, backward=True)
    torch.testing.assert_close(pc.conv_taps_plain(gy, back, None, G, K - 1 - K // 2), dx,
                               atol=1e-12, rtol=1e-12)
    # the padding of the kernel's width holds zeros
    full = back.permute(0, 1, 3, 2, 4).reshape(G, K, P, P)
    assert not full[:, :, cg:].any() and not full[:, :, :, cg:].any()


@pytest.mark.parametrize("B,L,G,cg,K", CASES)
def test_function_with_the_kernel_emulated(B, L, G, cg, K, monkeypatch):
    """``GroupedConvSameFn`` on the CPU with ``conv_taps_plain`` in the
    kernel's place: y, dx (the kernel on the mirrored taps), dW (the
    weight-gradient call) and dbias against autograd of the plain version;
    one forward and one backward launch counted."""
    monkeypatch.setattr(pc, "_launch", lambda x, taps, bias, groups, pad: pc.conv_taps_plain(
        x, taps, None if bias is None else bias.to(x.dtype), groups, pad))
    x, w, bias = _inputs(B, L, G, cg, K)
    gy = torch.randn(B, L, G * cg, generator=torch.Generator().manual_seed(3),
                     dtype=torch.float64)
    before = (pc.grouped_conv_same.launches, pc.grouped_conv_same_bwd.launches)
    got = _grads(lambda *a: pc.GroupedConvSameFn.apply(*a, G), (x, w, bias), gy)
    assert (pc.grouped_conv_same.launches - before[0],
            pc.grouped_conv_same_bwd.launches - before[1]) == (1, 1)
    want = _grads(lambda *a: pc.grouped_conv_same_plain(*a, G), (x, w, bias), gy)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        torch.testing.assert_close(a, b, atol=1e-12, rtol=1e-12)


def test_tile_width():
    """Widths the kernel pads a group to; 0 where the wrapper raises."""
    assert [pc.tile_width(c) for c in (8, 16, 24, 40, 48, 56, 64, 72, 96, 104, 128)] == [
        16, 16, 32, 48, 48, 64, 64, 96, 96, 128, 128]
    assert [pc.tile_width(c) for c in (0, 4, 12, 47, 136)] == [0] * 5


def _conv1d_form(module, hidden, dtype):
    """PositionalConvEmbedding's forward as it was before the wrapper:
    ``F.conv1d`` on the NCW transpose, the trailing frame sliced off."""
    K, G = module.cfg.pos_conv_kernel, module.cfg.pos_conv_groups
    v = module.conv.weight_v.float()
    norm = v.pow(2).sum(dim=(0, 1), keepdim=True).sqrt()
    w = (module.conv.weight_g * v / norm.clamp_min(1e-12)).to(dtype)
    out = F.conv1d(hidden.to(dtype).transpose(1, 2), w, module.conv.bias.to(dtype),
                   padding=K // 2, groups=G)
    if K % 2 == 0:
        out = out[..., :-1]
    return gelu(out, dtype).transpose(1, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_positional_conv_embedding_unchanged(dtype):
    """At the tiny widths (E = 32, 2 groups of 16, K = 8) the module's output
    and the gradients of its input and three parameters equal the
    ``F.conv1d`` form's."""
    cfg = Wav2Vec2Config.tiny()
    g = torch.Generator().manual_seed(0)
    module = PositionalConvEmbedding(cfg)
    with torch.no_grad():
        module.conv.weight_v.copy_(torch.randn(module.conv.weight_v.shape, generator=g) * 0.1)
        module.conv.weight_g.copy_(torch.rand(module.conv.weight_g.shape, generator=g) + 0.5)
        module.conv.bias.copy_(torch.randn(cfg.hidden_size, generator=g) * 0.1)
    hidden = torch.randn(3, 41, cfg.hidden_size, generator=g)
    gy = torch.randn(3, 41, cfg.hidden_size, generator=g).to(dtype)
    runs = []
    for fn in (module.forward, lambda h, d: _conv1d_form(module, h, d)):
        module.zero_grad()
        h = hidden.clone().requires_grad_(True)
        y = fn(h, dtype)
        y.backward(gy)
        runs.append([y.detach(), h.grad] + [p.grad.clone() for p in module.parameters()])
    assert runs[0][0].shape == (3, 41, cfg.hidden_size) and runs[0][0].dtype == dtype
    for a, b in zip(*runs):
        assert torch.equal(a, b)
