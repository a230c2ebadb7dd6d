"""The port's CUDA kernels and the tiny slice on a GPU. Imports only torch
and the port (the GPU machine has no jax); every test is marked ``gpu`` and
skips where there is no CUDA device. On the card, from the checkout root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -m gpu -q
"""
import numpy as np
import pytest
import torch

from simple_multimodal_tpu_torch.config import ModelConfig
from simple_multimodal_tpu_torch.models.multimodal_model import create_model
from simple_multimodal_tpu_torch.ops import hopper
from simple_multimodal_tpu_torch.ops.hopper import attention_block as ab
from simple_multimodal_tpu_torch.ops.hopper import deberta_attention as da
from simple_multimodal_tpu_torch.ops.hopper import ffn_block as fb
from simple_multimodal_tpu_torch.ops.hopper import flash_attention as fa
from simple_multimodal_tpu_torch.ops.hopper import wav_frontend as wf
from simple_multimodal_tpu_torch.train.losses import total_loss
from simple_multimodal_tpu_torch.train.optim import is_backbone_name, make_optimizer

pytestmark = pytest.mark.gpu


def _counts(**launched):
    """Every kernel's launch count: 0 unless named."""
    return {**{k.__name__: 0 for k in hopper.KERNELS}, **launched}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (sm_90a) and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3), (torch.bfloat16, 3e-2)])
def test_cuda_kernels_match_plain(cuda, dtype, tol):
    """Each CUDA kernel against its plain version (in f32, on the same
    inputs) at small ragged shapes; the bf16 tolerance covers the rounding
    of q/k/v, probabilities, the FFN intermediate and the output."""
    g = torch.Generator(device=cuda).manual_seed(0)

    def rn(*shape, std=1.0):
        return (torch.randn(*shape, generator=g, device=cuda) * std).to(dtype)

    def f32(ts):
        return [t.float() for t in ts]

    def check(got, want):
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got.float(), want, atol=tol, rtol=tol)

    B, S, E, H, F = 3, 77, 128, 2, 256
    x = rn(B, S, E)
    wb = []
    for _ in range(4):
        wb += [rn(E, E, std=E ** -0.5), rn(E, std=0.1)]
    g_ln, b_ln = rn(E, std=0.1) + 1, rn(E, std=0.1)
    ln, ln32 = (g_ln, b_ln, 1e-6), (g_ln.float(), b_ln.float(), 1e-6)
    for use_ln, residual in ((False, False), (True, True)):
        check(ab.attention_block(x, *wb, num_heads=H, ln=ln if use_ln else None,
                                 residual=residual),
              ab.attention_block_plain(x.float(), *f32(wb), num_heads=H,
                                       ln=ln32 if use_ln else None, residual=residual))
    w1, b1, w2, b2 = rn(E, F, std=E ** -0.5), rn(F, std=0.1), rn(F, E, std=F ** -0.5), rn(E)
    for post in (False, True):
        check(fb.ffn_block(x, w1, b1, w2, b2, ln=ln, ln_post=post),
              fb.ffn_block_plain(*f32([x, w1, b1, w2, b2]), ln=ln32, ln_post=post))
    span = 16
    q, k, v = (rn(B, S, H, E // H) for _ in range(3))
    pk, pq = rn(2 * span, E), rn(2 * span, E)
    mask = torch.ones(B, S, dtype=torch.int32, device=cuda)
    mask[1, 40:] = 0
    mask[2] = 0
    check(da.deberta_attention(q, k, v, pk, pq, mask, span=span, max_position=64),
          da.deberta_attention_plain(*f32([q, k, v, pk, pq]), mask, span=span,
                                     max_position=64))


def _with_grads(fn, inputs, gy):
    """fn(*inputs) and the gradient of sum(out * gy) for every input."""
    ins = [t.detach().clone().requires_grad_(t.is_floating_point()) for t in inputs]
    out = fn(*ins)
    out.backward(gy)
    return [out.detach()] + [t.grad for t in ins if t.requires_grad]


def _backward_cases(dev, dtype, rate, g):
    """(name, kernel fn, plain fn, inputs) at small ragged shapes (S = 77,
    B = 3); the fns close over the non-differentiable arguments."""
    def rn(*shape, std=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * std).to(dtype)

    B, S, E, H, Fd, span, seed = 3, 77, 128, 2, 256, 16, 1234
    x = rn(B, S, E)
    wb = []
    for _ in range(4):
        wb += [rn(E, E, std=E ** -0.5), rn(E, std=0.1)]
    lg, lb = rn(E, std=0.1) + 1, rn(E, std=0.1)
    cases = []
    for use_ln, residual in ((False, False), (True, True)):
        def fn(impl, ln_on=use_ln, res=residual):
            def f(x, *w):
                ln = (w[8], w[9], 1e-6) if ln_on else None
                return impl(x, *w[:8], num_heads=H, ln=ln, residual=res,
                            dropout_rate=rate, dropout_seed=seed)
            return f
        cases.append((f"attention_block ln={use_ln}", fn(ab.attention_block),
                      fn(ab.attention_block_plain), [x] + wb + ([lg, lb] if use_ln else [])))
    w1, b1, w2, b2 = rn(E, Fd, std=E ** -0.5), rn(Fd, std=0.1), rn(Fd, E, std=Fd ** -0.5), rn(E)
    for mode in ("pre", "post", "none"):
        def fn(impl, mode=mode):
            def f(x, w1, b1, w2, b2, *ln):
                return impl(x, w1, b1, w2, b2, ln=(ln[0], ln[1], 1e-6) if ln else None,
                            ln_post=mode == "post", residual=True, dropout_rate_mid=rate,
                            dropout_rate_out=rate, dropout_seed=seed)
            return f
        lnp = [] if mode == "none" else [lg, lb]
        cases.append((f"ffn_block {mode}", fn(fb.ffn_block), fn(fb.ffn_block_plain),
                      [x, w1, b1, w2, b2] + lnp))
    mask = torch.ones(B, S, dtype=torch.int32, device=dev)
    mask[1, 40:] = 0
    mask[2] = 0

    def dfn(impl):
        return lambda q, k, v, pk, pq: impl(q, k, v, pk, pq, mask, span=span, max_position=64,
                                            dropout_rate=rate, dropout_seed=seed)
    cases.append(("deberta_attention", dfn(da.deberta_attention), dfn(da.deberta_attention_plain),
                  [rn(B, S, H, E // H) for _ in range(3)] + [rn(2 * span, E), rn(2 * span, E)]))
    # the main path's width (E = 768, 12 heads of 64: in bf16 the wgmma backward
    # kernels) at lengths that are no multiples of the 64-row tiles
    WE, WH = 768, 12
    wide = []
    for _ in range(4):
        wide += [rn(WE, WE, std=WE ** -0.5), rn(WE, std=0.1)]
    wlg, wlb = rn(WE, std=0.1) + 1, rn(WE, std=0.1)
    for WS, use_ln in ((197, True), (499, False)):
        def fn(impl, ln_on=use_ln):
            def f(x, *w):
                ln = (w[8], w[9], 1e-12) if ln_on else None
                return impl(x, *w[:8], num_heads=WH, ln=ln, residual=ln_on,
                            dropout_rate=rate, dropout_seed=seed)
            return f
        cases.append((f"attention_block S={WS} E=768", fn(ab.attention_block),
                      fn(ab.attention_block_plain),
                      [rn(B, WS, WE)] + wide + ([wlg, wlb] if use_ln else [])))
    # DeBERTa-base's shape: log buckets are reached, the random tables are not
    # symmetric (a flipped p2c sign shows), one row is padded, one wholly masked
    LS, wide_span = 512, 256
    long_mask = torch.ones(B, LS, dtype=torch.int32, device=dev)
    long_mask[1, 300:] = 0
    long_mask[2] = 0

    def lfn(impl):
        return lambda q, k, v, pk, pq: impl(q, k, v, pk, pq, long_mask, span=wide_span,
                                            max_position=512, dropout_rate=rate,
                                            dropout_seed=seed)
    cases.append(("deberta_attention S=512", lfn(da.deberta_attention),
                  lfn(da.deberta_attention_plain),
                  [rn(B, LS, WH, 64) for _ in range(3)]
                  + [rn(2 * wide_span, WE), rn(2 * wide_span, WE)]))
    return cases


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3), (torch.bfloat16, 5e-2)])
def test_cuda_backward_kernels_match_autograd_of_plain(cuda, dtype, tol, rate):
    """Each autograd.Function (kernel forward and backward) against
    torch.autograd of its plain version, in f32 on the same (rounded)
    inputs and the same dropout seed: the output and every input gradient
    within tol * max|want| (bf16: the kernels round q/k/v, the
    probabilities, the FFN intermediate and the cotangents). The key-bias
    gradient of attention_block is zero in exact arithmetic (softmax is
    invariant to a per-row shift) and is left as a sum of rounded terms, so
    it is held to tol * max|query-bias gradient|, its sibling over the same
    rows. The body each backward takes is the one ``attention_wgmma_route``
    names: wgmma in bf16 at head width 64, ``attention_bwd.cuh`` in f32."""
    from simple_multimodal_tpu_torch.ops.hopper import _build

    lib = _build.library()
    for rel in (0, 1):
        want_route = int(dtype == torch.bfloat16)
        assert ab.attention_wgmma_route(dtype, 64, bool(rel)) == want_route
        assert lib.smm_attention_wgmma_route(_build.dtype_code(torch.empty(0, dtype=dtype)), 64,
                                           rel) == want_route
    g = torch.Generator(device=cuda).manual_seed(0)
    hopper.reset_launch_counts()
    for name, kern, plain, inputs in _backward_cases(cuda, dtype, rate, g):
        gy = torch.randn(inputs[0].shape, generator=g, device=cuda).to(dtype)
        got = _with_grads(kern, inputs, gy)
        want = _with_grads(plain, [t.float() for t in inputs], gy.float())
        torch.cuda.synchronize()
        assert len(got) == len(want)
        for i, (a, b) in enumerate(zip(got, want)):
            assert torch.isfinite(a).all(), (name, i)
            err = float((a.float() - b).abs().max())
            scale = want[3] if name.startswith("attention_block") and i == 5 else b
            assert err <= tol * float(scale.abs().max()), (name, i, err)
    assert hopper.launch_counts() == _counts(attention_block=4, ffn_block=3,
                                             deberta_attention=2, attention_block_bwd=4,
                                             ffn_block_bwd=3, deberta_attention_bwd=2)


def test_tiny_slice_on_cuda_matches_cpu(cuda, tmp_path):
    """The tiny slice in f32 on the card (kernels) against the CPU (plain
    versions), same weights; one forward launches each kernel once per
    layer that routes through it."""
    cfg = ModelConfig(encoder_preset="tiny", text_max_length=16, audio_max_length=3200,
                      video_max_frames=4, video_frame_size=(32, 32), fusion_hidden_size=32,
                      fusion_num_heads=4, graph_hidden_size=16,
                      data_path=str(tmp_path / "d"), save_path=str(tmp_path / "c"),
                      log_path=str(tmp_path / "l"))
    cpu = create_model(cfg, device="cpu", dtype=torch.float32,
                       generator=torch.Generator().manual_seed(0))
    gpu = create_model(cfg, device=cuda, dtype=torch.float32,
                       generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    text = {"input_ids": torch.randint(1, 1000, (2, 16), generator=gen),
            "attention_mask": torch.ones(2, 16, dtype=torch.int32)}
    text["attention_mask"][1, 9:] = 0
    audio = torch.randn(2, 3200, generator=gen)
    video = torch.randint(0, 256, (2, 4, 32, 32, 3), generator=gen, dtype=torch.uint8)
    hopper.reset_launch_counts()
    with torch.no_grad():
        got = gpu({k: v.to(cuda) for k, v in text.items()}, audio.to(cuda), video.to(cuda))
        want = cpu(text, audio, video)
    L = 2  # tiny preset: two layers per backbone, the ViT's last one CLS-only
    assert hopper.launch_counts() == _counts(attention_block=(L - 1) + L,
                                             ffn_block=(L - 1) + L + L, deberta_attention=L)
    for key in ("text_features", "audio_features", "video_features",
                "emotion_logits", "valence", "arousal"):
        torch.testing.assert_close(got[key].cpu(), want[key], atol=1e-3, rtol=1e-3)


def test_tiny_train_steps_on_cuda_match_cpu(cuda, tmp_path):
    """Two optimizer steps of the tiny model in f32 with dropout off (eval
    mode, gradients on: the composite loss with its contrastive terms) on
    the card (kernels forward and backward) and on the CPU (plain
    versions), from the same weights: losses at 1e-4 relative and every
    parameter after the two updates within 1e-4 (Adam normalises each
    gradient, so the updates magnify gradient rounding near zero)."""
    cfg = ModelConfig(encoder_preset="tiny", text_max_length=16, audio_max_length=3200,
                      video_max_frames=4, video_frame_size=(32, 32), fusion_hidden_size=32,
                      fusion_num_heads=4, graph_hidden_size=16,
                      data_path=str(tmp_path / "d"), save_path=str(tmp_path / "c"),
                      log_path=str(tmp_path / "l"))
    gen = torch.Generator().manual_seed(1)
    text = {"input_ids": torch.randint(1, 1000, (2, 16), generator=gen),
            "attention_mask": torch.ones(2, 16, dtype=torch.int32)}
    text["attention_mask"][1, 9:] = 0
    audio = torch.randn(2, 3200, generator=gen)
    video = torch.randint(0, 256, (2, 4, 32, 32, 3), generator=gen, dtype=torch.uint8)
    labels = torch.tensor([2, 6])
    runs = {}
    for dev in (cuda, torch.device("cpu")):
        model = create_model(cfg, device=dev, dtype=torch.float32,
                             generator=torch.Generator().manual_seed(0))
        opt = make_optimizer(cfg, model, total_steps=10)
        hopper.reset_launch_counts()
        step_losses = []
        for _ in range(2):
            out = model({k: v.to(dev) for k, v in text.items()}, audio.to(dev), video.to(dev),
                        compute_contrastive_loss=True)
            loss, _ = total_loss(out, labels.to(dev))
            for p in opt.params:
                p.grad = None
            loss.backward()
            opt.update([p.grad for p in opt.params])
            step_losses.append(float(loss.detach()))
        runs[dev.type] = (step_losses, {k: v.cpu() for k, v in model.state_dict().items()},
                          hopper.launch_counts())
    L = 2
    assert runs["cuda"][2]["attention_block_bwd"] == 2 * ((L - 1) + L)
    assert runs["cuda"][2]["ffn_block_bwd"] == 2 * ((L - 1) + L + L)
    assert runs["cuda"][2]["deberta_attention_bwd"] == 2 * L
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], rtol=1e-4)
    for k, v in runs["cpu"][1].items():
        torch.testing.assert_close(runs["cuda"][1][k], v, atol=1e-4, rtol=1e-4, msg=k)


def test_backbone_parameters_get_gradients_through_the_kernels(cuda, tmp_path):
    """Every backbone parameter on the kernel path receives a non-zero
    gradient on CUDA: the kernel wrappers are autograd Functions, so the
    graph is not cut at the kernels (the forward-only wrappers returned
    fresh tensors without a grad_fn)."""
    cfg = ModelConfig(encoder_preset="tiny", text_max_length=16, audio_max_length=3200,
                      video_max_frames=4, video_frame_size=(32, 32), fusion_hidden_size=32,
                      fusion_num_heads=4, graph_hidden_size=16,
                      data_path=str(tmp_path / "d"), save_path=str(tmp_path / "c"),
                      log_path=str(tmp_path / "l"))
    model = create_model(cfg, device=cuda, dtype=torch.float32,
                         generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(2)
    text = {"input_ids": torch.randint(1, 1000, (2, 16), generator=gen).to(cuda),
            "attention_mask": torch.ones(2, 16, dtype=torch.int32, device=cuda)}
    out = model(text, torch.randn(2, 3200, generator=gen).to(cuda),
                torch.randint(0, 256, (2, 4, 32, 32, 3), generator=gen,
                              dtype=torch.uint8).to(cuda))
    total_loss(out, torch.tensor([0, 3], device=cuda))[0].backward()
    # every backbone parameter but the two whose gradient is zero here:
    # SpecAugment's embedding (train mode only) and the key biases of the
    # attention_block sites (softmax is invariant to a per-row shift)
    kernel_path = [n for n, _ in model.named_parameters() if is_backbone_name(n)
                   and not n.endswith(("masked_spec_embed", "attention.key.bias",
                                       "k_proj.bias"))]
    assert len(kernel_path) > 50
    for name in kernel_path:
        p = dict(model.named_parameters())[name]
        assert p.grad is not None and bool(p.grad.abs().sum() > 0), name


def _flash_cases(dev, g):
    """(label, q, k, v, biases) at ragged lengths: D = 96 self attention,
    Sq != Sk at D = 64, the small (4 and 8: FMA bodies in bf16 too) and
    large head widths, a [B, 1, 1, Sk]
    key mask (one batch row fully masked), a full bias over that mask, and
    biases that broadcast over batch and heads."""
    def rn(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device=dev) * std

    def qkv(B, Sq, Sk, H, D):
        return rn(B, Sq, H, D), rn(B, Sk, H, D), rn(B, Sk, H, D)

    cases = [("self D=96", *qkv(2, 199, 199, 3, 96), [None]),
             ("cross D=64", *qkv(2, 130, 301, 2, 64), [None]),
             ("D=4", *qkv(2, 70, 90, 8, 4), [None]),
             ("D=8", *qkv(2, 33, 65, 4, 8), [None]),
             ("D=16", *qkv(1, 70, 130, 2, 16), [None]),
             ("D=128", *qkv(1, 130, 257, 2, 128), [None])]
    B, Sq, Sk, H = 2, 100, 141, 3
    mask = torch.zeros(B, 1, 1, Sk, device=dev)
    mask[0, ..., 90:] = -1e30
    full_mask = mask.clone()
    full_mask[1] = -1e30
    biases = [mask, full_mask, rn(B, H, Sq, Sk, std=0.5) + mask,
              rn(1, 1, Sq, Sk, std=0.5), rn(Sq, Sk, std=0.5)]
    cases.append(("biased D=32", *qkv(B, Sq, Sk, H, 32), biases))
    # the wgmma kernels (bf16, D = 64, 96, 128) with every kind of bias and
    # one whose key axis is strided
    cases.append(("biased D=96", *qkv(B, Sq, Sk, H, 96),
                  biases + [rn(B, H, Sk, Sq, std=0.5).transpose(2, 3)]))
    cases.append(("biased D=64", *qkv(B, Sq, Sk, H, 64), [mask, full_mask]))
    # lengths on both sides of the wgmma kernels' 64- and 128-row tiles
    for Sq, Sk, D in ((127, 129, 96), (129, 127, 64), (255, 257, 96), (257, 255, 64),
                      (128, 64, 128), (1, 257, 96)):
        pad = torch.zeros(2, 1, 1, Sk, device=dev)
        pad[1, ..., Sk // 2:] = -1e30
        cases.append((f"ragged {Sq}x{Sk} D={D}", *qkv(2, Sq, Sk, 3, D), [None, pad]))
    return cases


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3), (torch.bfloat16, 5e-2)])
def test_cuda_flash_attention_matches_plain(cuda, dtype, tol):
    """The flash_attention kernels, forward and backward, against autograd
    of the plain version in f32 on the same (rounded) inputs: the output,
    dq, dk, dv and dbias (reduced over the bias's broadcast axes) within
    tol * max|want| (bf16: the kernels round p and ds before the products)."""
    g = torch.Generator(device=cuda).manual_seed(0)
    hopper.reset_launch_counts()
    n = 0
    for label, q, k, v, biases in _flash_cases(cuda, g):
        gy = torch.randn(q.shape, generator=g, device=cuda).to(dtype)
        for bias in biases:
            ins = [t.to(dtype) for t in (q, k, v)] + ([] if bias is None else [bias])
            got = _with_grads(fa.flash_attention, ins, gy)
            want = _with_grads(fa.flash_attention_plain, [t.float() for t in ins], gy.float())
            torch.cuda.synchronize()
            n += 1
            assert len(got) == len(want) == len(ins) + 1
            for i, (a, b) in enumerate(zip(got, want)):
                assert a.shape == b.shape and torch.isfinite(a).all(), (label, i)
                err = float((a.float() - b).abs().max())
                assert err <= tol * float(b.abs().max()), (label, i, err)
    assert hopper.launch_counts() == _counts(flash_attention=n, flash_attention_bwd=n)


def test_cuda_flash_attention_backward_is_bit_equal_between_runs(cuda):
    """Every output tile is summed by one block in a fixed order (no
    atomics): two backward runs on the same inputs give the same bits in dq,
    dk, dv and dbias, for the wgmma (bf16), WMMA (bf16, D = 32) and FMA
    (f32) bodies."""
    g = torch.Generator(device=cuda).manual_seed(3)
    for dtype, D in ((torch.bfloat16, 96), (torch.bfloat16, 64), (torch.bfloat16, 32),
                     (torch.float32, 96)):
        q, k, v = (torch.randn(2, n, 3, D, generator=g, device=cuda).to(dtype).requires_grad_()
                   for n in (257, 191, 191))
        bias = torch.randn(2, 3, 257, 191, generator=g, device=cuda).requires_grad_()
        gy = torch.randn(2, 257, 3, D, generator=g, device=cuda).to(dtype)
        runs = [torch.autograd.grad(fa.flash_attention(q, k, v, bias), [q, k, v, bias], gy)
                for _ in range(2)]
        torch.cuda.synchronize()
        for name, a, b in zip(("dq", "dk", "dv", "dbias"), *runs):
            assert torch.equal(a, b), (dtype, D, name)


def test_cuda_hopper_building_blocks_are_exact(cuda):
    """csrc/hopper.cuh on small integer cases, compared for equality: wgmma
    with A and B from shared memory (K-major, through TMA and the 64-byte
    swizzle), the accumulator packed as the next product's A registers with
    an MN-major B, for N = 64, 96, 128; and the swizzle helpers (32, 64, 128 bytes) against
    what TMA writes, zeros past the edge included."""
    from simple_multimodal_tpu_torch.ops.hopper.selftest import WIDTHS, hopper_selftest

    done = hopper_selftest(cuda)
    assert all(done.values())
    assert {f"wgmma_{k}_n{n}" for k in ("ss", "rs") for n in WIDTHS} <= set(done)


def test_cuda_flash_attention_reads_strided_rows(cuda):
    """q, k and v as column blocks of one packed [B, S, 3, H, D] projection:
    read in place through their token strides."""
    g = torch.Generator(device=cuda).manual_seed(1)
    packed = torch.randn(2, 150, 3, 2, 64, generator=g, device=cuda)
    q, k, v = packed[:, :, 0], packed[:, :, 1], packed[:, :, 2]
    assert not q.is_contiguous() and fa._rows(q) is q
    torch.testing.assert_close(fa.flash_attention(q, k, v), fa.flash_attention_plain(q, k, v),
                               atol=1e-3, rtol=1e-3)
    # the same through the wgmma kernels' tensor maps (bf16), at D = 64 and 96
    for H, D in ((2, 64), (3, 96)):
        packed = torch.randn(2, 150, 3, H, D, generator=g, device=cuda).to(torch.bfloat16)
        q, k, v = packed[:, :, 0], packed[:, :, 1], packed[:, :, 2]
        assert fa._rows(q) is q and fa._rows(v) is v
        want = fa.flash_attention_plain(q.float(), k.float(), v.float())
        torch.testing.assert_close(fa.flash_attention(q, k, v).float(), want, atol=3e-2, rtol=3e-2)
        # a bias constant along the keys (copied for these kernels; its gradient is zero)
        row_bias = torch.randn(2, H, 150, 1, generator=g, device=cuda)
        want = fa.flash_attention_plain(q.float(), k.float(), v.float(), row_bias)
        torch.testing.assert_close(fa.flash_attention(q, k, v, row_bias).float(), want,
                                   atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3), (torch.bfloat16, 3e-2)])
def test_cuda_wav_frontend_matches_plain(cuda, dtype, tol):
    """Both passes against the plain version (f32 on the rounded inputs) at
    lengths whose last block is ragged, at C = 512 and the tiny preset's
    C = 16; bf16: one rounding of y, of the output, and the tanh GELU. The
    gradients are autograd of the plain version, so they agree up to the
    summation order of cuDNN's weight gradient, which varies from run to run:
    each within 1e-3 of its largest magnitude."""
    g = torch.Generator(device=cuda).manual_seed(0)
    hopper.reset_launch_counts()
    for B, T, C in ((2, 4003, 512), (3, 645, 512), (2, 16000, 16)):
        wav = torch.randn(B, T, generator=g, device=cuda) * 0.3
        kern = (torch.randn(10, 1, C, generator=g, device=cuda) * 0.1).to(dtype)
        gs = torch.randn(C, generator=g, device=cuda) * 0.2 + 1
        gb = torch.randn(C, generator=g, device=cuda) * 0.1
        got = wf.wav_frontend(wav, kern, gs, gb, 5)
        want = wf.wav_frontend_plain(wav.to(dtype).float(), kern.float(), gs, gb, 5)
        assert got.dtype == dtype and got.shape == (B, (T - 10) // 5 + 1, C)
        torch.testing.assert_close(got.float(), want, atol=tol, rtol=tol)
    ins = [wav, kern.float(), gs, gb]
    gy = torch.randn(2, 3199, 16, generator=g, device=cuda)
    got = _with_grads(lambda *a: wf.wav_frontend(*a, 5), ins, gy)
    want = _with_grads(lambda *a: wf.wav_frontend_plain(*a, 5), ins, gy)
    for a, b in zip(got[1:], want[1:]):
        assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max())
    assert hopper.launch_counts() == _counts(wav_frontend=4)
    with pytest.raises(ValueError, match="stride"):
        wf.wav_frontend(wav, kern, gs, gb, 3)
    with pytest.raises(ValueError, match="C = 24"):
        wf.wav_frontend(wav, kern[..., :8].repeat(1, 1, 3), gs[:24], gb[:24], 5)


def test_tiny_long_clip_on_cuda_matches_cpu(cuda, tmp_path, monkeypatch):
    """The tiny model on a clip of 519 wav2vec2 frames with the fused front
    end on, f32, eval mode with gradients: card (flash_attention forward and
    backward, wav_frontend) against CPU (plain versions): outputs at 1e-3,
    the loss at 1e-4 relative, every gradient within 1e-3 of its largest
    magnitude (plus 1e-6 for the leaves that are zero in exact arithmetic)."""
    monkeypatch.setenv("SMM_WAV_FRONTEND", "1")
    cfg = ModelConfig(encoder_preset="tiny", text_max_length=16, audio_max_length=166400,
                      video_max_frames=4, video_frame_size=(32, 32), fusion_hidden_size=32,
                      fusion_num_heads=4, graph_hidden_size=16, fusion_dropout=0.0,
                      data_path=str(tmp_path / "d"), save_path=str(tmp_path / "c"),
                      log_path=str(tmp_path / "l"))
    gen = torch.Generator().manual_seed(1)
    text = {"input_ids": torch.randint(1, 1000, (2, 16), generator=gen),
            "attention_mask": torch.ones(2, 16, dtype=torch.int32)}
    audio = torch.randn(2, 166400, generator=gen) * 0.3
    video = torch.randint(0, 256, (2, 4, 32, 32, 3), generator=gen, dtype=torch.uint8)
    runs = {}
    for dev in (cuda, torch.device("cpu")):
        model = create_model(cfg, device=dev, dtype=torch.float32,
                             generator=torch.Generator().manual_seed(0))
        hopper.reset_launch_counts()
        out = model({k: v.to(dev) for k, v in text.items()}, audio.to(dev), video.to(dev),
                    compute_contrastive_loss=True)
        loss, _ = total_loss(out, torch.tensor([2, 6], device=dev))
        loss.backward()
        runs[dev.type] = (out, float(loss.detach()),
                          {n: p.grad.cpu() for n, p in model.named_parameters()
                           if p.grad is not None}, hopper.launch_counts())
    L = 2
    assert runs["cuda"][3] == _counts(
        attention_block=(L - 1) + L, ffn_block=(L - 1) + L + L, deberta_attention=L,
        flash_attention=1, wav_frontend=1, attention_block_bwd=(L - 1) + L,
        ffn_block_bwd=(L - 1) + L + L, deberta_attention_bwd=L, flash_attention_bwd=1)
    assert runs["cpu"][3] == _counts()
    for key in ("text_features", "audio_features", "video_features", "emotion_logits"):
        torch.testing.assert_close(runs["cuda"][0][key].detach().cpu(),
                                   runs["cpu"][0][key].detach(), atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(runs["cuda"][1], runs["cpu"][1], rtol=1e-4)
    assert set(runs["cuda"][2]) == set(runs["cpu"][2])
    for name, want in runs["cpu"][2].items():
        err = float((runs["cuda"][2][name] - want).abs().max())
        assert err <= 1e-3 * float(want.abs().max()) + 1e-6, (name, err)


def test_cuda_gemm_matches_plain_at_ragged_shapes(cuda):
    """The GEMM entry (``smm_gemm``) in bf16 against the plain f32 expression
    on the same inputs, every epilogue variant, at shapes that take the wgmma
    kernel with 64-column tiles (rows ragged in the last 128-row tile), with
    128-column tiles, and the WMMA kernel (N no multiple of 64); the route
    the library reports equals ``gemm_route``. bf16 outputs at 3e-2 (one
    rounding of the f32 sum), f32 outputs at 1e-3; dropped elements are
    exactly zero at ``dropout.ffn_keep``'s positions."""
    from simple_multimodal_tpu_torch.ops.hopper import _build
    from simple_multimodal_tpu_torch.ops.hopper import gemm as G
    from simple_multimodal_tpu_torch.ops.hopper.dropout import ffn_keep

    g = torch.Generator(device=cuda).manual_seed(0)
    bf16, f32, S = torch.bfloat16, torch.float32, 77

    def rn(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device=cuda) * std

    lib = _build.library()
    for (M, N, K), route in (((300, 192, 128), 64), ((130, 768, 768), 64),
                             ((16890, 256, 64), 128), ((300, 96, 128), 0)):
        a, w = rn(M, K).to(bf16), rn(N, K, std=K ** -0.5).to(bf16)
        bias, res, aux = rn(N, std=0.1).to(bf16), rn(M, N).to(bf16), rn(M, N)
        assert G.gemm_route(M, N, K) == route
        assert lib.smm_gemm_route(a.data_ptr(), K, w.data_ptr(), K, bias.data_ptr(), None, 0,
                                  res.data_ptr(), N, None, M, N, K) == route
        for kw in (dict(bias=bias), dict(bias=bias, act="gelu_tanh", dropout=(0.1, 5, 1, S)),
                   dict(bias=bias, dropout=(0.1, 5, 2, S), res=res, out_dtype=f32),
                   dict(res=res.float()), dict(act="dgelu_tanh", aux=aux, dropout=(0.1, 5, 1, S))):
            got = G.gemm(a, w, **kw)
            want = G.gemm_plain(a, w, **{**kw, "out_dtype": f32})
            torch.cuda.synchronize()
            tol = 1e-3 if kw.get("out_dtype") == f32 else 3e-2
            assert got.dtype == kw.get("out_dtype", bf16) and torch.isfinite(got).all()
            torch.testing.assert_close(got.float(), want, atol=tol, rtol=tol)
            if "dropout" in kw:
                rate, seed, salt, _ = kw["dropout"]
                keep = ffn_keep(seed, salt, -(-M // S), S, N, rate, device=cuda).reshape(-1, N)[:M]
                resf = res.float() if "res" in kw else 0.0
                shown = got.float() - resf
                assert not bool((~keep & (shown != 0)).any())
                assert not bool((keep & (shown == 0) & ((want - resf).abs() > 1e-4)).any())
    # a view that starts off a 16-byte boundary is copied, not refused
    odd = torch.zeros(300 * 128 + 1, dtype=bf16, device=cuda)[1:].view(300, 128)
    odd.copy_(rn(300, 128))
    w = rn(192, 128, std=0.1).to(bf16)
    torch.testing.assert_close(G.gemm(odd, w).float(), G.gemm_plain(odd, w, out_dtype=f32),
                               atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("E,H,Fd", [(128, 2, 256), (768, 12, 3072), (256, 2, 512),
                                    (96, 3, 160)])
def test_cuda_blocks_with_dropout_are_bit_equal_between_runs(cuda, E, H, Fd):
    """attention_block and ffn_block in bf16 with hash dropout: two runs on
    the same inputs and seed give the same bits, and another seed does not
    (widths 128 and 768: the wgmma GEMM and the wgmma core at head width 64;
    256: the same at head width 128; width 96: the WMMA kernels). Against
    the plain version at 3e-2. The same for the gradients of attention_block
    and of deberta_attention (dq, dk, dv and both tables' cotangents): no
    output is summed with atomics."""
    g = torch.Generator(device=cuda).manual_seed(2)
    bf16 = torch.bfloat16

    def rn(*shape, std=1.0):
        return (torch.randn(*shape, generator=g, device=cuda) * std).to(bf16)

    B, S = 3, 197
    x = rn(B, S, E)
    wb = []
    for _ in range(4):
        wb += [rn(E, E, std=E ** -0.5), rn(E, std=0.1)]
    ln = (rn(E, std=0.1) + 1, rn(E, std=0.1), 1e-6)
    w1, b1, w2, b2 = rn(E, Fd, std=E ** -0.5), rn(Fd, std=0.1), rn(Fd, E, std=Fd ** -0.5), rn(E)

    def attn(seed):
        return ab.attention_block(x, *wb, num_heads=H, ln=ln, residual=True, dropout_rate=0.1,
                                  dropout_seed=seed)

    def ffn(seed):
        return fb.ffn_block(x, w1, b1, w2, b2, ln=ln, dropout_rate_mid=0.1,
                            dropout_rate_out=0.1, dropout_seed=seed)

    for fn in (attn, ffn):
        first, second, other = fn(11), fn(11), fn(12)
        torch.cuda.synchronize()
        assert torch.equal(first, second)
        assert not torch.equal(first, other)

    def attn_grads(seed):
        ins = [t.detach().clone().requires_grad_() for t in [x] + wb + [ln[0], ln[1]]]
        out = ab.attention_block(ins[0], *ins[1:9], num_heads=H, ln=(ins[9], ins[10], 1e-6),
                                 residual=True, dropout_rate=0.1, dropout_seed=seed)
        return torch.autograd.grad(out, ins, gy)

    D, span = E // H, 64
    qkv = [rn(B, S, H, D) for _ in range(3)] + [rn(2 * span, E), rn(2 * span, E)]
    mask = torch.ones(B, S, dtype=torch.int32, device=cuda)
    mask[1, 120:] = 0
    mask[2] = 0

    def deberta_grads(seed):
        ins = [t.detach().clone().requires_grad_() for t in qkv]
        out = da.deberta_attention(*ins, mask, span=span, max_position=256, dropout_rate=0.1,
                                   dropout_seed=seed)
        return torch.autograd.grad(out, ins, gy.reshape(B, S, H, D))

    gy = rn(B, S, E)
    for fn in (attn_grads,) + ((deberta_grads,) if D in (16, 32, 64) else ()):
        first, second, other = fn(11), fn(11), fn(12)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, second))
        assert not all(torch.equal(a, b) for a, b in zip(first, other))
    ln32 = (ln[0].float(), ln[1].float(), 1e-6)
    want = ab.attention_block_plain(x.float(), *[t.float() for t in wb], num_heads=H, ln=ln32,
                                    residual=True, dropout_rate=0.1, dropout_seed=11)
    torch.testing.assert_close(attn(11).float(), want, atol=3e-2, rtol=3e-2)
    want = fb.ffn_block_plain(*[t.float() for t in (x, w1, b1, w2, b2)], ln=ln32,
                              dropout_rate_mid=0.1, dropout_rate_out=0.1, dropout_seed=11)
    torch.testing.assert_close(ffn(11).float(), want, atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("ln_mode", ["none", "pre", "post"])
def test_cuda_ffn_backward_matches_its_plain_chain(cuda, ln_mode):
    """The wgmma chain of the FFN backward (bf16, E in multiples of 64, F of 128)
    with both dropouts at ragged rows (3 x 45 = 135) against
    ``ffn_block_bwd_plain``, the same chain step by step in PyTorch on the
    same bf16 inputs: every gradient within 5e-2 of its largest magnitude."""
    g = torch.Generator(device=cuda).manual_seed(3)
    B, S, E, Fd = 3, 45, 128, 256

    def rn(*shape, std=1.0):
        return (torch.randn(*shape, generator=g, device=cuda) * std).to(torch.bfloat16)

    args = [rn(B, S, E), rn(E, Fd, std=E ** -0.5), rn(Fd, std=0.1), rn(Fd, E, std=Fd ** -0.5),
            rn(E, std=0.1)]
    lnp = [(1.0 + rn(E, std=0.1).float()).to(torch.bfloat16), rn(E, std=0.1)]
    if ln_mode != "none":
        args += lnp
    args = [a.requires_grad_() for a in args]
    gy = rn(B, S, E)
    kw = dict(ln_post=ln_mode == "post", residual=True, dropout_rate_mid=0.1,
              dropout_rate_out=0.1, dropout_seed=7)
    ln = None if ln_mode == "none" else (args[5], args[6], 1e-5)
    assert fb.ffn_bwd_route(torch.bfloat16, E, Fd) == 1
    out = fb.ffn_block(*args[:5], ln=ln, **kw)
    got = torch.autograd.grad(out, args, gy)
    want = fb.ffn_block_bwd_plain(*[a.detach() for a in args[:5]], gy, ln=None if ln is None else (
        args[5].detach(), args[6].detach(), 1e-5), **kw)
    for i, (a, b) in enumerate(zip(got, want)):
        ref = float(b.float().abs().max())
        assert float((a.float() - b.float()).abs().max()) <= 5e-2 * ref, f"gradient {i}"


@pytest.mark.parametrize("S", [130, 512])
def test_cuda_deberta_training_forward_equals_eval_forward(cuda, S):
    """bf16 at head width 64: the forward that keeps its row statistics for
    the backward gives the eval forward's bits, padded and all-masked rows
    included, and its gradients match autograd of the plain version."""
    g = torch.Generator(device=cuda).manual_seed(4)
    B, H, D, span = 3, 2, 64, 256
    q, k, v = (torch.randn(B, S, H, D, generator=g, device=cuda).to(torch.bfloat16)
               for _ in range(3))
    pk, pq = (torch.randn(2 * span, H * D, generator=g, device=cuda).to(torch.bfloat16)
              for _ in range(2))
    mask = torch.ones(B, S, dtype=torch.int32, device=cuda)
    mask[1, S // 2:] = 0
    mask[2] = 0
    kw = dict(span=span, max_position=512, dropout_rate=0.1, dropout_seed=11)
    with torch.no_grad():
        ev = da.deberta_attention(q, k, v, pk, pq, mask, **kw)
    ts = [t.clone().requires_grad_() for t in (q, k, v, pk, pq)]
    out = da.deberta_attention(*ts, mask, **kw)
    assert torch.equal(out, ev)
    gy = torch.randn(out.shape, generator=g, device=cuda).to(torch.bfloat16)
    got = torch.autograd.grad(out, ts, gy)
    t32 = [t.detach().float().requires_grad_() for t in ts]
    want = torch.autograd.grad(da.deberta_attention_plain(*t32, mask, **kw), t32, gy.float())
    for a, b in zip(got, want):
        assert float((a.float() - b).abs().max()) <= 5e-2 * float(b.abs().max())
