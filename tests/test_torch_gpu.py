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
from simple_multimodal_tpu_torch.train.losses import total_loss
from simple_multimodal_tpu_torch.train.optim import is_backbone_name, make_optimizer

pytestmark = pytest.mark.gpu


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
    rows."""
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
    assert hopper.launch_counts() == {"attention_block": 2, "ffn_block": 3,
                                      "deberta_attention": 1, "attention_block_bwd": 2,
                                      "ffn_block_bwd": 3, "deberta_attention_bwd": 1}


def test_tiny_slice_on_cuda_matches_cpu(cuda, tmp_path):
    """The tiny slice in f32 on the card (kernels) against the CPU (plain
    versions), same weights; one forward launches each kernel once per
    layer that routes through it."""
    cfg = ModelConfig(encoder_preset="tiny", text_max_length=16, audio_max_length=3200,
                      video_max_frames=4, video_frame_size=(32, 32), fusion_hidden_size=32,
                      fusion_num_heads=4, graph_hidden_size=16,
                      data_path=str(tmp_path / "d"), save_path=str(tmp_path / "c"),
                      log_path=str(tmp_path / "l"))
    cpu = create_model(cfg, dtype=torch.float32, generator=torch.Generator().manual_seed(0))
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
    assert hopper.launch_counts() == {"attention_block": (L - 1) + L,
                                      "ffn_block": (L - 1) + L + L,
                                      "deberta_attention": L, "attention_block_bwd": 0,
                                      "ffn_block_bwd": 0, "deberta_attention_bwd": 0}
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
