"""The port's CUDA kernels and the tiny slice on a GPU. Imports only torch
and the port (the GPU machine has no jax); every test is marked ``gpu`` and
skips where there is no CUDA device. On the card, from the checkout root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -m gpu -q
"""
import pytest
import torch

from simple_multimodal_tpu_torch.config import ModelConfig
from simple_multimodal_tpu_torch.models.multimodal_model import create_model
from simple_multimodal_tpu_torch.ops import hopper
from simple_multimodal_tpu_torch.ops.hopper import attention_block as ab
from simple_multimodal_tpu_torch.ops.hopper import deberta_attention as da
from simple_multimodal_tpu_torch.ops.hopper import ffn_block as fb

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
                                      "deberta_attention": L}
    for key in ("text_features", "audio_features", "video_features",
                "emotion_logits", "valence", "arousal"):
        torch.testing.assert_close(got[key].cpu(), want[key], atol=1e-3, rtol=1e-3)
