"""The port's entry points run on the card unless the caller asks for the
CPU: ``create_model``, the checkpoint loader (``load_pretrained_model``,
listed as ``load_checkpoint``) and ``MultimodalEmotionDemo``
default to ``device="cuda"`` and raise without a CUDA device instead of
carrying on on the CPU; with ``device="cpu"`` they work as before. Also the
host-side helper that decides which rows the flash_attention kernels (and
their tensor maps) can read in place.
"""
import pytest
import torch

from simple_multimodal_tpu_torch.config import ModelConfig
from simple_multimodal_tpu_torch.models.multimodal_model import (
    create_model, load_pretrained_model,
)
from simple_multimodal_tpu_torch.ops.attention import require_device, resolve_dtype
from simple_multimodal_tpu_torch.ops.hopper import flash_attention as fa
from simple_multimodal_tpu_torch.serving.demo import (
    MultimodalEmotionDemo, save_checkpoint,
)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("entry")
    cfg = ModelConfig(encoder_preset="tiny", text_max_length=16, audio_max_length=3200,
                      video_max_frames=4, video_frame_size=(32, 32), fusion_hidden_size=32,
                      fusion_num_heads=4, graph_hidden_size=16,
                      data_path=str(tmp / "d"), save_path=str(tmp / "c"),
                      log_path=str(tmp / "l"))
    cfg.fusion_type = "hierarchical"
    model = create_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    ckpt = str(tmp / "model")
    save_checkpoint(ckpt, model, cfg)
    return cfg, model, ckpt


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


ENTRY_POINTS = {
    "create_model": lambda cfg, model, ckpt, **kw: create_model(cfg, **kw),
    "load_checkpoint": lambda cfg, model, ckpt, **kw: load_pretrained_model(ckpt, **kw)[0],
    "demo_from_model": lambda cfg, model, ckpt, **kw: MultimodalEmotionDemo(
        model=model, config=cfg, **kw).model,
    "demo_from_checkpoint": lambda cfg, model, ckpt, **kw: MultimodalEmotionDemo(
        checkpoint_path=ckpt, **kw).model,
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_without_a_card_raises_and_names_the_cpu(tiny, no_cuda, name):
    with pytest.raises(RuntimeError, match=r'no CUDA device.*device="cpu"'):
        ENTRY_POINTS[name](*tiny)


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_on_the_cpu_when_asked(tiny, no_cuda, name):
    model = ENTRY_POINTS[name](*tiny, device="cpu")
    assert not model.training and model.dtype == torch.float32
    assert {p.device.type for p in model.parameters()} == {"cpu"}


def test_default_device_is_the_card_and_its_dtype_bf16(tiny, no_cuda):
    cfg = tiny[0]
    assert resolve_dtype(cfg, "cuda") == torch.bfloat16
    assert resolve_dtype(cfg, "cpu") == torch.float32
    assert require_device("cpu", "x") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="create_model: no CUDA device"):
        create_model(cfg)
    with pytest.raises(RuntimeError, match="cuda:1"):
        require_device("cuda:1", "x")


def test_demo_on_the_cpu_answers_a_request(tiny):
    cfg, model, ckpt = tiny
    demo = MultimodalEmotionDemo(checkpoint_path=ckpt, device="cpu")
    assert demo.device == torch.device("cpu")
    dist = demo.predict("I am fine.", None, None)["emotion_distribution"]
    assert abs(sum(dist.values()) - 1.0) < 1e-5


@pytest.mark.parametrize("D,H", [(96, 8), (64, 12), (128, 2)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_rows_read_packed_projections_in_place(D, H, dtype):
    """q, k, v as blocks of one packed [B, S, 3, H, D] projection keep their
    storage (token stride 3·H·D, a multiple of 16 bytes; head h at column
    h·D): what the kernels and their tensor maps read. Rows that are not
    dense, or not 16-byte aligned, are copied."""
    B, S = 2, 37
    packed = torch.zeros(B, S, 3, H, D, dtype=dtype)
    for i in range(3):
        t = packed[:, :, i]
        rows = fa._rows(t)
        assert rows is t and not t.is_contiguous()
        assert rows.stride() == (S * 3 * H * D, 3 * H * D, D, 1)
        assert (rows.stride(1) * rows.element_size()) % 16 == 0
        assert rows.data_ptr() % 16 == 0
        vals = list(fa._strides(rows))
        assert vals == [S * 3 * H * D, 3 * H * D, 0, 0, 0, 0]
    heads_first = torch.zeros(B, H, S, D, dtype=dtype).transpose(1, 2)  # [B, S, H, D] view
    copy = fa._rows(heads_first)
    assert copy is not heads_first and copy.is_contiguous()
    odd = torch.zeros(B * S * H * D + 1, dtype=dtype)[1:].view(B, S, H, D)
    assert fa._rows(odd) is not odd  # 2- or 4-byte offset: not 16-byte aligned


def test_flash_bias_strides_are_zero_on_broadcast_axes():
    B, H, Sq, Sk = 2, 3, 5, 7
    q = torch.zeros(B, Sq, H, 8)
    mask = torch.zeros(B, 1, 1, Sk).expand(B, H, Sq, Sk)
    assert list(fa._strides(q, bias=mask))[2:] == [Sk, 0, 0, 1]
    full = torch.zeros(B, H, Sq, Sk)
    assert list(fa._strides(q, bias=full))[2:] == [H * Sq * Sk, Sq * Sk, Sk, 1]


@pytest.mark.parametrize("dtype,D,copied", [(torch.bfloat16, 96, True), (torch.bfloat16, 64, True),
                                            (torch.bfloat16, 32, False),
                                            (torch.float32, 96, False)])
def test_flash_kernel_bias_has_key_stride_one_for_the_wgmma_kernels(dtype, D, copied):
    """bf16 at D = 64, 96, 128 runs kernels that read the bias with a key
    stride of 1: a bias strided or broadcast along the keys is copied for
    them, any other reaches the kernel through its strides, nothing
    materialised."""
    B, H, Sq, Sk = 2, 3, 5, 7
    q = torch.zeros(B, Sq, H, D, dtype=dtype)
    assert fa._kernel_bias(None, q, Sk) is None
    mask = torch.zeros(B, 1, 1, Sk)
    got = fa._kernel_bias(mask, q, Sk)
    assert got.shape == (B, H, Sq, Sk) and got.stride() == (Sk, 0, 0, 1)
    assert got.data_ptr() == mask.data_ptr()
    for bias in (torch.arange(B * H * Sq, dtype=torch.float32).view(B, H, Sq, 1),
                 torch.arange(Sk * Sq, dtype=torch.float32).view(Sk, Sq).T):
        got = fa._kernel_bias(bias, q, Sk)
        assert got.shape == (B, H, Sq, Sk) and got.dtype == torch.float32
        assert torch.equal(got, bias.expand(B, H, Sq, Sk))
        assert (got.stride(3) == 1) == copied
        assert (got.data_ptr() != bias.data_ptr()) == copied
