"""The port's weight I/O on the CPU against the JAX package's: the
safetensors reader and writer (``models/safetensors_io.py``, no
``safetensors`` package) against JAX's and against the ``safetensors``
package; HF backbones (tiny ``transformers`` models from tests/ref_torch.py)
imported by both packages' ``load_pretrained_backbones``; and
``tools/convert_checkpoint_torch.py`` / ``tools/import_hf_backbones_torch.py``
against JAX's ``convert_multimodal_model``.
"""
import dataclasses
import importlib.util
import json
from pathlib import Path

import jax
import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors.torch import load_file as st_load_file
from safetensors.torch import save_file as st_save_file

from ref_torch import TINY, AudioEncoderT, RefModelT, TextEncoderT, VideoEncoderT
from simple_multimodal_tpu.config import config_to_dict
from simple_multimodal_tpu.models import MultimodalEmotionModel
from simple_multimodal_tpu.models import safetensors_io as jio
from simple_multimodal_tpu.models.convert_full import convert_multimodal_model
from simple_multimodal_tpu_torch import config as pconfig
from simple_multimodal_tpu_torch.models import safetensors_io as pio
from simple_multimodal_tpu_torch.models.from_jax import state_dict_from_jax
from simple_multimodal_tpu_torch.models.multimodal_model import (
    MultimodalEmotionModel as PortModel, load_pretrained_model)
from simple_multimodal_tpu_torch.train import checkpoint

ROOT = Path(__file__).resolve().parents[1]


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


convert_tool = _load("convert_checkpoint_torch", "tools/convert_checkpoint_torch.py")
import_tool = _load("import_hf_backbones_torch", "tools/import_hf_backbones_torch.py")


def _arrays():
    rng = np.random.default_rng(0)
    return {
        "a.f32": rng.standard_normal((3, 5)).astype(np.float32),
        "b.bf16": rng.standard_normal((4, 2)).astype(ml_dtypes.bfloat16),
        "c.i32": rng.integers(-9, 9, (7,)).astype(np.int32),
        "d.f16": rng.standard_normal((2, 2, 2)).astype(np.float16),
        "e.bool": np.array([True, False]),
        "f.i64": rng.integers(-9, 9, (2, 3)).astype(np.int64),
        "g.u8": rng.integers(0, 255, (5,)).astype(np.uint8),
        "h.0d": np.float32(3.25).reshape(()),
        "i.empty": np.zeros((0, 3), np.float32),
    }


def _torch(a: np.ndarray) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def test_writer_bytes_equal_jax_and_reads_equal_the_package(tmp_path):
    arrays = {k: v for k, v in _arrays().items() if k != "b.bf16"}  # numpy has no bf16
    jio.save_safetensors(arrays, str(tmp_path / "j.safetensors"), metadata={"format": "pt"})
    pio.save_safetensors(arrays, str(tmp_path / "p.safetensors"), metadata={"format": "pt"})
    assert (tmp_path / "j.safetensors").read_bytes() == (tmp_path / "p.safetensors").read_bytes()
    # bf16 goes in as a torch tensor: the same bytes as JAX's ml_dtypes array
    full = _arrays()
    jio.save_safetensors(full, str(tmp_path / "j2.safetensors"))
    pio.save_safetensors({k: (_torch(v) if k == "b.bf16" else v) for k, v in full.items()},
                         str(tmp_path / "p2.safetensors"))
    assert (tmp_path / "j2.safetensors").read_bytes() == (tmp_path / "p2.safetensors").read_bytes()


@pytest.mark.parametrize("name", list(_arrays()))
def test_read_equals_the_safetensors_package_and_jax(tmp_path, name):
    value = _torch(_arrays()[name])
    path = str(tmp_path / "t.safetensors")
    st_save_file({name: value.contiguous()}, path)
    got = pio.load_safetensors(path)[name]
    want = st_load_file(path)[name]
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)
    jax_read = np.asarray(jio.load_safetensors(path)[name])
    assert torch.equal(_torch(jax_read).reshape(got.shape), got)


def test_sharded_index_and_prefix_strip_equal_jax(tmp_path):
    torch.manual_seed(0)
    sd = {f"deberta.{k}": v.contiguous() for k, v in TextEncoderT(TINY).model.state_dict().items()}
    keys = sorted(sd)
    half = len(keys) // 2
    weight_map = {}
    for i, part in enumerate((keys[:half], keys[half:])):
        shard = f"model-0000{i + 1}-of-00002.safetensors"
        st_save_file({k: sd[k] for k in part}, str(tmp_path / shard))
        weight_map.update(dict.fromkeys(part, shard))
    (tmp_path / "model.safetensors.index.json").write_text(json.dumps({"weight_map": weight_map}))
    got = pio.load_state_dict(str(tmp_path))
    want = jio.load_state_dict(str(tmp_path))
    assert list(got) == list(want) and "embeddings.word_embeddings.weight" in got
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)


@pytest.fixture(scope="module")
def hf_files(tmp_path_factory):
    """Tiny HF backbones of the reference's classes, random weights from a
    seed, saved as HF-named safetensors (the task-model prefixes on two)."""
    root = tmp_path_factory.mktemp("hf")
    torch.manual_seed(0)
    files = {}
    for name, module, prefix in (("text", TextEncoderT(TINY).model, "deberta."),
                                 ("audio", AudioEncoderT(TINY).model, "wav2vec2."),
                                 ("video", VideoEncoderT(TINY).vit, "")):
        path = root / f"{name}.safetensors"
        st_save_file({prefix + k: v.contiguous() for k, v in module.state_dict().items()},
                     str(path))
        files[name] = str(path)
    return files


def _inputs(cfg, B=2):
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 120000, (B, cfg.text_max_length)).astype(np.int32)
    mask = np.ones((B, cfg.text_max_length), np.int32)
    mask[1, 10:] = 0
    audio = rng.standard_normal((B, cfg.audio_max_length)).astype(np.float32)
    video = rng.random((B, cfg.video_max_frames, 32, 32, 3)).astype(np.float32)
    return ids, mask, audio, video


def _port_out(model, ids, mask, audio, video):
    with torch.no_grad():
        return model.eval()({"input_ids": torch.from_numpy(ids),
                             "attention_mask": torch.from_numpy(mask)},
                            torch.from_numpy(audio), torch.from_numpy(video))


def test_backbone_import_matches_jax(tiny_config, hf_files):
    cfg = dataclasses.replace(tiny_config)
    cfg.fusion_type = "early"
    cfg.fusion_dropout = 0.0
    ids, mask, audio, video = _inputs(cfg)
    model = MultimodalEmotionModel(cfg)
    text = {"input_ids": ids, "attention_mask": mask}
    params = jax.tree_util.tree_map(np.asarray, jax.jit(model.init)(
        jax.random.PRNGKey(0), text, audio, video))
    spliced = jio.load_pretrained_backbones(params, **hf_files)
    want = jax.jit(model.apply)(spliced, text, audio, video)

    pcfg = pconfig.config_from_dict(pconfig.ModelConfig, config_to_dict(cfg))
    port = PortModel(pcfg)
    port.load_state_dict(state_dict_from_jax(params, pcfg))
    pio.load_pretrained_backbones(port, **hf_files)
    got = _port_out(port, ids, mask, audio, video)
    for key in ("text_features", "audio_features", "video_features", "emotion_logits"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=2e-4,
                                   rtol=2e-4, err_msg=key)
    # the backbones hold the files' tensors, bit for bit
    sd = port.text_encoder.model.state_dict()
    for k, v in pio.load_state_dict(hf_files["text"]).items():
        assert torch.equal(sd[k], v), k


def test_a_key_that_does_not_match_raises_naming_it(tiny_config, hf_files, tmp_path):
    pcfg = pconfig.config_from_dict(pconfig.ModelConfig, config_to_dict(tiny_config))
    port = PortModel(pcfg)
    sd = pio.load_state_dict(hf_files["video"])
    sd["embeddings.extra_token"] = sd.pop("embeddings.cls_token")
    pio.save_safetensors(sd, str(tmp_path / "bad.safetensors"))
    with pytest.raises(RuntimeError, match="embeddings.cls_token.*\n?.*embeddings.extra_token"
                       "|embeddings.extra_token.*\n?.*embeddings.cls_token"):
        pio.load_pretrained_backbones(port, video=str(tmp_path / "bad.safetensors"))


def _tiny_config_class(tiny_config):
    """The tools' ModelConfig with the test's tiny sizes as its defaults."""
    tiny = pconfig.config_from_dict(pconfig.ModelConfig, config_to_dict(tiny_config))
    return dataclasses.make_dataclass(
        "TinyModelConfig",
        [(f.name, object, dataclasses.field(default_factory=lambda v=getattr(tiny, f.name): v))
         for f in dataclasses.fields(pconfig.ModelConfig)], bases=(pconfig.ModelConfig,))


@pytest.mark.parametrize("fusion_type,fmt", [("hierarchical", "pth"), ("late", "pth"),
                                             ("hierarchical", "safetensors")])
def test_convert_tool_matches_jax(tiny_config, tmp_path, monkeypatch, fusion_type, fmt):
    torch.manual_seed(0)
    ref = RefModelT(fusion_type, TINY).eval()
    sd = {k: v.detach().contiguous() for k, v in ref.state_dict().items()}
    path = tmp_path / f"ref.{fmt}"
    if fmt == "pth":
        torch.save({"model_state_dict": sd, "epoch": 3, "metrics": {"val_f1_macro": 0.5}}, path)
    else:
        st_save_file(sd, str(path))
    monkeypatch.setattr(convert_tool, "ModelConfig", _tiny_config_class(tiny_config))
    out = convert_tool.main(["--torch_checkpoint", str(path), "--output",
                             str(tmp_path / "ck"), "--fusion_type", fusion_type,
                             "--preset", "tiny", "--device", "cpu"])
    port, pcfg = load_pretrained_model(out, device="cpu")
    assert pcfg.fusion_type == fusion_type and pcfg.fusion_hidden_size == TINY.F

    cfg = dataclasses.replace(tiny_config)
    cfg.fusion_type = fusion_type
    model = MultimodalEmotionModel(cfg)
    params = {"params": convert_multimodal_model(
        {k: v.numpy() for k, v in sd.items()}, cfg)}
    ids, mask, audio, video = _inputs(cfg)
    want = jax.jit(model.apply)(params, {"input_ids": ids, "attention_mask": mask}, audio,
                                video)
    got = _port_out(port, ids, mask, audio, video)
    for key in ("emotion_logits", "valence", "arousal"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-3,
                                   rtol=1e-3, err_msg=key)
    # both LSTM biases load by name, as the port keeps them
    lstm = port.state_dict()
    for k in ("video_encoder.temporal_lstm.bias_ih_l0", "video_encoder.temporal_lstm.bias_hh_l0"):
        assert torch.equal(lstm[k], sd[k]), k


def test_import_tool_writes_a_checkpoint_the_port_loads(tiny_config, hf_files, tmp_path,
                                                        monkeypatch):
    monkeypatch.setattr(import_tool, "ModelConfig", _tiny_config_class(tiny_config))
    out = import_tool.main(["--text", hf_files["text"], "--video", hf_files["video"],
                            "--output", str(tmp_path / "ck"), "--fusion_type", "late",
                            "--preset", "tiny", "--seed", "3", "--device", "cpu"])
    model, cfg = load_pretrained_model(out, device="cpu")
    assert cfg.fusion_type == "late"
    for module, name in ((model.text_encoder.model, "text"), (model.video_encoder.vit, "video")):
        sd = module.state_dict()
        for k, v in pio.load_state_dict(hf_files[name]).items():
            assert torch.equal(sd[k], v), (name, k)
    again = import_tool.main(["--text", hf_files["text"], "--video", hf_files["video"],
                              "--output", str(tmp_path / "ck2"), "--fusion_type", "late",
                              "--preset", "tiny", "--seed", "3", "--device", "cpu"])
    a, b = checkpoint.restore_params(out), checkpoint.restore_params(again)
    assert all(torch.equal(a[k], b[k]) for k in a)  # the rest from --seed: repeatable


@pytest.mark.parametrize("tool", ["convert", "import"])
def test_tools_default_to_the_card(tool, hf_files, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    argv = (["--torch_checkpoint", hf_files["text"]] if tool == "convert"
            else ["--text", hf_files["text"]])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        (convert_tool if tool == "convert" else import_tool).main(
            argv + ["--output", str(tmp_path / "ck")])
    assert not (tmp_path / "ck").exists()
