"""The port's modules against their JAX counterparts on the same weights, in
f32 on CPU at the tiny preset (≤ 2e-4, as tests/test_encoder_parity.py).

The JAX model is initialised once from a PRNG key; ``state_dict_from_jax``
carries its parameters into the port model, and each port module is held to
the JAX module applied to the matching parameter subtree.

On CPU the JAX DeBERTa runs its one-hot path, which masks query rows as
well as keys; the port keeps the fused kernel's key-only mask, so DeBERTa's
sequence output is compared on valid rows (pooled features are unaffected).
"""
import dataclasses
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from simple_multimodal_tpu.config import ModelConfig, config_to_dict
from simple_multimodal_tpu.data import video_wire as jvw
from simple_multimodal_tpu.data.tokenizer import HashTokenizer as JaxHashTokenizer
from simple_multimodal_tpu.models import MultimodalEmotionModel
from simple_multimodal_tpu.models.deberta import DebertaModel
from simple_multimodal_tpu.models.encoders import (
    AudioEncoder, TextEncoder, VideoEncoder, resolve_backbone_configs,
)
from simple_multimodal_tpu.models import fusion as jfusion
from simple_multimodal_tpu.models.fusion import HierarchicalFusion
from simple_multimodal_tpu.models.vit import ViTModel
from simple_multimodal_tpu.models.wav2vec2 import Wav2Vec2Model
from simple_multimodal_tpu.ops.attention import MultiHeadAttention as JaxMHA
from simple_multimodal_tpu_torch import config as pconfig
from simple_multimodal_tpu_torch.data import video_wire as pvw
from simple_multimodal_tpu_torch.data.tokenizer import HashTokenizer
from simple_multimodal_tpu_torch.models import fusion as pfusion
from simple_multimodal_tpu_torch.models import from_jax
from simple_multimodal_tpu_torch.models.multimodal_model import (
    MultimodalEmotionModel as PortModel,
)
from simple_multimodal_tpu_torch.ops.attention import MultiHeadAttention

TOL = dict(atol=2e-4, rtol=2e-4)
F32 = torch.float32


def _port_config(cfg):
    pcfg = pconfig.config_from_dict(pconfig.ModelConfig, config_to_dict(cfg))
    return pcfg


@pytest.fixture(scope="module")
def bundle(tiny_config):
    cfg = dataclasses.replace(tiny_config, fusion_dropout=0.0)
    cfg.fusion_type = "hierarchical"
    rng = np.random.default_rng(0)
    B = 2
    ids = rng.integers(1, 120000, (B, cfg.text_max_length)).astype(np.int32)
    mask = np.ones((B, cfg.text_max_length), np.int32)
    mask[1, 10:] = 0
    audio = rng.standard_normal((B, cfg.audio_max_length)).astype(np.float32)
    video = rng.random((B, cfg.video_max_frames, 32, 32, 3)).astype(np.float32)
    model = MultimodalEmotionModel(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 {"input_ids": ids, "attention_mask": mask}, audio, video)
    params = jax.tree_util.tree_map(np.asarray, params)["params"]
    pcfg = _port_config(cfg)
    port = PortModel(pcfg).eval()
    port.load_state_dict(from_jax.state_dict_from_jax(params, pcfg))
    text_cfg, audio_cfg, vit_cfg = resolve_backbone_configs(cfg)
    return SimpleNamespace(cfg=cfg, params=params, port=port, ids=ids, mask=mask,
                           audio=audio, video=video, text_cfg=text_cfg,
                           audio_cfg=audio_cfg, vit_cfg=vit_cfg, rng=rng)


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("cls_only", [True, False])
def test_vit_matches_jax(bundle, cls_only):
    frames = bundle.rng.random((6, 32, 32, 3)).astype(np.float32)
    want = ViTModel(bundle.vit_cfg).apply(
        {"params": bundle.params["video_encoder"]["vit"]}, frames, cls_only=cls_only)
    with torch.no_grad():
        got = bundle.port.video_encoder.vit(torch.from_numpy(frames), F32, cls_only=cls_only)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_deberta_matches_jax_on_valid_rows(bundle):
    want = DebertaModel(bundle.text_cfg).apply(
        {"params": bundle.params["text_encoder"]["model"]}, bundle.ids, bundle.mask)
    with torch.no_grad():
        got = bundle.port.text_encoder.model(torch.from_numpy(bundle.ids),
                                             torch.from_numpy(bundle.mask), F32)
    valid = bundle.mask.astype(bool)
    np.testing.assert_allclose(_np(got)[valid], np.asarray(want)[valid], **TOL)


def test_wav2vec2_matches_jax(bundle):
    want = Wav2Vec2Model(bundle.audio_cfg).apply(
        {"params": bundle.params["audio_encoder"]["model"]}, bundle.audio)
    with torch.no_grad():
        got = bundle.port.audio_encoder.model(torch.from_numpy(bundle.audio), F32)
    assert got.shape[1] == bundle.audio_cfg.num_frames(bundle.audio.shape[1])
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("which", ["text", "audio", "video"])
def test_encoder_matches_jax(bundle, which):
    b, p = bundle, bundle.params
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    with torch.no_grad():
        if which == "text":
            want = TextEncoder(b.cfg).apply({"params": p["text_encoder"]}, b.ids, b.mask)
            got = b.port.text_encoder(t(b.ids), t(b.mask), F32)
        elif which == "audio":
            want = AudioEncoder(b.cfg).apply({"params": p["audio_encoder"]}, b.audio)
            got = b.port.audio_encoder(t(b.audio), F32)
        else:
            want = VideoEncoder(b.cfg).apply({"params": p["video_encoder"]}, b.video)
            got = b.port.video_encoder(t(b.video), F32)
    np.testing.assert_allclose(_np(got["features"]), np.asarray(want["features"]), **TOL)
    seq_got, seq_want = _np(got["sequence_output"]), np.asarray(want["sequence_output"])
    if which == "text":  # valid rows only (see the module docstring)
        valid = b.mask.astype(bool)
        seq_got, seq_want = seq_got[valid], seq_want[valid]
    np.testing.assert_allclose(seq_got, seq_want, **TOL)


def test_audio_encoder_int16_dequantization(bundle):
    wav = (bundle.rng.standard_normal((2, bundle.cfg.audio_max_length)) * 4000).astype(np.int16)
    want = AudioEncoder(bundle.cfg).apply({"params": bundle.params["audio_encoder"]}, wav)
    with torch.no_grad():
        got = bundle.port.audio_encoder(torch.from_numpy(wav), F32)
    np.testing.assert_allclose(_np(got["features"]), np.asarray(want["features"]), **TOL)


def test_hierarchical_fusion_matches_jax(bundle):
    Fh = bundle.cfg.fusion_hidden_size
    feats = [bundle.rng.standard_normal((4, Fh)).astype(np.float32) for _ in range(3)]
    want = HierarchicalFusion(bundle.cfg).apply(
        {"params": bundle.params["fusion_layer"]}, *feats, True)
    with torch.no_grad():
        got = bundle.port.fusion_layer(*map(torch.from_numpy, feats), F32, True)
    assert set(got) == set(want)
    for key, value in want.items():
        if key == "contrastive_losses":
            assert set(got[key]) == set(value)
            for name, loss in value.items():
                np.testing.assert_allclose(float(got[key][name]), float(loss), **TOL)
        else:
            np.testing.assert_allclose(_np(got[key]), np.asarray(value), **TOL,
                                       err_msg=key)


@pytest.mark.parametrize("name", ["EarlyFusion", "MultimodalTransformer", "GraphFusion",
                                  "ContrastiveFusion", "AdaptiveFusion"])
def test_fusion_strategy_matches_jax(bundle, name):
    """Each strategy inside HierarchicalFusion on its own, as the model's
    ``fusion_type`` can select it, with weights of its own."""
    kind = {"EarlyFusion": "early", "MultimodalTransformer": "mult", "GraphFusion": "graph",
            "ContrastiveFusion": "contrastive", "AdaptiveFusion": "adaptive"}[name]
    Fh = bundle.cfg.fusion_hidden_size
    feats = [bundle.rng.standard_normal((3, Fh)).astype(np.float32) for _ in range(3)]
    jmod = getattr(jfusion, name)(bundle.cfg)
    params = jax.tree_util.tree_map(np.asarray, jmod.init(jax.random.PRNGKey(2), *feats))
    want = jmod.apply(params, *feats)
    sd = {}
    from_jax._fusion(sd, "f", params["params"], kind, bundle.cfg)
    port = getattr(pfusion, name)(bundle.cfg).eval()  # the JAX apply is deterministic
    port.load_state_dict({k[2:]: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    with torch.no_grad():
        got = port(*map(torch.from_numpy, feats), F32)
    if not isinstance(want, dict):
        want, got = {"fused_features": want}, {"fused_features": got}
    for key, value in want.items():
        if key != "contrastive_losses":
            np.testing.assert_allclose(_np(got[key]), np.asarray(value), **TOL, err_msg=key)


@pytest.mark.parametrize("need_weights,kv_len", [(True, 5), (False, 5), (True, 1)])
def test_multihead_attention_matches_jax(need_weights, kv_len):
    E, H = 32, 4
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 3, E)).astype(np.float32)
    kv = rng.standard_normal((2, kv_len, E)).astype(np.float32)
    mha = JaxMHA(E, H)
    params = jax.tree_util.tree_map(np.asarray, mha.init(jax.random.PRNGKey(1), q, kv, kv))
    want_out, want_w = mha.apply(params, q, kv, kv, need_weights=need_weights)
    sd = {}
    from_jax._mha(sd, "m", params["params"])
    port = MultiHeadAttention(E, H)
    port.load_state_dict({k[2:]: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    with torch.no_grad():
        out, w = port(torch.from_numpy(q), torch.from_numpy(kv), torch.from_numpy(kv), F32,
                      need_weights=need_weights)
    np.testing.assert_allclose(_np(out), np.asarray(want_out), **TOL)
    if need_weights:
        np.testing.assert_allclose(_np(w), np.asarray(want_w), **TOL)
    else:
        assert w is None and want_w is None


@pytest.mark.parametrize("wire", ["rgb8", "yuv420", "float"])
def test_decode_video_wire_matches_jax(wire):
    rng = np.random.default_rng(6)
    frames = rng.integers(0, 256, (2, 3, 8, 6, 3), dtype=np.uint8)
    if wire == "yuv420":
        packed = pvw.pack_yuv420(frames)
        np.testing.assert_array_equal(packed, jvw.pack_yuv420(frames))
        frames = packed
    elif wire == "float":
        frames = frames.astype(np.float32) / 255.0
    want = np.asarray(jvw.decode_video_wire(frames))
    got = pvw.decode_video_wire(torch.from_numpy(frames), F32)
    assert got.shape == want.shape == (2, 3, 8, 6, 3)
    np.testing.assert_allclose(_np(got), want, atol=1e-6, rtol=1e-6)


def test_hash_tokenizer_ids_identical():
    texts = ["Hello, World! I'm SO happy :)", "", "naïve café — 42 times",
             " ".join(f"word{i}" for i in range(40))]
    for max_length in (16, 512):
        want = JaxHashTokenizer(model_max_length=max_length)(texts)
        got = HashTokenizer(model_max_length=max_length)(texts)
        for k in ("input_ids", "attention_mask"):
            np.testing.assert_array_equal(got[k], want[k])


def test_model_config_fields_and_defaults_match_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # a config mkdirs data/, checkpoints/, logs/
    jf = {f.name: f.default for f in dataclasses.fields(ModelConfig)}
    pf = {f.name: f.default for f in dataclasses.fields(pconfig.ModelConfig)}
    assert pf == jf
    j, p = ModelConfig(), pconfig.ModelConfig()
    assert config_to_dict(p) == config_to_dict(j)


def test_model_config_json_round_trip(tmp_path):
    cfg = pconfig.ModelConfig(encoder_preset="tiny", video_frame_size=(32, 32),
                              data_path=str(tmp_path / "d"), save_path=str(tmp_path / "c"),
                              log_path=str(tmp_path / "l"))
    cfg.fusion_type = "hierarchical"
    path = str(tmp_path / "cfg.json")
    pconfig.save_config_json(path, model_config=cfg)
    back = pconfig.config_from_dict(pconfig.ModelConfig,
                                    pconfig.load_config_json(path)["model_config"])
    assert back == cfg and back.fusion_type == "hierarchical"
    assert back.video_frame_size == (32, 32)
