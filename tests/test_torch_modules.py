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
import jax.numpy as jnp
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
from simple_multimodal_tpu.models.wav2vec2 import FeatureEncoder as JaxFeatureEncoder
from simple_multimodal_tpu.models.wav2vec2 import Wav2Vec2Config as JaxWav2Vec2Config
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
from simple_multimodal_tpu_torch.models import encoders as pencoders
from simple_multimodal_tpu_torch.models.wav2vec2 import FeatureEncoder, Wav2Vec2Config
from simple_multimodal_tpu_torch.ops import attention as pattention
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


@pytest.mark.parametrize("cls_only", [True, False])
def test_vit_drops_attention_output_and_probabilities_in_training(bundle, monkeypatch, cls_only):
    """Non-zero ViT rates (the presets keep 0): in training the attention
    output is dropped before the residual, as the JAX layer does outside its
    fused kernel, on the full layers and on the CLS-only one."""
    from simple_multimodal_tpu_torch.models import vit as pvit

    base = bundle.port.video_encoder.vit
    E = base.cfg.hidden_size

    def build(rate):
        m = pvit.ViTModel(dataclasses.replace(base.cfg, hidden_dropout=rate,
                                              attention_dropout=rate))
        m.load_state_dict(base.state_dict())
        return m

    frames = torch.from_numpy(np.random.default_rng(3).random((24, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        want = base(frames, F32, cls_only=cls_only)
        same = build(0.0).train()(frames, F32, cls_only=cls_only,
                                  gen=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(_np(same), _np(want))  # rate 0: train mode is eval mode

    calls = []
    real = pvit.dropout

    def recording(x, rate, gen, training):
        y = real(x, rate, gen, training)
        calls.append((tuple(x.shape), float((y == 0).float().mean())))
        return y

    monkeypatch.setattr(pvit, "dropout", recording)
    with torch.no_grad():
        got = build(0.5).train()(frames, F32, cls_only=cls_only,
                                 gen=torch.Generator().manual_seed(0))
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) > 1e-3
    # the embeddings, then per full layer the attention output; the CLS-only
    # layer drops its probabilities, its attention output and its FFN output
    layers = base.cfg.num_layers
    assert len(calls) == (1 + (layers - 1) + 3 if cls_only else 1 + layers)
    hidden = [share for shape, share in calls if shape[-1] == E and len(shape) == 3]
    assert len(hidden) == (1 + (layers - 1) + 2 if cls_only else 1 + layers)
    for share in hidden:
        assert abs(share - 0.5) <= 0.05, calls


def test_unknown_encoder_preset_resolves_to_base_and_half_raises():
    """As the JAX ``resolve_backbone_configs``: any unknown preset name is
    'base', and 'half' (the distillation student's scale, once refused by
    the port) resolves to the JAX package's half configs, field by field."""
    def resolve(preset):
        return pencoders.resolve_backbone_configs(
            SimpleNamespace(encoder_preset=preset, video_frame_size=(224, 224)))

    assert resolve("large") == resolve("base")
    text, audio, vit = resolve("no-such-preset")
    assert (text.hidden_size, audio.hidden_size, vit.hidden_size) == (768, 768, 768)
    jt, ja, jv = resolve_backbone_configs(
        SimpleNamespace(encoder_preset="no-such-preset", video_frame_size=(224, 224)))
    assert (jt.hidden_size, ja.hidden_size, jv.hidden_size) == (768, 768, 768)
    half = resolve("half")
    jhalf = resolve_backbone_configs(
        SimpleNamespace(encoder_preset="half", video_frame_size=(224, 224)))
    for got, want in zip(half, jhalf):
        fields = {f.name for f in dataclasses.fields(got)} & {f.name for f in
                                                              dataclasses.fields(want)}
        assert {f: getattr(got, f) for f in fields} == {f: getattr(want, f) for f in fields}
        assert (got.hidden_size, got.num_layers, got.num_heads,
                got.intermediate_size) == (384, 6, 6, 1536)


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


@pytest.mark.parametrize("family", ["vit", "wav2vec2"])
def test_layer_hands_attention_block_its_q_k_v_as_one_packed_weight(family, monkeypatch):
    """A layer whose q, k and v are separate Linears calls attention_block
    with the very tensors one Linear holding the three would give
    (``kernel_weights``: [3E, E] and [3E] in torch layout, packed once a
    forward, the out-projection beside them), and the three Linears'
    gradients are the rows of that packed weight's."""
    from simple_multimodal_tpu_torch.models import vit as pvit
    from simple_multimodal_tpu_torch.models import wav2vec2 as pwav

    module = pvit if family == "vit" else pwav
    seen = []
    real = module.attention_block

    def recording(x, w_qkv, b_qkv, wo, bo, **kw):
        w_qkv.retain_grad()
        seen.append((w_qkv, b_qkv, wo, bo))
        return real(x, w_qkv, b_qkv, wo, bo, **kw)

    monkeypatch.setattr(module, "attention_block", recording)
    if family == "vit":
        layer = pvit.ViTLayer(pvit.ViTConfig.tiny()).eval()
        q, k, v, o = layer._attn_layers()
    else:
        layer = pwav.Wav2Vec2EncoderLayer(pwav.Wav2Vec2Config.tiny()).eval()
        a = layer.attention
        q, k, v, o = a.q_proj, a.k_proj, a.v_proj, a.out_proj
    E = q.in_features
    x = torch.randn(2, 7, E, generator=torch.Generator().manual_seed(0))
    layer(x, F32).square().sum().backward()
    packed = torch.nn.Linear(E, 3 * E)
    with torch.no_grad():
        packed.weight.copy_(torch.cat([q.weight, k.weight, v.weight]))
        packed.bias.copy_(torch.cat([q.bias, k.bias, v.bias]))
    (got,) = seen
    want = pattention.kernel_weights(F32, packed, o)
    assert [tuple(t.shape) for t in got] == [(3 * E, E), (3 * E,), (E, E), (E,)]
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[2] is o.weight and got[3] is o.bias  # the model's own, no copy in f32
    for i, lin in enumerate((q, k, v)):
        assert torch.equal(lin.weight.grad, got[0].grad[i * E:(i + 1) * E])


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


def _long_mha(E=32, H=4, Q=520, K=530, seed=7):
    """A JAX MHA with use_flash on, the port MHA on its weights, and inputs
    longer than the 512 gate (cross attention, so the JAX module cannot take
    its fused self-attention block instead)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, Q, E)).astype(np.float32)
    kv = rng.standard_normal((2, K, E)).astype(np.float32)
    mha = JaxMHA(E, H, use_flash=True)
    params = jax.tree_util.tree_map(np.asarray, mha.init(jax.random.PRNGKey(3), q, kv, kv))
    sd = {}
    from_jax._mha(sd, "m", params["params"])
    port = MultiHeadAttention(E, H)
    port.load_state_dict({k[2:]: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    return rng, mha, params, port, q, kv


def test_multihead_attention_long_matches_jax_flash():
    """Q, K > 512 without weights: the JAX module runs flash_attention (the
    Pallas kernel in interpret mode), the port its flash_attention (plain on
    CPU). Output and, through a weighted-sum loss, every gradient at 1e-4."""
    rng, mha, params, port, q, kv = _long_mha()
    w = rng.standard_normal(q.shape).astype(np.float32)

    def loss(p, q_, kv_):
        out, weights = mha.apply(p, q_, kv_, kv_, need_weights=False)
        assert weights is None
        return jnp.sum(out * w), out

    (_, want), (gp, gq, gkv) = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        params, q, kv)
    tq, tkv = torch.from_numpy(q).requires_grad_(), torch.from_numpy(kv).requires_grad_()
    got, weights = port.eval()(tq, tkv, tkv, F32, need_weights=False)
    assert weights is None
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-4, rtol=1e-4)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(gq), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tkv.grad.numpy(), np.asarray(gkv), atol=1e-4, rtol=1e-4)
    want_grads = {}
    from_jax._mha(want_grads, "m", jax.tree_util.tree_map(np.asarray, gp)["params"])
    for name, param in port.named_parameters():
        np.testing.assert_allclose(param.grad.numpy(), want_grads["m." + name], atol=1e-4,
                                   rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("Q,K,need_weights,train,rate,flash", [
    (520, 530, False, False, 0.1, True),    # eval: the dropout is off
    (520, 530, False, True, 0.0, True),     # training without probability dropout
    (499, 499, False, False, 0.0, False),   # the default clip's 499 frames
    (520, 512, False, False, 0.0, False),   # K not beyond the gate
    (520, 530, True, False, 0.0, False),    # the weights must be formed anyway
    (520, 530, False, True, 0.1, False),    # probability dropout in effect
])
def test_multihead_attention_routes_long_calls_to_flash(monkeypatch, Q, K, need_weights, train,
                                                        rate, flash):
    calls = []

    def spy(q, k, v, bias=None):
        calls.append(q.shape)
        return real(q, k, v, bias)

    real = pattention.flash_attention
    monkeypatch.setattr(pattention, "flash_attention", spy)
    E, H = 16, 2
    gen = torch.Generator().manual_seed(0)
    mha = MultiHeadAttention(E, H, rate).train(train)
    torch.nn.init.normal_(mha.in_proj_weight, std=0.1, generator=gen)
    q, kv = torch.randn(1, Q, E, generator=gen), torch.randn(1, K, E, generator=gen)
    out, weights = mha(q, kv, kv, F32, need_weights=need_weights, gen=gen)
    assert out.shape == (1, Q, E) and (weights is not None) == need_weights
    assert calls == ([(1, Q, H, E // H)] if flash else [])


def _fused_feature_encoders():
    """The JAX base-width FeatureEncoder with its fused route on, and the
    port's FeatureEncoder with ``fused_frontend`` on its parameters."""
    rng = np.random.default_rng(0)
    wav = (0.3 * rng.standard_normal((2, 16000))).astype(np.float32)
    jfe = JaxFeatureEncoder(dataclasses.replace(JaxWav2Vec2Config.base(), use_flash=True),
                            dtype=jnp.bfloat16)
    params = jax.jit(jfe.init)(jax.random.PRNGKey(0), wav)
    fe = jax.tree_util.tree_map(np.asarray, params)["params"]
    port = FeatureEncoder(Wav2Vec2Config(fused_frontend=True))
    sd = {f"conv_layers.{i}.conv.weight": torch.from_numpy(
        np.ascontiguousarray(fe[f"conv_{i}"]["kernel"].transpose(2, 1, 0))) for i in range(7)}
    sd["conv_layers.0.layer_norm.weight"] = torch.from_numpy(np.array(fe["group_norm"]["scale"]))
    sd["conv_layers.0.layer_norm.bias"] = torch.from_numpy(np.array(fe["group_norm"]["bias"]))
    port.load_state_dict(sd)
    return jfe, params, port, wav


def test_feature_encoder_fused_frontend_matches_jax(monkeypatch):
    """fused_frontend=True against the JAX FeatureEncoder with its fused
    front end forced on (SMM_WAV_FRONTEND=1, the Pallas passes in interpret
    mode), C = 512, T = 16000, bf16: 2e-3, the JAX integration test's
    tolerance; and turning the front end on changes no state-dict name."""
    monkeypatch.setenv("SMM_WAV_FRONTEND", "1")
    jfe, params, port, wav = _fused_feature_encoders()
    want = np.asarray(jax.jit(jfe.apply)(params, wav), np.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(wav), torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert float(np.abs(_np(got) - want).max()) < 2e-3
    off = FeatureEncoder(Wav2Vec2Config(fused_frontend=False))
    assert list(off.state_dict()) == list(port.state_dict())


def test_fused_frontend_follows_the_environment_switch(bundle, monkeypatch):
    """SMM_WAV_FRONTEND=1 turns the fused front end on, as in the JAX
    package; the default is off; the model's output does not change (on the
    CPU both run the same plain composition)."""
    pcfg = _port_config(bundle.cfg)
    monkeypatch.delenv("SMM_WAV_FRONTEND", raising=False)
    assert not pencoders.resolve_backbone_configs(pcfg)[1].fused_frontend
    monkeypatch.setenv("SMM_WAV_FRONTEND", "1")
    assert pencoders.resolve_backbone_configs(pcfg)[1].fused_frontend
    fused = pencoders.AudioEncoder(pcfg).eval()
    assert fused.model.cfg.fused_frontend
    plain = bundle.port.audio_encoder
    fused.load_state_dict(plain.state_dict())
    with torch.no_grad():
        wav = torch.from_numpy(bundle.audio)
        np.testing.assert_allclose(_np(fused(wav, F32)["features"]),
                                   _np(plain(wav, F32)["features"]), atol=1e-6, rtol=1e-6)


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


# the port's own fields: the DeepSeek text tower's cut, which the JAX package lacks
PORT_ONLY = {"text_num_layers": 0, "text_expert_share": (0, 1)}


def test_model_config_fields_and_defaults_match_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # a config mkdirs data/, checkpoints/, logs/
    jf = {f.name: f.default for f in dataclasses.fields(ModelConfig)}
    pf = {f.name: f.default for f in dataclasses.fields(pconfig.ModelConfig)}
    assert {k: pf.pop(k) for k in PORT_ONLY} == PORT_ONLY
    assert pf == jf
    j, p = ModelConfig(), pconfig.ModelConfig()
    pd = config_to_dict(p)
    assert {k: pd.pop(k) for k in PORT_ONLY} == {k: list(v) if isinstance(v, tuple) else v
                                                 for k, v in PORT_ONLY.items()}
    assert pd == config_to_dict(j)


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
