"""Late fusion, adapters and prompt tuning of the port against the JAX
package, in f32 on CPU at the tiny preset: ``LateFusion`` alone (1e-5; and
in bf16, where both mix the logits in f32), the whole ``late`` model with
its per-modality logits, fusion weights and auxiliary heads (1e-3), its
exact parameter round trip (no classifier), the eval step's
``individual_logits`` and the demo's ``individual_modalities``;
``AdapterLayer`` (1e-5) and its init; each encoder and the whole model
with adapters and prompt (2e-4 / 1e-3), the text pooling mask extended by
the prompt; and DeBERTa with prompt embeddings at S + P = 522, past the
512 of ``max_position`` (2e-4 on valid rows: on CPU the JAX model takes
its one-hot path, which masks query rows too).
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_multimodal_tpu.config import config_to_dict
from simple_multimodal_tpu.models import MultimodalEmotionModel
from simple_multimodal_tpu.models.convert_full import convert_multimodal_model
from simple_multimodal_tpu.models.deberta import DebertaConfig as JaxDebertaConfig
from simple_multimodal_tpu.models.deberta import DebertaModel as JaxDebertaModel
from simple_multimodal_tpu.models.encoders import AudioEncoder, TextEncoder, VideoEncoder
from simple_multimodal_tpu.models.fusion import LateFusion as JaxLateFusion
from simple_multimodal_tpu.ops.adapters import AdapterLayer as JaxAdapterLayer
from simple_multimodal_tpu.train.steps import make_eval_step as jax_eval_step
from simple_multimodal_tpu_torch import config as pconfig
from simple_multimodal_tpu_torch.models import from_jax
from simple_multimodal_tpu_torch.models.deberta import DebertaConfig, DebertaModel
from simple_multimodal_tpu_torch.models.fusion import LateFusion
from simple_multimodal_tpu_torch.models.from_jax import state_dict_from_jax
from simple_multimodal_tpu_torch.models.multimodal_model import (
    MultimodalEmotionModel as PortModel, create_model,
)
from simple_multimodal_tpu_torch.ops.adapters import AdapterLayer
from simple_multimodal_tpu_torch.serving.demo import MultimodalEmotionDemo, save_checkpoint
from simple_multimodal_tpu_torch.train.steps import make_eval_step

F32 = torch.float32
TOL = dict(atol=1e-3, rtol=1e-3)
ENC_TOL = dict(atol=2e-4, rtol=2e-4)
OPS_TOL = dict(atol=1e-5, rtol=1e-5)


def _np(t):
    return t.detach().float().numpy()


def _inputs(cfg, seed=0, B=2):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 120000, (B, cfg.text_max_length)).astype(np.int32)
    mask = np.ones((B, cfg.text_max_length), np.int32)
    mask[1, 10:] = 0
    audio = rng.standard_normal((B, cfg.audio_max_length)).astype(np.float32)
    video = rng.random((B, cfg.video_max_frames, 32, 32, 3)).astype(np.float32)
    return {"input_ids": ids, "attention_mask": mask}, audio, video


def _torch(text, audio, video):
    return ({k: torch.from_numpy(v) for k, v in text.items()}, torch.from_numpy(audio),
            torch.from_numpy(video))


def _flat(tree, prefix=""):
    """{dotted key: array} of a nested output dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _perturb(tree, names, rng):
    """Random values for every leaf under a key in ``names`` (adapter biases
    start at zero, late fusion's weights at 1/3: both would hide a fault)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = (_perturb_all(v, rng) if k in names else _perturb(v, names, rng))
        elif k in names:
            out[k] = rng.standard_normal(np.shape(v)).astype(np.float32)
        else:
            out[k] = v
    return out


def _perturb_all(tree, rng):
    return {k: _perturb_all(v, rng) if isinstance(v, dict)
            else (0.1 * rng.standard_normal(np.shape(v))).astype(np.float32)
            for k, v in tree.items()}


# --------------------------------------------------------------- late fusion

@pytest.fixture(scope="module")
def late(tiny_config):
    cfg = dataclasses.replace(tiny_config, fusion_dropout=0.0)
    cfg.fusion_type = "late"
    inputs = _inputs(cfg)
    model = MultimodalEmotionModel(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), *inputs)
    params = jax.tree_util.tree_map(np.asarray, params)
    params = _perturb(params, ("fusion_weights",), np.random.default_rng(5))
    pcfg = pconfig.config_from_dict(pconfig.ModelConfig, config_to_dict(cfg))
    port = PortModel(pcfg).eval()
    port.load_state_dict(state_dict_from_jax(params, pcfg))
    return cfg, pcfg, model, params, port, inputs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_late_fusion_matches_jax(dtype):
    """Each classifier's logits in the compute dtype, the fusion weights
    softmaxed in f32 and the mix in f32 (JAX promotes the logits against the
    f32 weights): f32 at 1e-5; bf16 at 3e-2 (bf16 rounding of the logits)."""
    cfg = SimpleNamespace(fusion_hidden_size=32, num_emotions=7)
    rng = np.random.default_rng(0)
    feats = [rng.standard_normal((4, 32)).astype(np.float32) for _ in range(3)]
    jdt = jnp.dtype(dtype)
    jm = JaxLateFusion(cfg, dtype=jdt)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0), *feats))
    params = _perturb(params, ("fusion_weights",), rng)
    want = jm.apply(params, *[f.astype(jdt) for f in feats])
    sd = {}
    from_jax._fusion(sd, "m", params["params"], "late", cfg)
    port = LateFusion(cfg)
    port.load_state_dict({k[2:]: torch.from_numpy(np.array(v, np.float32))
                          for k, v in sd.items()})
    tdt = getattr(torch, dtype)
    with torch.no_grad():
        got = port(*[torch.from_numpy(f).to(tdt) for f in feats], tdt)
    assert set(got) == set(want)
    tol = OPS_TOL if dtype == "float32" else dict(atol=3e-2, rtol=3e-2)
    for key, value in want.items():
        assert str(got[key].dtype)[6:] == str(value.dtype), key
        np.testing.assert_allclose(_np(got[key]), np.asarray(value, np.float32), **tol,
                                   err_msg=key)
    assert got["fused_logits"].dtype == F32 and got["fusion_weights"].dtype == F32


@pytest.mark.parametrize("missing", [None, ("audio",)])
def test_late_model_matches_jax(late, missing):
    """Logits (the fused per-modality logits), ``individual_logits``,
    ``fusion_weights`` and the auxiliary heads, which read the mean of the
    three features: every output of the JAX model at 1e-3, the same keys."""
    cfg, pcfg, model, params, port, inputs = late
    want = jax.jit(lambda p, t, a, v: model.apply(p, t, a, v, missing_modalities=missing))(
        params, *inputs)
    with torch.no_grad():
        got = port(*_torch(*inputs), missing_modalities=missing)
    want, got = _flat(want), _flat(got)
    assert set(got) == set(want)
    assert {"individual_logits.text", "fusion_weights", "valence"} <= set(got)
    for key, value in want.items():
        np.testing.assert_allclose(_np(got[key]), np.asarray(value), **TOL, err_msg=key)
    feats = (got["text_features"] + got["audio_features"] + got["video_features"]) / 3.0
    np.testing.assert_allclose(
        _np(got["valence"]), _np(torch.nn.functional.linear(
            feats, port.valence_regressor.weight, port.valence_regressor.bias)), **OPS_TOL)


def test_late_param_round_trip_is_exact(late):
    """JAX params → port state_dict → ``convert_multimodal_model`` gives
    the JAX params back bit for bit; neither side has a classifier."""
    cfg, pcfg, model, params, port, _ = late
    sd = {k: v.numpy() for k, v in state_dict_from_jax(params, pcfg).items()}
    back = convert_multimodal_model(sd, cfg)
    want = jax.tree_util.tree_leaves_with_path(params["params"])
    got = dict((jax.tree_util.keystr(p), v) for p, v in jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(got[jax.tree_util.keystr(path)], leaf,
                                      err_msg=jax.tree_util.keystr(path))
    assert set(sd) == set(port.state_dict())
    assert port.classifier is None and "classifier" not in params["params"]
    assert not any(k.startswith("classifier.") for k in sd)
    assert "fusion_layer.fusion_weights" in sd


def test_late_eval_step_and_demo_individual_modalities(late, tmp_path):
    """The eval step passes ``individual_logits`` through as the JAX step
    does (1e-3), and the demo's ``individual_modalities`` holds a softmax,
    label and confidence per modality that match the JAX model's."""
    cfg, pcfg, model, params, port, (text, audio, video) = late
    labels = np.array([1, 5], np.int32)
    want = jax_eval_step(model)(params, {"text": text, "audio": audio, "video": video,
                                         "emotion": labels})
    t, a, v = _torch(text, audio, video)
    got = make_eval_step(port)({"text": t, "audio": a, "video": v,
                                "emotion": torch.from_numpy(labels)})
    assert set(got) == set(want)
    for key, value in _flat(want).items():
        np.testing.assert_allclose(_np(_flat(got)[key]), np.asarray(value), **TOL, err_msg=key)

    ckpt = str(tmp_path / "late")
    save_checkpoint(ckpt, port, pcfg)
    demo = MultimodalEmotionDemo(checkpoint_path=ckpt, device="cpu")
    wav = (np.random.default_rng(2).standard_normal(pcfg.audio_max_length) * 3000).astype(np.int16)
    analysis = demo.predict("so happy today", wav, video[0])
    t_in, a_in, v_in = demo.prepare("so happy today", wav, video[0])
    jout = jax.jit(model.apply)(params, {k: x.numpy() for k, x in t_in.items()}, a_in.numpy(),
                                v_in.numpy())
    ind = analysis["individual_modalities"]
    assert set(ind) == {"text", "audio", "video"}
    for m, entry in ind.items():
        dist = entry["distribution"]
        assert list(dist) == list(pcfg.emotion_labels)
        assert abs(sum(dist.values()) - 1.0) < 1e-5
        assert entry["predicted_emotion"] == max(dist, key=dist.get)
        assert entry["confidence"] == max(dist.values())
        want_p = np.asarray(jax.nn.softmax(jout["individual_logits"][m], axis=-1))[0]
        np.testing.assert_allclose(list(dist.values()), want_p, **TOL, err_msg=m)


# ---------------------------------------------------- adapters and the prompt

def test_adapter_layer_matches_jax():
    """down → ReLU → (dropout) → up, plus the residual: eval at 1e-5 with
    non-zero biases; in train mode at rate 0 the same output, at rate 0.1
    another one, drawn from the generator alone."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    jm = JaxAdapterLayer(8)
    params = _perturb_all(jax.tree_util.tree_map(np.asarray,
                                                 jm.init(jax.random.PRNGKey(0), x)), rng)
    want = jm.apply(params, x)
    p = params["params"]
    port = AdapterLayer(32, 8).eval()
    port.load_state_dict({f"{n}.{w}": torch.from_numpy(np.asarray(
        p[n]["kernel"].T if w == "weight" else p[n]["bias"]))
        for n in ("down_project", "up_project") for w in ("weight", "bias")})
    with torch.no_grad():
        got = port(torch.from_numpy(x), F32)
        np.testing.assert_allclose(_np(got), np.asarray(want), **OPS_TOL)
        port.train()
        a = port(torch.from_numpy(x), F32, torch.Generator().manual_seed(0))
        b = port(torch.from_numpy(x), F32, torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and not torch.equal(a, got)


def test_adapter_and_prompt_init(tiny_config):
    """``init_weights``: adapter kernels N(0, 0.02) with zero biases (not
    lecun-normal, which would give 1/√32 ≈ 0.18 here), prompt embeddings
    N(0, 1), as the JAX initialisers."""
    pcfg = pconfig.config_from_dict(pconfig.ModelConfig, config_to_dict(tiny_config))
    base = create_model(pcfg, "few_shot", device="cpu").base_model
    adapters = [base.text_encoder.adapter, base.audio_encoder.adapter,
                base.video_encoder.adapter]
    for ad in adapters:
        w = torch.cat([ad.down_project.weight.flatten(),
                       ad.up_project.weight.flatten()]).detach()
        assert abs(float(w.std()) - 0.02) < 0.003, float(w.std())
        assert not ad.down_project.bias.any() and not ad.up_project.bias.any()
    prompt = base.text_encoder.prompt_embeddings.detach()
    assert prompt.shape == (pcfg.prompt_length, 32)
    assert abs(float(prompt.std()) - 1.0) < 0.2 and abs(float(prompt.mean())) < 0.25
    assert abs(float(base.text_encoder.projection.weight.detach().std()) - 32 ** -0.5) < 0.02


@pytest.fixture(scope="module")
def adapted(tiny_config):
    """The tiny hierarchical model initialised in JAX with adapters and a
    prompt (adapter leaves perturbed off their zero biases), carried into
    the port model built with both."""
    cfg = dataclasses.replace(tiny_config, fusion_dropout=0.0)
    cfg.fusion_type = "hierarchical"
    inputs = _inputs(cfg, seed=3)
    model = MultimodalEmotionModel(cfg)
    params = jax.jit(lambda k, t, a, v: model.init(k, t, a, v, use_adapter=True,
                                                   use_prompt=True))(
        jax.random.PRNGKey(1), *inputs)
    params = jax.tree_util.tree_map(np.asarray, params)
    params = _perturb(params, ("adapter",), np.random.default_rng(6))
    pcfg = pconfig.config_from_dict(pconfig.ModelConfig, config_to_dict(cfg))
    port = PortModel(pcfg, use_adapter=True, use_prompt=True).eval()
    port.load_state_dict(state_dict_from_jax(params, pcfg))
    return cfg, pcfg, model, params["params"], port, inputs


@pytest.mark.parametrize("which", ["text", "audio", "video"])
def test_encoder_with_adapter_matches_jax(adapted, which):
    """Each encoder with its adapter (and the text encoder with its prompt:
    S + P rows, the pooling mask extended by P ones) at 2e-4."""
    cfg, pcfg, model, p, port, (text, audio, video) = adapted
    ids, mask = text["input_ids"], text["attention_mask"]
    t = torch.from_numpy
    with torch.no_grad():
        if which == "text":
            want = TextEncoder(cfg).apply({"params": p["text_encoder"]}, ids, mask,
                                          use_adapter=True, use_prompt=True)
            got = port.text_encoder(t(ids), t(mask), F32)
        elif which == "audio":
            want = AudioEncoder(cfg).apply({"params": p["audio_encoder"]}, audio,
                                           use_adapter=True)
            got = port.audio_encoder(t(audio), F32)
        else:
            want = VideoEncoder(cfg).apply({"params": p["video_encoder"]}, video,
                                           use_adapter=True)
            got = port.video_encoder(t(video), F32)
    np.testing.assert_allclose(_np(got["features"]), np.asarray(want["features"]), **ENC_TOL)
    seq_got, seq_want = _np(got["sequence_output"]), np.asarray(want["sequence_output"])
    if which == "text":
        P = cfg.prompt_length
        np.testing.assert_array_equal(got["attention_mask"].numpy(),
                                      np.asarray(want["attention_mask"]))
        assert got["attention_mask"].shape == (2, P + cfg.text_max_length)
        assert bool((got["attention_mask"][:, :P] == 1).all())
        valid = np.asarray(want["attention_mask"]).astype(bool)  # valid rows, as in the suite
        seq_got, seq_want = seq_got[valid], seq_want[valid]
    np.testing.assert_allclose(seq_got, seq_want, **ENC_TOL)
    # the adapter is on the path: without it the features differ
    encoder = getattr(port, f"{which}_encoder")
    adapter, encoder.adapter = encoder.adapter, None
    try:
        with torch.no_grad():
            plain = {"text": lambda: encoder(t(ids), t(mask), F32),
                     "audio": lambda: encoder(t(audio), F32),
                     "video": lambda: encoder(t(video), F32)}[which]()
    finally:
        encoder.adapter = adapter
    assert float((plain["features"] - got["features"]).abs().max()) > 1e-3


def test_model_with_adapters_and_prompt_matches_jax(adapted):
    cfg, pcfg, model, p, port, inputs = adapted
    want = jax.jit(lambda prm, t, a, v: model.apply(prm, t, a, v, use_adapter=True,
                                                    use_prompt=True))(
        {"params": p}, *inputs)
    with torch.no_grad():
        got = port(*_torch(*inputs))
    for key in ("text_features", "audio_features", "video_features", "emotion_logits",
                "valence", "arousal", "emotion_probs", "uncertainty"):
        np.testing.assert_allclose(_np(got[key]), np.asarray(want[key]), **TOL, err_msg=key)


@pytest.mark.parametrize("per_row", [False, True])
def test_deberta_prompt_embeds_at_522_matches_jax(per_row):
    """A [10, 64] prompt (or a [B, 10, 64] one) ahead of 512 tokens at a
    narrow width with DeBERTa-v3's 256 position buckets and max_position
    512: relative positions up to ±521, beyond 512, take the log buckets
    the kernel computes on the card. 2e-4 on valid rows; the prompt rows
    are valid."""
    kw = dict(vocab_size=1024, hidden_size=64, num_layers=2, num_heads=2,
              intermediate_size=128, max_position_embeddings=512, position_buckets=256)
    rng = np.random.default_rng(4)
    B, S, P = 2, 512, 10
    ids = rng.integers(1, 1024, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, 300:] = 0
    prompt = rng.standard_normal((B, P, 64) if per_row else (P, 64)).astype(np.float32)
    jm = JaxDebertaModel(JaxDebertaConfig(**kw))
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k, i, m, pr: jm.init(k, i, m, prompt_embeds=pr))(jax.random.PRNGKey(2), ids,
                                                                mask, prompt))
    want = np.asarray(jax.jit(lambda prm, i, m, pr: jm.apply(prm, i, m, prompt_embeds=pr))(
        params, ids, mask, prompt))
    sd = {}
    from_jax._deberta(sd, "m", params["params"])
    port = DebertaModel(DebertaConfig(**kw)).eval()
    port.load_state_dict({k[2:]: torch.from_numpy(np.array(v, np.float32))
                          for k, v in sd.items()})
    with torch.no_grad():
        got = port(torch.from_numpy(ids), torch.from_numpy(mask), F32,
                   prompt_embeds=torch.from_numpy(prompt))
    assert got.shape == want.shape == (B, S + P, 64)
    valid = np.concatenate([np.ones((B, P), bool), mask.astype(bool)], axis=1)
    np.testing.assert_allclose(_np(got)[valid], want[valid], **ENC_TOL)
