"""The long-clip slice of the port against the JAX model: the tiny
hierarchical model with an ``audio_max_length`` that gives more than 512
wav2vec2 frames (166400 samples → 519), so the temporal attention takes
``flash_attention`` in both packages (the JAX model with its Pallas kernels
forced on, in interpret mode; the port with its plain versions, on the CPU)
and the port's wav2vec2 front end is the fused one.

Weights are initialised in JAX and carried over with ``state_dict_from_jax``;
f32 on CPU; outputs at 1e-3 (tests/test_torch_model.py's tolerance) and,
with every dropout off, each gradient leaf at 1e-3 of its largest magnitude
(tests/test_torch_train.py's rule).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from simple_multimodal_tpu.config import config_to_dict
from simple_multimodal_tpu.models import MultimodalEmotionModel
from simple_multimodal_tpu.models.convert_full import convert_multimodal_model
from simple_multimodal_tpu.train import losses as jlosses
from simple_multimodal_tpu_torch import config as pconfig
from simple_multimodal_tpu_torch.models.from_jax import state_dict_from_jax
from simple_multimodal_tpu_torch.models.multimodal_model import (
    MultimodalEmotionModel as PortModel,
)
from simple_multimodal_tpu_torch.ops import attention as pattention
from simple_multimodal_tpu_torch.serving.demo import MultimodalEmotionDemo
from simple_multimodal_tpu_torch.train import losses
from simple_multimodal_tpu_torch.train.optim import make_optimizer
from simple_multimodal_tpu_torch.train.state import TrainState
from simple_multimodal_tpu_torch.train.steps import device_batch, make_train_step

LONG = 166400  # samples: 519 frames through the tiny preset's full stride stack
PARITY_KEYS = ("text_features", "audio_features", "video_features",
               "emotion_logits", "valence", "arousal")
B = 2


@pytest.fixture(scope="module")
def long_slice(tiny_config):
    cfg = dataclasses.replace(tiny_config, fusion_dropout=0.0, audio_max_length=LONG,
                              flash_attention=True)
    cfg.fusion_type = "hierarchical"
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 120000, (B, cfg.text_max_length)).astype(np.int32)
    mask = np.ones((B, cfg.text_max_length), np.int32)
    mask[1, 10:] = 0
    audio = (0.3 * rng.standard_normal((B, LONG))).astype(np.float32)
    video = rng.integers(0, 256, (B, cfg.video_max_frames, 32, 32, 3), dtype=np.uint8)
    labels = np.array([1, 5], np.int32)
    text = {"input_ids": ids, "attention_mask": mask}
    model = MultimodalEmotionModel(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), text, audio, video)
    params = jax.tree_util.tree_map(np.asarray, params)
    pcfg = pconfig.config_from_dict(pconfig.ModelConfig, config_to_dict(cfg))
    return cfg, pcfg, model, params, (text, audio, video, labels)


@pytest.fixture
def port(long_slice, monkeypatch):
    """The port model on the JAX weights with the fused front end on, and
    the list of shapes its MultiHeadAttentions handed to flash_attention."""
    cfg, pcfg, model, params, _ = long_slice
    monkeypatch.setenv("SMM_WAV_FRONTEND", "1")
    calls = []
    real = pattention.flash_attention

    def spy(q, k, v, bias=None):
        calls.append(tuple(q.shape))
        return real(q, k, v, bias)

    monkeypatch.setattr(pattention, "flash_attention", spy)
    net = PortModel(pcfg).eval()
    net.load_state_dict(state_dict_from_jax(params, pcfg))
    assert net.audio_encoder.model.cfg.fused_frontend
    return net, calls


def _torch_inputs(text, audio, video):
    return ({k: torch.from_numpy(v) for k, v in text.items()}, torch.from_numpy(audio),
            torch.from_numpy(video))


def test_long_clip_slice_matches_jax(long_slice, port):
    cfg, pcfg, model, params, (text, audio, video, _) = long_slice
    net, calls = port
    frames = net.audio_encoder.model.cfg.num_frames(LONG)
    assert frames == 519
    want = jax.jit(model.apply)(params, text, audio, video)
    with torch.no_grad():
        got = net(*_torch_inputs(text, audio, video))
    assert calls == [(B, frames, 8, 32 // 8)]  # the temporal attention, and only it
    for key in PARITY_KEYS + ("emotion_probs",):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-3, rtol=1e-3,
                                   err_msg=key)


def test_long_clip_gradients_match_jax_with_dropout_off(long_slice, port):
    cfg, pcfg, model, params, (text, audio, video, labels) = long_slice
    net, calls = port

    def loss_fn(p):
        out = model.apply(p, text, audio, video, compute_contrastive_loss=True,
                          deterministic=True)
        return jlosses.total_loss(out, labels, label_smoothing=0.1)[0]

    want_loss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads), pcfg)
    for name in want:
        if "bias_hh" in name:  # torch's second LSTM bias gets the JAX bias's gradient
            want[name] = want[name.replace("bias_hh", "bias_ih")]
    out = net(*_torch_inputs(text, audio, video), compute_contrastive_loss=True)
    loss, _ = losses.total_loss(out, torch.from_numpy(labels).long(), label_smoothing=0.1)
    loss.backward()
    assert len(calls) == 1
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5, atol=1e-5)
    named = dict(net.named_parameters())
    assert set(named) == set(want)
    for name, w in want.items():
        g = named[name].grad
        g = torch.zeros_like(w) if g is None else g
        # 1e-6 absolute: leaves that are zero in exact arithmetic (key biases)
        tol = 1e-3 * float(w.abs().max()) + 1e-6
        assert float((g - w).abs().max()) <= tol, name


def test_long_clip_round_trip_is_exact_with_the_front_end_on(long_slice, port):
    """The fused front end shares conv_0's and the GroupNorm's parameters:
    the port's state_dict still converts back to the JAX tree bit for bit."""
    cfg, pcfg, model, params, _ = long_slice
    net, _ = port
    back = convert_multimodal_model({k: v.numpy() for k, v in net.state_dict().items()}, cfg)
    want = jax.tree_util.tree_leaves_with_path(params["params"])
    got = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(back)}
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(got[jax.tree_util.keystr(path)], leaf,
                                      err_msg=jax.tree_util.keystr(path))


def test_demo_and_train_step_take_the_long_clip(long_slice, port):
    """The serving demo pads a missing audio to audio_max_length and takes a
    long int16 clip as given; a train step (fusion_dropout 0, so no
    probability dropout stands in flash_attention's way) runs the temporal
    attention through flash_attention in training mode and moves the
    weights that feed it."""
    cfg, pcfg, model, params, (text, audio, video, labels) = long_slice
    net, calls = port
    demo = MultimodalEmotionDemo(model=net, config=pcfg, device="cpu")
    assert demo.prepare("no audio")[1].shape == (1, LONG)
    wav = (np.random.default_rng(1).standard_normal(LONG) * 3000).astype(np.int16)
    dist = demo.predict("a long clip", wav, video[0])["emotion_distribution"]
    assert abs(sum(dist.values()) - 1.0) < 1e-5
    assert calls[-1] == (1, 519, 8, 4)
    t_text, t_audio, t_video = _torch_inputs(text, audio, video)
    batch = device_batch({"text": t_text, "audio": t_audio, "video": t_video,
                          "emotion": torch.from_numpy(labels).long(), "path": ["a", "b"]})
    assert set(batch) == {"text", "audio", "video", "emotion"}
    before = net.audio_encoder.temporal_attention.in_proj_weight.detach().clone()
    step = make_train_step(net, make_optimizer(pcfg, net, total_steps=10), pcfg)
    n = len(calls)
    _, metrics = step(TrainState.create(0), batch)
    assert calls[n:] == [(B, 519, 8, 4)] and net.training
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert not torch.equal(net.audio_encoder.temporal_attention.in_proj_weight.detach(), before)
