"""The port's train step against the JAX package's, on CPU at the tiny
preset: losses, the OneCycle schedule, the optimizer chain on identical
gradients, the backbone group, the whole-model gradients with dropout off,
augmentation, and the properties of train mode (dropout drawn only from the
step's generator, modality dropout's survivor rule, SpecAugment's rate,
the classifier's dropout rate).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_multimodal_tpu.config import config_to_dict
from simple_multimodal_tpu.data.augment import _time_stretch
from simple_multimodal_tpu.models import MultimodalEmotionModel
from simple_multimodal_tpu.train import losses as jlosses
from simple_multimodal_tpu.train import optim as joptim
from simple_multimodal_tpu_torch import config as pconfig
from simple_multimodal_tpu_torch.data.augment import augment_batch, time_stretch
from simple_multimodal_tpu_torch.models.from_jax import state_dict_from_jax
from simple_multimodal_tpu_torch.models.multimodal_model import (
    MultimodalEmotionModel as PortModel, modality_dropout,
)
from simple_multimodal_tpu_torch.models.wav2vec2 import spec_augment_mask
from simple_multimodal_tpu_torch.train import losses, optim
from simple_multimodal_tpu_torch.train.state import TrainState
from simple_multimodal_tpu_torch.train.steps import make_eval_step, make_train_step

B = 2


@pytest.fixture(scope="module")
def setup(tiny_config):
    """The tiny hierarchical JAX model's params, the port model loaded from
    them, and one batch made with numpy from a seed."""
    cfg = dataclasses.replace(tiny_config)
    cfg.fusion_type = "hierarchical"
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 120000, (B, cfg.text_max_length)).astype(np.int32)
    mask = np.ones((B, cfg.text_max_length), np.int32)
    mask[1, 10:] = 0
    audio = (0.3 * rng.standard_normal((B, cfg.audio_max_length))).astype(np.float32)
    video = rng.integers(0, 256, (B, cfg.video_max_frames, 32, 32, 3), dtype=np.uint8)
    labels = np.array([1, 5], np.int32)
    text = {"input_ids": ids, "attention_mask": mask}
    model = MultimodalEmotionModel(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), text, audio, video)
    params = jax.tree_util.tree_map(np.asarray, params)
    pcfg = pconfig.config_from_dict(pconfig.ModelConfig, config_to_dict(cfg))
    return cfg, pcfg, model, params, (text, audio, video, labels)


def _port(pcfg, params):
    port = PortModel(pcfg)
    port.load_state_dict(state_dict_from_jax(params, pcfg))
    return port


def _torch_batch(text, audio, video, labels):
    return {"text": {k: torch.from_numpy(v) for k, v in text.items()},
            "audio": torch.from_numpy(audio), "video": torch.from_numpy(video),
            "emotion": torch.from_numpy(labels).long()}


# --------------------------------------------------------------- losses

def test_losses_match_jax():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((6, 7)).astype(np.float32) * 3
    labels = rng.integers(0, 7, 6).astype(np.int32)
    cl = {k: np.float32(v) for k, v in zip(("text_audio", "text_video", "audio_video"),
                                           rng.random(3) * 4)}
    val, aro = rng.standard_normal((2, 6)).astype(np.float32)
    out = {"emotion_logits": logits, "contrastive_losses": cl,
           "valence": rng.standard_normal((6, 1)).astype(np.float32),
           "arousal": rng.standard_normal((6, 1)).astype(np.float32)}
    tout = {k: ({n: torch.tensor(x) for n, x in v.items()} if isinstance(v, dict)
                else torch.from_numpy(v)) for k, v in out.items()}
    for smoothing in (0.0, 0.1):
        np.testing.assert_allclose(
            float(losses.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                       smoothing)),
            float(jlosses.cross_entropy(logits, labels, smoothing)), rtol=1e-6, atol=1e-6)
    for targets in ((None, None), (val, aro)):
        want, wparts = jlosses.total_loss(out, labels, valence_targets=targets[0],
                                          arousal_targets=targets[1])
        got, gparts = losses.total_loss(
            tout, torch.from_numpy(labels),
            valence_targets=None if targets[0] is None else torch.from_numpy(val),
            arousal_targets=None if targets[1] is None else torch.from_numpy(aro))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)
        for k in wparts:
            np.testing.assert_allclose(float(gparts[k]), float(wparts[k]), rtol=1e-6, atol=1e-6,
                                       err_msg=k)


# ------------------------------------------------------- schedule, optimizer

@pytest.mark.parametrize("total", [20, 3])
def test_schedule_matches_optax_at_every_step(total):
    got, want = optim.make_schedule(1e-4, total), joptim.make_schedule(1e-4, total)
    for step in range(total + 2):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-5, atol=0,
                                   err_msg=str(step))


def test_backbone_group_is_the_jax_backbone_mask(setup):
    """The port's name prefixes select exactly the parameters the JAX
    markers (text_encoder/model, audio_encoder/model, video_encoder/vit)
    select, mapped through from_jax's naming."""
    cfg, pcfg, model, params, _ = setup
    mask = jax.tree_util.tree_map(lambda m, p: np.full(np.shape(p), float(m), np.float32),
                                  joptim.backbone_mask(params), params)
    sd = state_dict_from_jax(mask, pcfg)
    for name, m in sd.items():
        assert bool(m.all()) or not bool(m.any()), name
        assert optim.is_backbone_name(name) == bool(m.any()), name
    assert 0 < sum(optim.is_backbone_name(n) for n in sd) < len(sd)


def test_optimizer_matches_optax_on_identical_gradients(setup):
    """Three updates from the same gradients (the first two clipped, the
    last under the clip norm): params within 1e-6 of optax's chain,
    backbone group and weight decay included (lr and decay raised so that
    each term moves the params by more than the tolerance)."""
    cfg, pcfg, model, params, _ = setup
    jcfg = dataclasses.replace(cfg, learning_rate=1e-2, weight_decay=0.1)
    tcfg = dataclasses.replace(pcfg, learning_rate=1e-2, weight_decay=0.1)
    tx = joptim.make_optimizer(jcfg, params, total_steps=20)
    opt_state = tx.init(params)
    port = _port(pcfg, params)
    opt = optim.make_optimizer(tcfg, port, total_steps=20)
    rng = np.random.default_rng(2)
    jp = params
    update = jax.jit(tx.update)
    for scale in (1.0, 1.0, 1e-4):
        g = jax.tree_util.tree_map(
            lambda p: (scale * rng.standard_normal(np.shape(p))).astype(np.float32), jp)
        updates, opt_state = update(g, opt_state, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, updates)
        tg = state_dict_from_jax(g, pcfg)
        opt.update([tg[n] for n in opt.names])
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jp), pcfg)
    got = port.state_dict()
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), atol=1e-6, rtol=0, err_msg=name)


# -------------------------------------------------- whole-model gradients

def test_whole_model_gradients_match_jax_with_dropout_off(setup):
    """Loss, every gradient leaf and the gradient norm of the composite
    loss (contrastive terms on) against jax.value_and_grad with
    deterministic=True. Gradients are held to 1e-3 of each leaf's max
    magnitude, plus 1e-6 absolute for the leaves that are zero in exact
    arithmetic (attention key biases: softmax is shift-invariant) and are
    f32 rounding noise in both frameworks. The port's LSTM has torch's two
    biases where JAX has one: each gets the JAX bias's gradient, and the
    port's norm counts it twice."""
    cfg, pcfg, model, params, (text, audio, video, labels) = setup

    def loss_fn(p):
        out = model.apply(p, text, audio, video, compute_contrastive_loss=True,
                          deterministic=True)
        return jlosses.total_loss(out, labels, label_smoothing=0.1)[0]

    want_loss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    jgrads = jax.tree_util.tree_map(np.asarray, jgrads)
    port = _port(pcfg, params).eval()
    batch = _torch_batch(text, audio, video, labels)
    out = port(batch["text"], batch["audio"], batch["video"], compute_contrastive_loss=True)
    loss, _ = losses.total_loss(out, batch["emotion"], label_smoothing=0.1)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5, atol=1e-5)
    want = state_dict_from_jax(jgrads, pcfg)
    for name in want:
        if "bias_hh" in name:
            want[name] = want[name.replace("bias_hh", "bias_ih")]
    named = dict(port.named_parameters())
    assert set(named) == set(want)
    for name, w in want.items():
        g = named[name].grad
        g = torch.zeros_like(w) if g is None else g
        tol = 1e-3 * float(w.abs().max()) + 1e-6
        assert float((g - w).abs().max()) <= tol, name
    got_norm = optim.global_norm([p.grad for p in named.values() if p.grad is not None])
    want_norm = np.sqrt(sum(float((w.double() ** 2).sum()) for w in want.values()))
    np.testing.assert_allclose(float(got_norm), want_norm, rtol=1e-4)


# ------------------------------------------------------------- augmentation

def test_time_stretch_matches_jax():
    rng = np.random.default_rng(3)
    wav = rng.standard_normal((4, 1000)).astype(np.float32)
    factor = np.array([0.8, 1.0, 1.0731, 1.2], np.float32)
    want = np.stack([np.asarray(_time_stretch(jnp.asarray(w), jnp.float32(f)))
                     for w, f in zip(wav, factor)])
    got = time_stretch(torch.from_numpy(wav), torch.from_numpy(factor)).numpy()
    # the f32 source coordinate may differ by an ulp (~L·2⁻²³ = 1.2e-4 at
    # L = 1000) between the two compilers; times a neighbour difference of a
    # few units that moves the interpolated value by up to ~1e-3
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
    np.testing.assert_array_equal(got == 0, want == 0)


def test_augment_batch_draws_from_its_generator():
    audio = torch.randn(64, 800, generator=torch.Generator().manual_seed(0))
    video = torch.rand(64, 2, 4, 6, 3, generator=torch.Generator().manual_seed(1))
    a1, v1 = augment_batch(audio, video, torch.Generator().manual_seed(5))
    a2, v2 = augment_batch(audio, video, torch.Generator().manual_seed(5))
    assert torch.equal(a1, a2) and torch.equal(v1, v2)
    changed = ~(a1 == audio).all(dim=1)
    assert 0 < int(changed.sum()) < 64  # p = 0.3 + 0.3: some rows, not all
    flipped = (v1 == video.flip(3)).all(dim=(1, 2, 3, 4)) & ~(v1 == video).all(dim=(1, 2, 3, 4))
    assert 0 < int(flipped.sum()) < 64
    assert float(v1.min()) >= 0.0 and float(v1.max()) <= 1.0


# ---------------------------------------------------- train-mode properties

def test_classifier_drops_at_fusion_dropout(setup):
    """The classifier's hidden dropout runs in train mode at fusion_dropout
    (0.1), not nn.Dropout's default 0.5: with one hidden unit routed to
    logit 0, that logit is 0 or 1/(1 − 0.1), 0 about a tenth of the time."""
    cfg, pcfg, model, params, _ = setup
    head = _port(pcfg, params).classifier.train()
    with torch.no_grad():
        for lin in (head.classifier[0], head.classifier[3]):
            lin.weight.zero_()
            lin.bias.zero_()
        head.classifier[0].bias[0] = 1.0
        head.classifier[3].weight[0, 0] = 1.0
    logits = head(torch.zeros(20000, pcfg.fusion_hidden_size), torch.float32,
                  torch.Generator().manual_seed(0))[:, 0]
    kept = logits != 0
    assert torch.allclose(logits[kept], torch.tensor(1.0 / 0.9))
    assert abs(1.0 - float(kept.float().mean()) - pcfg.fusion_dropout) < 0.01


def test_modality_dropout_keeps_at_least_one_modality():
    ones = torch.ones(5000, 4)
    t, a, v = modality_dropout(ones, ones, ones, 0.7, torch.Generator().manual_seed(0))
    kept = torch.stack([t[:, 0], a[:, 0], v[:, 0]], dim=1)
    assert bool((kept.sum(1) >= 1).all())
    assert bool((kept == 0).any())  # at 0.7, drops do happen


def test_spec_augment_masks_its_expected_fraction():
    """Each frame starts a 10-frame span with p = 0.05: frame t is masked
    with probability 1 − 0.95^min(t + 1, 10)."""
    S = 499
    m = spec_augment_mask(512, S, 0.05, 10, torch.Generator().manual_seed(0), "cpu")
    expect = 1.0 - 0.95 ** np.minimum(np.arange(S) + 1, 10)
    assert abs(float(m.float().mean()) - float(expect.mean())) < 0.01
    assert float(m[:, 0].float().mean()) < 0.1


def test_train_steps_are_reproducible_from_the_generator(setup):
    """Two runs of two train steps (dropout, SpecAugment, modality dropout
    and augmentation on) from the same weights and state seed give
    bit-identical params; another seed gives others. Eval mode draws
    nothing."""
    cfg, pcfg, model, params, raw = setup
    batch = _torch_batch(*raw)
    batch["audio"] = (batch["audio"] * 32768).to(torch.int16)

    def run(seed):
        port = _port(pcfg, params)
        step = make_train_step(port, optim.make_optimizer(pcfg, port, 10), pcfg, augment=True)
        state = TrainState.create(seed)
        for _ in range(2):
            state, metrics = step(state, batch)
            assert all(bool(torch.isfinite(v)) for v in metrics.values())
        assert state.step == 2
        return port.state_dict(), make_eval_step(port)(batch)["loss"]

    a, la = run(7)
    b, lb = run(7)
    c, _ = run(8)
    assert all(torch.equal(a[k], b[k]) for k in a) and torch.equal(la, lb)
    assert not all(torch.equal(a[k], c[k]) for k in a)


def test_missing_modality_rate_zeroes_the_batch_inputs(setup):
    """At missing_modality_rate 1 the step zeroes the ids, mask, audio and
    decoded video of the whole batch (the robustness scenario draw); the
    dropout draws come from their own generator, so the step equals one on
    an all-zero batch bit for bit."""
    cfg, pcfg, model, params, raw = setup
    batch = _torch_batch(*raw)
    zeroed = dict(batch, text={k: torch.zeros_like(v) for k, v in batch["text"].items()},
                  audio=torch.zeros_like(batch["audio"]), video=torch.zeros_like(batch["video"]))

    def run(b, rate):
        port = _port(pcfg, params)
        step = make_train_step(port, optim.make_optimizer(pcfg, port, 10), pcfg,
                               missing_modality_rate=rate)
        return step(TrainState.create(3), b)[1]

    got, want = run(batch, 1.0), run(zeroed, 0.0)
    assert all(torch.equal(got[k], want[k]) for k in want)
