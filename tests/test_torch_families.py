"""The three model families of the port (knowledge distillation,
prototypical few-shot, robust) and their optimizers and steps, against the
JAX package in f32 on CPU at the tiny preset, on JAX-initialised weights
carried by ``state_dict_from_jax``, and against the reference-structured
torch models of tests/ref_torch.py through ``convert_full``: outputs at
1e-3 (logits; few-shot distances at 2e-3 absolute against the reference,
as tests/test_full_model_parity.py); the exact parameter round trip of
every family; the backbone rule under ``student.``/``teacher.``/
``base_model.``; the distillation freeze (teacher bit-equal, student
update at 1e-5 of optax's); the trainable-only optimizer against
``optax.adamw`` (1e-6); the few-shot step against JAX's with dropout off
(loss, trainable parameters 1e-5, frozen ones bit-equal); the teacher in
eval mode under ``train()``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from simple_multimodal_tpu.config import config_to_dict
from simple_multimodal_tpu.models import (FewShotModel, KnowledgeDistillationModel,
                                          RobustMultimodalModel)
from simple_multimodal_tpu.models.convert_full import (convert_distillation_model,
                                                       convert_fewshot_model,
                                                       convert_robust_model)
from simple_multimodal_tpu.train import losses as jlosses
from simple_multimodal_tpu.train import optim as joptim
from simple_multimodal_tpu.train.state import TrainState as JaxTrainState
from simple_multimodal_tpu.train.steps import make_fewshot_step as jax_fewshot_step
from simple_multimodal_tpu_torch import config as pconfig
from simple_multimodal_tpu_torch.models.from_jax import state_dict_from_jax
from simple_multimodal_tpu_torch.models.multimodal_model import (
    FewShotModel as PortFewShot, KnowledgeDistillationModel as PortKD,
    RobustMultimodalModel as PortRobust, create_model,
)
from simple_multimodal_tpu_torch.train import losses, optim
from simple_multimodal_tpu_torch.train.state import TrainState
from simple_multimodal_tpu_torch.train.steps import make_fewshot_step, make_train_step

from ref_torch import FewShotModelT, KDModelT, RobustModelT

TOL = dict(atol=1e-3, rtol=1e-3)
F32 = torch.float32
N_WAY, N_SHOT, N_QUERY = 2, 2, 3


def _np(t):
    return t.detach().float().numpy()


def _inputs(cfg, seed, B=2):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 120000, (B, cfg.text_max_length)).astype(np.int32)
    mask = np.ones((B, cfg.text_max_length), np.int32)
    mask[min(1, B - 1), 10:] = 0
    audio = rng.standard_normal((B, cfg.audio_max_length)).astype(np.float32)
    video = rng.random((B, cfg.video_max_frames, 32, 32, 3)).astype(np.float32)
    return {"input_ids": ids, "attention_mask": mask}, audio, video


def _torch(text, audio, video):
    return ({k: torch.from_numpy(v) for k, v in text.items()}, torch.from_numpy(audio),
            torch.from_numpy(video))


def _episode(cfg, seed, B):
    text, audio, video = _inputs(cfg, seed, B)
    return {"text": text, "audio": audio, "video": video,
            "emotion": (np.arange(B) % N_WAY).astype(np.int32)}


def _torch_batch(batch):
    return {"text": {k: torch.from_numpy(v) for k, v in batch["text"].items()},
            "audio": torch.from_numpy(batch["audio"]), "video": torch.from_numpy(batch["video"]),
            "emotion": torch.from_numpy(batch["emotion"]).long()}


def _port_cfg(cfg):
    return pconfig.config_from_dict(pconfig.ModelConfig, config_to_dict(cfg))


def _student(cfg):
    """The distillation student: the teacher's encoders, the fusion stack
    halved (train_advanced.py's rule)."""
    s = dataclasses.replace(cfg)
    s.fusion_hidden_size = cfg.fusion_hidden_size // 2
    s.fusion_num_heads = max(cfg.fusion_num_heads // 2, 1)
    s.fusion_num_layers = max(cfg.fusion_num_layers // 2, 1)
    return s


def _params(model, *args):
    return jax.tree_util.tree_map(np.asarray, jax.jit(model.init)(jax.random.PRNGKey(0), *args))


@pytest.fixture(scope="module")
def fam(tiny_config):
    """Each family initialised in JAX and carried into the port: the
    distillation pair with MulT fusion (a halved student), few-shot and
    robust with early fusion."""
    base = dataclasses.replace(tiny_config, fusion_dropout=0.0)
    out = {}
    t_cfg = dataclasses.replace(base)
    t_cfg.fusion_type = "mult"
    s_cfg = _student(t_cfg)
    inputs = _inputs(t_cfg, 0)
    jm = KnowledgeDistillationModel(t_cfg, s_cfg)
    params = _params(jm, *inputs)
    port = PortKD(_port_cfg(t_cfg), _port_cfg(s_cfg)).eval()
    port.load_state_dict(state_dict_from_jax(params, _port_cfg(t_cfg), "distillation",
                                             _port_cfg(s_cfg)))
    out["distillation"] = (t_cfg, s_cfg, jm, params, port, inputs)

    cfg = dataclasses.replace(base)
    cfg.fusion_type = "early"
    support = _episode(cfg, 1, N_WAY * N_SHOT)
    query = _episode(cfg, 2, N_QUERY)
    jm = FewShotModel(cfg)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k, s, q: jm.init(k, s, q, N_WAY, N_SHOT))(jax.random.PRNGKey(0), support, query))
    port = PortFewShot(_port_cfg(cfg)).eval()
    port.load_state_dict(state_dict_from_jax(params, _port_cfg(cfg), "few_shot"))
    out["few_shot"] = (cfg, None, jm, params, port, (support, query))

    inputs = _inputs(cfg, 3)
    jm = RobustMultimodalModel(cfg)
    params = _params(jm, *inputs)
    port = PortRobust(_port_cfg(cfg)).eval()
    port.load_state_dict(state_dict_from_jax(params, _port_cfg(cfg), "robust"))
    out["robust"] = (cfg, None, jm, params, port, inputs)
    return out


# ------------------------------------------------------------ the families

def test_distillation_matches_jax(fam):
    """The student's outputs, ``teacher_logits`` and ``distillation_loss``
    (KL at T = 4, batch mean, × T²) at 1e-3, with a student whose fusion
    width and heads are half the teacher's."""
    t_cfg, s_cfg, jm, params, port, inputs = fam["distillation"]
    assert port.student.config.fusion_hidden_size == t_cfg.fusion_hidden_size // 2
    want = jax.jit(jm.apply)(params, *inputs)
    with torch.no_grad():
        got = port(*_torch(*inputs))
    assert set(got) == set(want)
    for key in ("emotion_logits", "teacher_logits", "distillation_loss", "text_features",
                "valence", "emotion_probs"):
        np.testing.assert_allclose(_np(got[key]), np.asarray(want[key]), **TOL, err_msg=key)
    assert float(got["distillation_loss"]) > 0


def test_fewshot_matches_jax(fam):
    """Support and query through one base model with adapters and prompt:
    prototypes, f32 distances and softmax(−d) at 1e-3."""
    cfg, _, jm, params, port, (support, query) = fam["few_shot"]
    want = jax.jit(lambda p, s, q: jm.apply(p, s, q, N_WAY, N_SHOT))(params, support, query)
    with torch.no_grad():
        got = port(_torch_batch(support), _torch_batch(query), N_WAY, N_SHOT)
    assert set(got) == set(want)
    assert got["distances"].dtype == F32 and got["predictions"].shape == (N_QUERY, N_WAY)
    for key, value in want.items():
        np.testing.assert_allclose(_np(got[key]), np.asarray(value), **TOL, err_msg=key)


@pytest.mark.parametrize("kw", [{}, {"available_modalities": ("text", "video")},
                                {"missing_modalities": ("audio",)}],
                         ids=["predicted", "available", "missing"])
def test_robust_matches_jax(fam, kw):
    """The robust prediction mixes the per-modality classifiers by the
    predicted availability, or by the given modalities; missing modalities
    zero the inputs. Every output at 1e-3."""
    cfg, _, jm, params, port, inputs = fam["robust"]
    want = jax.jit(lambda p, t, a, v: jm.apply(p, t, a, v, **kw))(params, *inputs)
    with torch.no_grad():
        got = port(*_torch(*inputs), **kw)
    assert set(got) == set(want)
    for key in ("robust_prediction", "modality_availability", "modality_weights",
                "emotion_logits"):
        np.testing.assert_allclose(_np(got[key]), np.asarray(want[key]), **TOL, err_msg=key)
    for m in ("text", "audio", "video"):
        np.testing.assert_allclose(_np(got["individual_predictions"][m]),
                                   np.asarray(want["individual_predictions"][m]), **TOL)
    if "available_modalities" in kw:
        np.testing.assert_allclose(_np(got["modality_weights"]),
                                   np.tile([0.5, 0.0, 0.5], (2, 1)), atol=1e-6)


def _ref_inputs(inputs):
    text, audio, video = inputs
    return (torch.tensor(text["input_ids"].astype(np.int64)),
            torch.tensor(text["attention_mask"].astype(np.int64)),
            torch.tensor(audio), torch.tensor(video.transpose(0, 1, 4, 2, 3)))


@pytest.mark.parametrize("family", ["distillation", "few_shot", "robust"])
def test_family_matches_the_reference_torch_model(tiny_config, family):
    """The reference-structured torch models (tests/ref_torch.py) through
    ``convert_full`` and ``from_jax`` into the port: the outputs the
    reference has, at 1e-3 (few-shot distances 2e-3 absolute, as the JAX
    package's own parity suite)."""
    cfg = dataclasses.replace(tiny_config, fusion_dropout=0.0)
    cfg.fusion_type = "early"
    pcfg = _port_cfg(cfg)
    torch.manual_seed(7)
    ref = {"distillation": KDModelT, "few_shot": FewShotModelT,
           "robust": RobustModelT}[family]().eval()
    sd = {k: v.detach().numpy() for k, v in ref.state_dict().items()}
    if family == "distillation":
        params = convert_distillation_model(sd, cfg, cfg)
    elif family == "few_shot":
        params = convert_fewshot_model(sd, cfg)
    else:
        params = convert_robust_model(sd, cfg)
    port = create_model(pcfg, family, device="cpu")
    sd = state_dict_from_jax(params, pcfg, family)
    # the reference builds adapters and a prompt in every encoder; only the
    # few-shot family runs them, and the port builds them only there
    unused = set(sd) - set(port.state_dict())
    assert all("adapter" in k or "prompt_embeddings" in k for k in unused)
    assert bool(unused) == (family != "few_shot")
    port.load_state_dict({k: v for k, v in sd.items() if k not in unused})
    if family == "few_shot":
        s_in = _inputs(cfg, 8, B=7)
        q_in = _inputs(cfg, 9, B=3)
        with torch.no_grad():
            want = ref(_ref_inputs(s_in), _ref_inputs(q_in), 7, 1)
            got = port({"text": _torch(*s_in)[0], "audio": _torch(*s_in)[1],
                        "video": _torch(*s_in)[2]},
                       {"text": _torch(*q_in)[0], "audio": _torch(*q_in)[1],
                        "video": _torch(*q_in)[2]}, 7, 1)
        np.testing.assert_allclose(_np(got["distances"]), _np(want["distances"]),
                                   atol=2e-3, rtol=1e-3)
        np.testing.assert_allclose(_np(got["predictions"]), _np(want["predictions"]), **TOL)
        return
    inputs = _inputs(cfg, 10)
    with torch.no_grad():
        want = ref(*_ref_inputs(inputs))
        got = port(*_torch(*inputs))
    keys = (("emotion_logits", "teacher_logits", "distillation_loss")
            if family == "distillation" else
            ("robust_prediction", "modality_availability", "emotion_logits"))
    for key in keys:
        np.testing.assert_allclose(_np(got[key]), _np(want[key]),
                                   atol=2e-3 if key == "distillation_loss" else 1e-3,
                                   rtol=1e-3, err_msg=key)


@pytest.mark.parametrize("family", ["distillation", "few_shot", "robust"])
def test_family_param_round_trip_is_exact(fam, family):
    """JAX params → port state_dict → ``convert_*_model`` gives the JAX
    params back bit for bit (adapters and the prompt included for
    few-shot), and the port's state_dict has exactly those names."""
    cfg, s_cfg, jm, params, port, _ = fam[family]
    sd = {k: v.numpy() for k, v in state_dict_from_jax(
        params, _port_cfg(cfg), family, s_cfg and _port_cfg(s_cfg)).items()}
    if family == "distillation":
        back = convert_distillation_model(sd, cfg, s_cfg)
    elif family == "few_shot":
        back = convert_fewshot_model(sd, cfg)
    else:
        back = convert_robust_model(sd, cfg)
    want = jax.tree_util.tree_leaves_with_path(params["params"])
    got = dict((jax.tree_util.keystr(p), v) for p, v in jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(got[jax.tree_util.keystr(path)], leaf,
                                      err_msg=jax.tree_util.keystr(path))
    assert set(sd) == set(port.state_dict())
    if family == "few_shot":
        assert {"base_model.text_encoder.prompt_embeddings",
                "base_model.video_encoder.adapter.up_project.weight"} <= set(sd)


# ------------------------------------------------------------ the optimizers

@pytest.mark.parametrize("family", ["distillation", "few_shot"])
def test_backbone_rule_matches_jax_under_family_prefixes(fam, family):
    """The 0.1× group is the JAX backbone mask under ``student.``,
    ``teacher.`` and ``base_model.`` too: the JAX rule matches its marker
    pairs anywhere in the path (a rule anchored at the start of the name
    would leave the group empty and train the backbones at 10× the JAX
    rate)."""
    cfg, s_cfg, jm, params, port, _ = fam[family]
    mask = jax.tree_util.tree_map(lambda m, p: np.full(np.shape(p), float(m), np.float32),
                                  joptim.backbone_mask(params), params)
    sd = state_dict_from_jax(mask, _port_cfg(cfg), family, s_cfg and _port_cfg(s_cfg))
    for name, m in sd.items():
        assert bool(m.all()) or not bool(m.any()), name
        assert optim.is_backbone_name(name) == bool(m.any()), name
    backbone = [n for n in sd if optim.is_backbone_name(n)]
    prefixes = ("student.", "teacher.") if family == "distillation" else ("base_model.",)
    for prefix in prefixes:
        assert any(n.startswith(prefix + "text_encoder.model.") for n in backbone)
        assert any(n.startswith(prefix + "video_encoder.vit.") for n in backbone)
    assert not any("adapter" in n or "prompt" in n for n in backbone)


def test_distillation_update_freezes_the_teacher_and_matches_optax(fam):
    """Gradients of the composite loss (0.5 × the distillation loss in it)
    with dropout off: the port's student gradients against JAX's (1e-3 of
    each leaf's max magnitude + 1e-6), no teacher gradient (JAX's are exact
    zeros). Then three updates of ``make_optimizer`` (the teacher frozen
    by the model)
    from JAX's gradients against optax's chain with
    ``freeze_mask={"teacher": True}`` (lr 1e-2, decay 0.1): the student at
    1e-5, the teacher bit-equal on both sides."""
    t_cfg, s_cfg, jm, params, port, inputs = fam["distillation"]
    labels = np.array([1, 5], np.int32)

    def loss_fn(p):
        return jlosses.total_loss(jm.apply(p, *inputs), labels)[0]

    want_loss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    jgrads = jax.tree_util.tree_map(np.asarray, jgrads)
    assert not any(np.any(g) for g in jax.tree_util.tree_leaves(jgrads["params"]["teacher"]))
    pt, ps = _port_cfg(t_cfg), _port_cfg(s_cfg)
    model = PortKD(pt, ps).eval()
    model.load_state_dict(port.state_dict())
    jcfg = dataclasses.replace(s_cfg, learning_rate=1e-2, weight_decay=0.1)
    opt = optim.make_optimizer(_port_cfg(jcfg), model, total_steps=20)
    assert opt.names and all(n.startswith("student.") for n in opt.names)
    out = model(*_torch(*inputs))
    loss, _ = losses.total_loss(out, torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5, atol=1e-5)
    want = state_dict_from_jax(jgrads, pt, "distillation", ps)
    for name, p in model.named_parameters():
        if name.startswith("teacher."):
            assert p.grad is None and not p.requires_grad, name
            continue
        w = want[name]
        if "bias_hh" in name:  # torch's second LSTM bias takes the JAX bias's gradient
            w = want[name.replace("bias_hh", "bias_ih")]
        g = torch.zeros_like(w) if p.grad is None else p.grad
        assert float((g - w).abs().max()) <= 1e-3 * float(w.abs().max()) + 1e-6, name

    tx = joptim.make_optimizer(jcfg, params, 20, freeze_mask={"params": {"teacher": True}})
    opt_state, jp = tx.init(params), params
    update = jax.jit(tx.update)
    for _ in range(3):
        updates, opt_state = update(jgrads, opt_state, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, updates)
        opt.update([want[n] for n in opt.names])
    before = state_dict_from_jax(params, pt, "distillation", ps)
    after = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jp), pt, "distillation", ps)
    got = model.state_dict()
    moved = 0
    for name, w in after.items():
        if name.startswith("teacher."):
            assert torch.equal(got[name], before[name]) and torch.equal(w, before[name]), name
        else:
            np.testing.assert_allclose(got[name].numpy(), w.numpy(), atol=1e-5, rtol=0,
                                       err_msg=name)
            moved += not torch.equal(got[name], before[name])
    assert moved > 0.9 * len(opt.names)


def test_distillation_train_step_leaves_the_teacher_bit_equal(fam):
    """``make_train_step`` on the distillation pair, dropout on, the
    teacher frozen: two steps with a finite, positive distillation loss;
    every teacher parameter bit-equal with no ``.grad``; the student moves."""
    t_cfg, s_cfg, jm, params, port, inputs = fam["distillation"]
    model = PortKD(_port_cfg(t_cfg), _port_cfg(s_cfg))
    model.load_state_dict(port.state_dict())
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = optim.make_optimizer(_port_cfg(s_cfg), model, total_steps=10)
    step = make_train_step(model, opt, _port_cfg(s_cfg), augment=True)
    text, audio, video = _torch(*inputs)
    batch = {"text": text, "audio": audio, "video": video,
             "emotion": torch.tensor([1, 5])}
    state = TrainState.create(0)
    for _ in range(2):
        state, metrics = step(state, batch)
        assert all(bool(torch.isfinite(v)) for v in metrics.values())
        assert float(metrics["distillation_loss"]) > 0
    after = model.state_dict()
    for name, p in model.teacher.named_parameters():
        assert p.grad is None and torch.equal(after["teacher." + name], before["teacher." + name])
    assert not any(torch.equal(after[n], before[n]) for n in opt.names
                   if n.startswith("student.text_encoder.projection"))


def test_teacher_stays_in_eval_mode_and_gets_no_gradient(fam):
    """``model.train()`` puts the student in train mode and leaves the
    teacher in eval mode: its logits in a train-mode forward equal the eval
    forward's bit for bit, and no gradient reaches it, even unfrozen."""
    t_cfg, s_cfg, jm, params, port, inputs = fam["distillation"]
    model = PortKD(_port_cfg(t_cfg), _port_cfg(s_cfg))
    model.load_state_dict(port.state_dict())
    model.teacher.requires_grad_(True)  # unfreeze: no_grad alone must stop it
    model.train()
    assert model.training and model.student.training
    assert not any(m.training for m in model.teacher.modules())
    out = model(*_torch(*inputs), gen=torch.Generator().manual_seed(0))
    with torch.no_grad():
        eval_logits = model.teacher.eval()(*_torch(*inputs))["emotion_logits"]
    assert torch.equal(out["teacher_logits"], eval_logits)
    assert not out["teacher_logits"].requires_grad
    (out["distillation_loss"] + out["emotion_logits"].sum()).backward()
    assert all(p.grad is None for p in model.teacher.parameters())
    assert model.student.text_encoder.projection.weight.grad is not None
    model.eval().train()
    assert not model.teacher.training and model.student.training


def test_trainable_only_optimizer_matches_optax_adamw(fam):
    """Plain AdamW on the adapters, the prompt and the prototype network
    (optax ``adamw``: weight decay 1e-4, constant lr, no clip), everything
    else frozen: three updates from the same gradients (large enough to be
    clipped if there were a clip) within 1e-6 of optax's, frozen parameters
    bit-equal and out of the chain."""
    cfg, _, jm, params, port, _ = fam["few_shot"]
    jcfg = dataclasses.replace(cfg, learning_rate=1e-2)

    trainable = optim.is_trainable_name
    tx = joptim.make_trainable_only_optimizer(jcfg, params, trainable)
    opt_state, jp = tx.init(params), params
    model = PortFewShot(_port_cfg(cfg))
    model.load_state_dict(port.state_dict())
    optim.freeze(model, lambda n: not trainable(n))
    opt = optim.make_trainable_only_optimizer(_port_cfg(jcfg), model)
    assert set(opt.names) == {n for n, _ in model.named_parameters() if trainable(n)}
    assert {n for n, p in model.named_parameters() if p.requires_grad} == set(opt.names)
    assert any("prototype_network" in n for n in opt.names)
    rng = np.random.default_rng(3)
    update = jax.jit(tx.update)
    for scale in (10.0, 1.0, 1e-3):
        g = jax.tree_util.tree_map(
            lambda p: (scale * rng.standard_normal(np.shape(p))).astype(np.float32), jp)
        updates, opt_state = update(g, opt_state, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, updates)
        tg = state_dict_from_jax(g, _port_cfg(cfg), "few_shot")
        opt.update([tg[n] for n in opt.names])
    before = port.state_dict()
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jp), _port_cfg(cfg), "few_shot")
    got = model.state_dict()
    for name, w in want.items():
        if name in opt.names:
            np.testing.assert_allclose(got[name].numpy(), w.numpy(), atol=1e-6, rtol=0,
                                       err_msg=name)
            assert not torch.equal(got[name], before[name]), name
        else:
            assert torch.equal(got[name], before[name]) and torch.equal(w, before[name]), name


class _Deterministic:
    """The JAX model with dropout off inside the JAX step's own code."""

    def __init__(self, model):
        self.model = model

    def apply(self, params, *args, deterministic=True, rngs=None):
        return self.model.apply(params, *args, deterministic=True)


def test_fewshot_step_matches_jax_with_dropout_off(fam, monkeypatch):
    """``make_fewshot_step`` against JAX's with every dropout off (JAX:
    the step's own code on a model applied deterministically; the port:
    its step with ``train()`` kept from leaving eval mode): CE over the
    probabilities at 1e-5, the trainable parameters after two episodes at
    1e-5, every frozen parameter bit-equal."""
    cfg, _, jm, params, port, (support, query) = fam["few_shot"]

    tx = joptim.make_trainable_only_optimizer(cfg, params, optim.is_trainable_name)
    jstep = jax_fewshot_step(_Deterministic(jm), tx, N_WAY, N_SHOT)
    jstate = JaxTrainState.create(params, tx, jax.random.PRNGKey(0))
    model = PortFewShot(_port_cfg(cfg)).eval()
    model.load_state_dict(port.state_dict())
    monkeypatch.setattr(model, "train", lambda mode=True: model)
    optim.freeze(model, lambda n: not optim.is_trainable_name(n))
    opt = optim.make_trainable_only_optimizer(_port_cfg(cfg), model)
    step = make_fewshot_step(model, opt, N_WAY, N_SHOT)
    state = TrainState.create(0)
    s, q = _torch_batch(support), _torch_batch(query)
    for _ in range(2):
        jstate, jloss = jstep(jstate, support, query)
        state, loss = step(state, s, q)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5, atol=1e-5)
    assert state.step == 2
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params),
                               _port_cfg(cfg), "few_shot")
    before, got = port.state_dict(), model.state_dict()
    for name, w in want.items():
        if name in opt.names:
            np.testing.assert_allclose(got[name].numpy(), w.numpy(), atol=1e-5, rtol=0,
                                       err_msg=name)
        else:
            assert torch.equal(got[name], before[name]), name
    assert not torch.equal(got["base_model.text_encoder.prompt_embeddings"],
                           before["base_model.text_encoder.prompt_embeddings"])
