"""The port's checkpoints and trainers on the CPU at the tiny preset:
save → restore of every piece of state, a resume that repeats the run bit
for bit, the optimizer fingerprint, checkpoints carried between the two
packages, and the trainers against the JAX package's on the same files and
the same initial weights.
"""
import dataclasses
import json
import shutil
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from simple_multimodal_tpu.config import config_to_dict
from simple_multimodal_tpu.data import dataset as jdataset
from simple_multimodal_tpu.data import sample_data as jsample
from simple_multimodal_tpu.models import MultimodalEmotionModel
from simple_multimodal_tpu.models.convert_full import convert_multimodal_model
from simple_multimodal_tpu.train import checkpoint as jcheckpoint
from simple_multimodal_tpu.train import trainer as jtrainer
from simple_multimodal_tpu_torch import config as pconfig
from simple_multimodal_tpu_torch.data import dataset as pdataset
from simple_multimodal_tpu_torch.models.from_jax import state_dict_from_jax
from simple_multimodal_tpu_torch.models.multimodal_model import (
    MultimodalEmotionModel as PortModel, create_model, load_pretrained_model)
from simple_multimodal_tpu_torch.train import checkpoint, trainer
from simple_multimodal_tpu_torch.train.optim import freeze, make_optimizer
from simple_multimodal_tpu_torch.train.state import TrainState
from simple_multimodal_tpu_torch.train.steps import make_train_step

B = 2


def _port_cfg(cfg):
    return pconfig.config_from_dict(pconfig.ModelConfig, config_to_dict(cfg))


@pytest.fixture(scope="module")
def sample_dir(tmp_path_factory):
    return jsample.create_sample_dataset(str(tmp_path_factory.mktemp("set") / "sample"), 2,
                                         seed=42)


@pytest.fixture(scope="module", autouse=True)
def _no_hf_lookup():
    """Both packages' ``get_tokenizer`` try the HF tokenizer first; with no
    local HF cache here that costs an import of transformers (~9 s) and
    ends in HashTokenizer all the same."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "transformers", None)
        yield


@pytest.fixture(scope="module")
def jax_model(tiny_config, sample_dir):
    """The tiny hierarchical JAX model, its params, and one batch of the
    sample set."""
    cfg = dataclasses.replace(tiny_config)
    cfg.fusion_type = "hierarchical"
    ds = jdataset.get_dataset("sample", sample_dir, "val", cfg)
    batch = jdataset.collate([ds[0], ds[1]])
    model = MultimodalEmotionModel(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), batch["text"], batch["audio"],
                                 batch["video"])
    return cfg, model, jax.tree_util.tree_map(np.asarray, params), batch


def _torch_batch(batch):
    return {"text": {k: torch.from_numpy(v) for k, v in batch["text"].items()},
            "audio": torch.from_numpy(batch["audio"]), "video": torch.from_numpy(batch["video"]),
            "emotion": torch.from_numpy(batch["emotion"]).long()}


def _port_setup(pcfg, seed=0, total_steps=10):
    model = create_model(pcfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    opt = make_optimizer(pcfg, model, total_steps)
    step = make_train_step(model, opt, pcfg, augment=True)
    return model, opt, step, TrainState.create(seed)


def _batches(jax_model, n):
    _, _, _, batch = jax_model
    rng = np.random.default_rng(9)
    out = []
    for _ in range(n):
        b = _torch_batch(batch)
        b["emotion"] = torch.from_numpy(rng.integers(0, 7, B))
        out.append(b)
    return out


# -------------------------------------------------------------- checkpoints

def test_save_restore_gives_every_piece_of_state_back(tiny_config, jax_model, tmp_path):
    pcfg = _port_cfg(jax_model[0])
    model, opt, step, state = _port_setup(pcfg)
    for b in _batches(jax_model, 2):
        state, _ = step(state, b)
    checkpoint.save_checkpoint(str(tmp_path / "ck"), model, state, opt,
                               metrics={"val_f1_macro": 0.5}, epoch=3, config=pcfg)
    meta = json.loads((tmp_path / "ck" / "meta.json").read_text())
    assert set(meta) == {"epoch", "metrics", "opt_state_fingerprint", "config"}
    assert meta["epoch"] == 3 and meta["metrics"] == {"val_f1_macro": 0.5}
    model2, opt2, _, state2 = _port_setup(pcfg, seed=1)
    payload = checkpoint.restore_checkpoint(str(tmp_path / "ck"), model2, opt2, state2)
    assert payload["meta"] == meta
    for (k, a), (k2, b) in zip(model.state_dict().items(), model2.state_dict().items()):
        assert k == k2 and torch.equal(a, b), k
    for a, b in zip(opt.mu + opt.nu, opt2.mu + opt2.nu):
        assert torch.equal(a, b)
    assert opt2.count == opt.count == 2 and state2.step == state.step == 2
    assert torch.equal(state2.generator.get_state(), state.generator.get_state())
    sd = checkpoint.restore_params(str(tmp_path / "ck"))
    assert all(torch.equal(sd[k], v) for k, v in model.state_dict().items())
    checkpoint.save_params(str(tmp_path / "weights"), model)  # weights only, no meta
    assert not (tmp_path / "weights" / "meta.json").exists()
    sd = checkpoint.restore_params(str(tmp_path / "weights"))
    assert all(torch.equal(sd[k], v) for k, v in model.state_dict().items())


def test_resume_repeats_the_run_bit_for_bit(jax_model, tmp_path):
    """2 steps → save → restore into new objects → 1 step equals 3 steps
    without the break, with dropout and augmentation on (every draw comes
    from generators split from the state's)."""
    pcfg = _port_cfg(jax_model[0])
    batches = _batches(jax_model, 3)
    model, opt, step, state = _port_setup(pcfg)
    for b in batches:
        state, _ = step(state, b)
    model_a, opt_a, step_a, state_a = _port_setup(pcfg)
    for b in batches[:2]:
        state_a, _ = step_a(state_a, b)
    checkpoint.save_checkpoint(str(tmp_path / "ck"), model_a, state_a, opt_a, epoch=0,
                               config=pcfg)
    model_b, opt_b, step_b, state_b = _port_setup(pcfg, seed=5)
    checkpoint.restore_checkpoint(str(tmp_path / "ck"), model_b, opt_b, state_b)
    state_b, _ = step_b(state_b, batches[2])
    assert state_b.step == state.step == 3
    for (k, a), b in zip(model.state_dict().items(), model_b.state_dict().values()):
        assert torch.equal(a, b), k
    for a, b in zip(opt.mu + opt.nu, opt_b.mu + opt_b.nu):
        assert torch.equal(a, b)


def test_resume_under_another_optimizer_raises(jax_model, tmp_path):
    pcfg = _port_cfg(jax_model[0])
    model, opt, _, state = _port_setup(pcfg)
    checkpoint.save_checkpoint(str(tmp_path / "ck"), model, state, opt, epoch=0, config=pcfg)
    other = create_model(pcfg, device="cpu")
    freeze(other, lambda n: n.startswith("classifier."))
    with pytest.raises(ValueError, match="different optimizer structure"):
        checkpoint.restore_checkpoint(str(tmp_path / "ck"), other,
                                      make_optimizer(pcfg, other, 10), TrainState.create(0))


def _jax_logits(model, params, batch):
    out = jax.jit(model.apply)(params, batch["text"], batch["audio"], batch["video"])
    return np.asarray(out["emotion_logits"])


def test_jax_orbax_checkpoint_loads_into_the_port(jax_model, tmp_path):
    cfg, model, params, batch = jax_model
    jcheckpoint.save_params(str(tmp_path / "jax_ck"), params)
    restored = jax.tree_util.tree_map(np.asarray,
                                      jcheckpoint.restore_params(str(tmp_path / "jax_ck")))
    pcfg = _port_cfg(cfg)
    port = PortModel(pcfg)
    port.load_state_dict(state_dict_from_jax(restored, pcfg))
    with torch.no_grad():
        b = _torch_batch(batch)
        got = port.eval()(b["text"], b["audio"], b["video"])["emotion_logits"].numpy()
    np.testing.assert_allclose(got, _jax_logits(model, params, batch), atol=1e-3, rtol=1e-3)


def test_port_checkpoint_loads_into_jax(jax_model, tmp_path):
    cfg, model, _, batch = jax_model
    pcfg = _port_cfg(cfg)
    port = create_model(pcfg, device="cpu", generator=torch.Generator().manual_seed(2))
    checkpoint.save_checkpoint(str(tmp_path / "ck"), port, TrainState.create(0), epoch=0,
                               config=pcfg)
    loaded, loaded_cfg = load_pretrained_model(str(tmp_path / "ck"), device="cpu")
    assert loaded_cfg.fusion_type == "hierarchical"
    sd = {k: v.numpy() for k, v in checkpoint.restore_params(str(tmp_path / "ck")).items()}
    params = {"params": convert_multimodal_model(sd, cfg)}
    b = _torch_batch(batch)
    with torch.no_grad():
        got = port(b["text"], b["audio"], b["video"])["emotion_logits"].numpy()
        again = loaded(b["text"], b["audio"], b["video"])["emotion_logits"].numpy()
    np.testing.assert_array_equal(again, got)
    np.testing.assert_allclose(_jax_logits(model, params, batch), got, atol=1e-3, rtol=1e-3)


# ------------------------------------------------------------------ trainers

class _Deterministic:
    """The JAX model with dropout off inside the JAX trainer's own steps."""

    def __init__(self, model):
        self.model = model

    def apply(self, params, *args, rngs=None, **kw):
        kw["deterministic"] = True
        return self.model.apply(params, *args, **kw)


def _loaders(pkg, root, cfg, batch_size=B):
    loaders = {}
    for split in ("train", "val", "test"):
        ds = pkg.get_dataset("sample", root, split, cfg)
        loaders[split] = pkg.create_dataloader(ds, batch_size, shuffle=split == "train", seed=0)
    return loaders


@pytest.fixture(scope="module")
def parity(jax_model, sample_dir, tmp_path_factory):
    """One epoch of the JAX AdvancedTrainer and of the port's on the same
    sample set from the same weights. Dropout outside the kernels draws
    from other generators in the two packages, and the port's LSTM counts
    its bias gradient twice in the clip norm (ROADMAP, Queue 3: known
    differences): so every dropout is off (the JAX model applied
    deterministically, the port's kept in eval mode), augmentation is off
    (the datasets' default), and the clip norm lies above the gradient
    norm of every step."""
    cfg, model, params, _ = jax_model
    root = tmp_path_factory.mktemp("parity")
    jroot, proot = root / "jdata", root / "pdata"
    shutil.copytree(sample_dir, jroot)
    shutil.copytree(sample_dir, proot)
    jcfg = dataclasses.replace(cfg, num_epochs=1, gradient_clip_norm=1e6,
                               save_path=str(root / "jck"), log_path=str(root / "jlogs"))
    jcfg.fusion_type = "hierarchical"
    pcfg = _port_cfg(jcfg)
    pcfg.save_path, pcfg.log_path = str(root / "pck"), str(root / "plogs")
    for d in (jcfg.save_path, jcfg.log_path, pcfg.save_path, pcfg.log_path):
        Path(d).mkdir(parents=True, exist_ok=True)
    jl = _loaders(jdataset, str(jroot), jcfg)
    jt = jtrainer.AdvancedTrainer(_Deterministic(model), jcfg, jl["train"], jl["val"],
                                  jl["test"], init_params=params, seed=0)
    jt.train()
    port = PortModel(pcfg).eval()
    port.load_state_dict(state_dict_from_jax(params, pcfg))
    port.train = lambda mode=True: port  # stays in eval mode: no dropout
    for name, p in port.named_parameters():
        if "bias_hh" in name:  # the JAX LSTM's one bias is the port's bias_ih
            p.requires_grad_(False)
    pl = _loaders(pdataset, str(proot), pcfg)
    pt = trainer.AdvancedTrainer(port, pcfg, pl["train"], pl["val"], pl["test"], seed=0)
    pt.train()
    return jcfg, pcfg, jt, pt


def test_trainer_epoch_matches_jax(parity):
    """Epoch loss, val_loss, learning rate and every parameter within 1e-4
    relative (a tensor's largest difference against its largest
    magnitude); predictions equal. Attention key biases get gradients that
    are zero in exact arithmetic, so Adam steps them by the sign of f32
    noise: they are held to twice the learning rate summed over the steps,
    the most two such walks can part. The port's LSTM bias_ih is the JAX
    bias and its bias_hh stays 0 (frozen in this test: trained, it would
    take the same update again and move the LSTM's summed bias twice)."""
    jcfg, pcfg, jt, pt = parity
    assert len(pt.train_losses) == len(jt.train_losses) == 1
    np.testing.assert_allclose(pt.train_losses, jt.train_losses, rtol=1e-4)
    np.testing.assert_allclose(pt.val_losses, jt.val_losses, rtol=1e-4)
    np.testing.assert_allclose(pt.lr_history, jt.lr_history, rtol=1e-6)
    assert pt.state.step == int(jt.state.step) == 5
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jt.state.params), pcfg)
    got = pt.model.state_dict()
    travel = sum(pt.optimizer.schedule(c) for c in range(5))  # Adam's largest travel: Σ lr
    for name, w in want.items():
        g = got[name]
        if "bias_hh" in name:
            assert not g.any(), name
            continue
        err = float((g - w).abs().max())
        tol = 2 * travel if _is_key_bias(name) else 1e-4 * float(w.abs().max())
        assert err <= tol, (name, err, tol)
    _, _, jpreds, jtargets, _ = jt.validate()
    _, _, ppreds, ptargets, _ = pt.validate()
    assert list(ppreds) == list(jpreds) and list(ptargets) == list(jtargets)
    assert pt.evaluate_test_set() == pytest.approx(jt.evaluate_test_set(), abs=1e-12)


def _is_key_bias(name: str) -> bool:
    return name.endswith(("key.bias", "k_proj.bias", "in_proj_bias"))


def test_both_trainers_write_the_best_model(parity):
    jcfg, pcfg, jt, pt = parity
    for cfg in (jcfg, pcfg):
        meta = json.loads((Path(cfg.save_path) / "best_model" / "meta.json").read_text())
        assert meta["epoch"] == 0 and set(meta["metrics"]) == {
            "val_loss", "val_accuracy", "val_f1_macro", "val_f1_weighted"}
    assert (Path(pcfg.save_path) / "best_model" / checkpoint.FILENAME).exists()
    assert sorted(p.name for p in Path(pcfg.log_path).glob("*.png")) == sorted(
        p.name for p in Path(jcfg.log_path).glob("*.png"))


def test_trainer_resume_continues_epochs_steps_and_schedule(jax_model, sample_dir, tmp_path):
    """A trained run saved and resumed with more epochs starts at the next
    epoch and step, with the loader's epoch seed and the generator where
    the first run left them."""
    cfg = _port_cfg(dataclasses.replace(jax_model[0], save_path=str(tmp_path / "ck"),
                                        log_path=str(tmp_path / "logs")))
    cfg.num_epochs = 1
    cfg.device_data_cache_mb = 0
    loaders = _loaders(pdataset, sample_dir, cfg, batch_size=4)
    model = create_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    first = trainer.AdvancedTrainer(model, cfg, loaders["train"], loaders["val"], seed=3)
    first.train()
    assert (first.state.step, first.optimizer.count) == (3, 3)
    checkpoint.save_checkpoint(str(tmp_path / "final"), model, first.state, first.optimizer,
                               epoch=first.current_epoch, config=cfg)
    cfg2 = dataclasses.replace(cfg, num_epochs=2)
    resumed = trainer.AdvancedTrainer(create_model(cfg2, device="cpu"), cfg2,
                                      loaders["train"], loaders["val"], seed=3,
                                      resume_from=str(tmp_path / "final"))
    assert resumed.start_epoch == 1 and resumed.state.step == 3
    resumed.train()
    assert resumed.current_epoch == 1 and resumed.state.step == 6
    assert len(resumed.lr_history) == 1


def test_robustness_trainer_names_the_seven_scenarios(jax_model, sample_dir, tmp_path):
    cfg = _port_cfg(dataclasses.replace(jax_model[0], save_path=str(tmp_path / "ck"),
                                        log_path=str(tmp_path / "logs")))
    loaders = _loaders(pdataset, sample_dir, cfg, batch_size=4)
    model = create_model(cfg, "robust", device="cpu")
    rt = trainer.RobustnessTrainer(model, cfg, loaders["train"], loaders["val"], seed=0)
    loss = rt.train_with_missing_modalities()["avg_loss"]
    assert np.isfinite(loss) and rt.state.step == 3
    results = rt.evaluate_robustness()
    want = ["all" if not m else "_".join(m) + "_missing"
            for m in jtrainer.RobustnessTrainer.SCENARIOS]
    assert list(results) == want and len(want) == 7
    for m in results.values():
        assert set(m) == {"accuracy", "f1_macro"} and 0.0 <= m["accuracy"] <= 1.0


def test_fewshot_trainer_trains_only_the_marked_parameters(jax_model, sample_dir):
    cfg = _port_cfg(jax_model[0])
    train = pdataset.get_dataset("sample", sample_dir, "train", cfg)
    val = pdataset.get_dataset("sample", sample_dir, "val", cfg)
    support = pdataset.create_dataloader(pdataset.FewShotDataset(train, 1), 7, seed=1)
    query = pdataset.create_dataloader(pdataset.FewShotDataset(val, 1), 2, seed=1)
    model = create_model(cfg, "few_shot", device="cpu")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    ft = trainer.FewShotTrainer(model, cfg, support, query, n_way=7, n_shot=1)
    assert ft.TRAINABLE_MARKERS == jtrainer.FewShotTrainer.TRAINABLE_MARKERS
    batch = next(iter(support))
    assert list(ft._sort_by_label(batch)["emotion"]) == sorted(batch["emotion"])
    loss = ft.train_few_shot_episode(7, 1)
    assert np.isfinite(loss)
    for n, p in model.named_parameters():
        moved = not torch.equal(p.detach(), before[n])
        assert moved == trainer.is_trainable_name(n) or not trainer.is_trainable_name(n), n
        if not trainer.is_trainable_name(n):
            assert not moved, n
