"""Data parallelism of the port (``parallel/mesh.py``, ``DistributedLoader``,
the trainers and ``train_advanced_torch.py --mesh 2,1``) on the CPU: world 2
over gloo in spawned processes (tests/_torch_dist.py), held to world 1 and to
the JAX package's (2, 1) mesh on 2 of the 8 virtual CPU devices.

- Two train steps of the tiny hierarchical model at world 2 (dropout and
  augmentation off, the contrastive loss on) against world 1 on the same
  global batch of 8: loss and gradient norm within 1e-5 relative, every
  parameter within 1e-4 of its largest magnitude (and of JAX's absolute
  1e-4), both ranks bit-identical. Attention key biases get gradients that
  are zero in exact arithmetic, which Adam steps by the sign of f32 noise:
  they are held to twice the learning rate summed over the steps, the rule
  of tests/test_torch_trainer.py. With the contrastive term rank-local the
  same check fails.
- One epoch of the port's AdvancedTrainer at world 2 against the JAX
  AdvancedTrainer with ``mesh_shape=(2, 1)`` on the same weights and files,
  to ``test_trainer_epoch_matches_jax``'s bounds; validation equal on both
  ranks and to world 1; only rank 0 writes; resume 1 → 2 and 2 → 1.
- The kernels' hash masks on rank r are JAX shard r's; draws with a batch
  axis are the world-1 draws' rows; ``DistributedLoader`` keeps JAX's rows.

Every world-2 run starts at once in one module fixture (three groups) and
runs while the parent computes the references.
"""
import dataclasses
import functools
import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist as td
from _torch_layout import torch_layout
from simple_multimodal_tpu.data import dataset as jdataset
from simple_multimodal_tpu.data import sample_data as jsample
from simple_multimodal_tpu.data.pipeline import DistributedLoader as JaxDistributedLoader
from simple_multimodal_tpu.models import MultimodalEmotionModel
from simple_multimodal_tpu.models.convert_full import convert_multimodal_model
from simple_multimodal_tpu.ops.pallas import attention_block as jab
from simple_multimodal_tpu.ops.pallas import deberta_attention as jda
from simple_multimodal_tpu.parallel import mesh as jmesh
from simple_multimodal_tpu.train import trainer as jtrainer
from simple_multimodal_tpu_torch.data.augment import augment_batch
from simple_multimodal_tpu_torch.data.pipeline import DeviceCachedLoader, DistributedLoader
from simple_multimodal_tpu_torch.models.from_jax import state_dict_from_jax
from simple_multimodal_tpu_torch.models.multimodal_model import modality_dropout
from simple_multimodal_tpu_torch.models.wav2vec2 import spec_augment_mask
from simple_multimodal_tpu_torch.ops import attention as pattention
from simple_multimodal_tpu_torch.ops.hopper import attention_block as ab
from simple_multimodal_tpu_torch.ops.hopper import dropout as hd
from simple_multimodal_tpu_torch.parallel.mesh import (KERNEL_SEED_STRIDE, Mesh, make_mesh,
                                                       set_current_mesh, use_mesh)

WORLD = 2


@pytest.fixture(autouse=True)
def _no_port_mesh():
    yield
    set_current_mesh(None)


class _Deterministic:
    """The JAX model with dropout off inside the JAX trainer's own steps."""

    def __init__(self, model):
        self.model = model

    def apply(self, params, *args, rngs=None, **kw):
        kw["deterministic"] = True
        return self.model.apply(params, *args, **kw)


@pytest.fixture(scope="module")
def runs(tiny_config, tmp_path_factory):
    """The three world-2 groups (train steps, trainer, CLI) and, while they
    run, the references: world 1 of the steps and of the trainer, and the
    JAX trainer on a (2, 1) mesh."""
    root = tmp_path_factory.mktemp("dp")
    sample = jsample.create_sample_dataset(str(root / "sample"), 2, seed=42)
    jroot, proot = root / "jdata", root / "pdata"
    shutil.copytree(sample, jroot)
    shutil.copytree(sample, proot)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "transformers", None)  # no HF cache: skip the import
        jcfg = dataclasses.replace(tiny_config, num_epochs=1, gradient_clip_norm=1e6,
                                   batch_size=td.TRAINER_BATCH, save_path=str(root / "jck"),
                                   log_path=str(root / "jlogs"), mesh_shape=(WORLD, 1))
        jcfg.fusion_type = "hierarchical"
        for d in (jcfg.save_path, jcfg.log_path):
            Path(d).mkdir(parents=True, exist_ok=True)
        # the port's seeded weights as JAX params (no JAX init to compile) and
        # back: the port's then hold the JAX LSTM's one bias in bias_ih
        model = MultimodalEmotionModel(jcfg)
        sd = {k: v.numpy() for k, v in td.tiny_model(td.tiny_config(root)).state_dict().items()}
        params = {"params": convert_multimodal_model(sd, jcfg)}
        weights = root / "weights.pt"
        torch.save(state_dict_from_jax(params, td.tiny_config(root)), weights)

        # world 1 first: its checkpoint is the 1 → 2 resume, and its reads
        # leave the decoded-media sidecars in place before two ranks read them
        w1 = td.port_trainer(root / "w1", weights, str(proot), 1)
        w1.train()
        w1_val = w1.validate()
        w1.save_checkpoint("ck1", 0, w1_val[0])
        ck1 = str(Path(w1.config.save_path) / "ck1")
        set_current_mesh(None)

        groups = {"steps": td.Group(td.dp_step_rank, WORLD, root / "a"),
                  "trainer": td.Group(td.trainer_rank, WORLD, root / "b", weights=str(weights),
                                      data=str(proot), ck1=ck1),
                  "cli": td.Group(td.cli_rank, WORLD, root / "c", own_group=True,
                                  data=str(proot))}
        try:
            steps_w1 = td.train_two_steps(td.tiny_config(root / "s1"), td.global_batch())
            jl = {}
            for split in ("train", "val", "test"):
                jds = jdataset.get_dataset("sample", str(jroot), split, jcfg)
                jl[split] = jdataset.create_dataloader(jds, td.TRAINER_BATCH,
                                                       shuffle=split == "train", seed=0)
            jt = jtrainer.AdvancedTrainer(_Deterministic(model), jcfg, jl["train"], jl["val"],
                                          jl["test"], init_params=params, seed=0)
            # the epoch of jt.train() without its checkpoint and plots
            jt.current_epoch = 0
            jtrain = jt.train_epoch()
            jval = jt.validate()
            jhist = {"train_losses": [jtrain["total_loss"]],
                     "val_losses": [jval[0]["val_loss"]], "lr_history": [jt.current_lr()]}
            jtest = jt.evaluate_test_set()
            jparams = jax.tree_util.tree_map(np.asarray, jt.state.params)
        finally:
            jmesh.set_current_mesh(None)
            results = {name: g.results() for name, g in groups.items()}
    return dict(results, steps_w1=steps_w1, w1=w1, w1_val=w1_val, ck1=ck1, root=root,
                weights=weights, proot=proot, jt=jt, jhist=jhist, jval=jval, jtest=jtest,
                jstate=state_dict_from_jax(jparams, td.tiny_config(root)))


_is_key_bias = td.is_key_bias
_param_faults = td.param_faults
_step_faults = td.step_faults


def test_two_steps_at_world_2_equal_world_1(runs):
    want = runs["steps_w1"]
    ranks = [r["global"] for r in runs["steps"]]
    assert _step_faults(ranks[0], want) == []
    assert ranks[0][:2] == ranks[1][:2]
    for name, v in ranks[0][2].items():
        assert torch.equal(v, ranks[1][2][name]), name  # bit-identical on both ranks


def test_the_check_sees_a_rank_local_contrastive_loss(runs):
    """InfoNCE over each rank's own rows: its loss, gradients and update
    differ from world 1, and the check above says so."""
    local = runs["steps"][0]["local"]
    faults = _step_faults(local, runs["steps_w1"])
    assert any(f[0] == "loss" for f in faults)
    assert len(faults) > 2


def test_trainer_epoch_at_world_2_matches_the_jax_mesh_trainer(runs):
    """``test_trainer_epoch_matches_jax``'s bounds against the JAX trainer on
    a (2, 1) mesh: epoch loss, val_loss and every parameter within 1e-4
    relative, the learning rate within 1e-6, the key-bias travel rule, the
    LSTM's bias_hh at 0, equal predictions and test metrics."""
    jt, jhist = runs["jt"], runs["jhist"]
    steps = int(jt.state.step)
    for r in runs["trainer"]:
        np.testing.assert_allclose(r["train_losses"], jhist["train_losses"], rtol=1e-4)
        np.testing.assert_allclose(r["val_losses"], jhist["val_losses"], rtol=1e-4)
        np.testing.assert_allclose(r["lr_history"], jhist["lr_history"], rtol=1e-6)
        assert r["step"] == steps == 1
        _, _, jpreds, jtargets, _ = runs["jval"]
        assert r["preds"] == list(jpreds) and r["targets"] == list(jtargets)
        assert r["test"] == pytest.approx(runs["jtest"], abs=1e-12)
    got, want = runs["trainer"][0]["state_dict"], runs["jstate"]
    schedule = runs["w1"].optimizer.schedule
    travel = sum(schedule(c) for c in range(steps))  # Adam's largest travel: Σ lr
    for name, w in want.items():
        g = got[name]
        if "bias_hh" in name:
            assert not g.any(), name
            continue
        err = float((g - w).abs().max())
        tol = 2 * travel if _is_key_bias(name) else 1e-4 * float(w.abs().max())
        assert err <= tol, (name, err, tol)


def test_validation_is_global_and_equal_on_both_ranks_and_world_1(runs):
    w1_metrics, _, w1_preds, w1_targets, _ = runs["w1_val"]
    a, b = runs["trainer"]
    assert a["val"] == b["val"] and a["preds"] == b["preds"] and a["test"] == b["test"]
    assert a["preds"] == list(w1_preds) and a["targets"] == list(w1_targets)
    assert a["val"]["val_accuracy"] == w1_metrics["val_accuracy"]
    assert a["val"]["val_f1_macro"] == w1_metrics["val_f1_macro"]
    assert a["val"]["val_loss"] == pytest.approx(w1_metrics["val_loss"], rel=1e-5)
    for name, v in a["state_dict"].items():
        assert torch.equal(v, b["state_dict"][name]), name


def test_only_rank_0_writes(runs):
    for group in ("trainer", "cli"):
        rank0, rank1 = (r["writes"] for r in runs[group])
        assert rank1 == [] and rank0 and {rank for rank, _ in rank0} == {0}
    written = {Path(p).name for _, p in runs["trainer"][0]["writes"]}
    assert {"best_model", "ck2"} <= written
    assert {Path(p).name for _, p in runs["cli"][0]["writes"]} >= {"best_model",
                                                                  "final_model_early"}


def test_resume_from_world_1_at_world_2_and_back(runs):
    """A world-1 checkpoint resumes on both ranks of world 2, and a world-2
    one (rank 0's) at world 1, at the step and epoch saved."""
    w1 = runs["w1"]
    for r in runs["trainer"]:
        step, start_epoch, state = r["resumed"]
        assert (step, start_epoch) == (w1.state.step, 1)
        for name, v in w1.model.state_dict().items():
            assert torch.equal(state[name], v), name
    rank0 = runs["trainer"][0]
    back = td.port_trainer(runs["root"] / "back", runs["weights"], str(runs["proot"]), 1,
                           resume_from=rank0["ck2"])
    assert (back.state.step, back.start_epoch) == (rank0["step"], 1)
    for name, v in rank0["state_dict"].items():
        assert torch.equal(back.model.state_dict()[name], v), name
    metrics = back.train_epoch()
    assert np.isfinite(metrics["total_loss"]) and back.state.step == 2 * rank0["step"]


def test_cli_trains_under_a_two_process_launch(runs):
    a, b = runs["cli"]
    assert a["step"] == b["step"] > 0 and a["train_losses"] == b["train_losses"]
    assert np.isfinite(a["train_losses"]).all() and a["val_f1"] == b["val_f1"]
    for name, v in a["state_dict"].items():
        assert torch.equal(v, b["state_dict"][name]), name
    assert (Path(a["path"]) / "checkpoint.pt").exists()
    assert (Path(a["path"]).parent / "final_config.json").exists()


@pytest.mark.parametrize("mesh,error,match", [
    ("1,2", ValueError, "world size is 1"), ("2,1", ValueError, "world size is 1"),
    ("1,5", ValueError, "does not divide DeBERTa's 12 attention heads")])
def test_cli_refuses_a_mesh_the_processes_do_not_make(mesh, error, match, tmp_path):
    """--mesh 1,2 and --mesh 2,1 in one process: data x model must equal the
    number of processes; --mesh 1,5: the model axis must divide the base
    DeBERTa's 12 heads, checked before any process group or data."""
    with pytest.raises(error, match=match):
        td.load_cli().main(["--device", "cpu", "--mesh", mesh, "--data_path",
                            str(tmp_path), "--save_path", str(tmp_path / "ck")])


# ----------------------------------------------------------- random draws

def _jax_keep(seed, B, H, S, rate):
    u32 = jnp.uint32
    shape = (B, H, S, S)
    it = [jax.lax.broadcasted_iota(u32, shape, d) for d in range(4)]
    return np.asarray(jda._hash_keep(u32(np.int64(seed) & 0xFFFFFFFF),
                                     it[0] * np.uint32(H) + it[1], it[2], it[3], rate))


@pytest.mark.parametrize("seed", [777, 2 ** 31 - 2])  # the second wraps on rank 1
def test_kernel_hash_masks_of_rank_r_are_jax_shard_r(seed, monkeypatch):
    """The seed ``kernel_seed`` gives rank r is the JAX shard's (seed +
    r · 1000003 in int32); with it the port's plain attention_block over
    rank r's rows equals rows r of the JAX attention_block (interpret mode)
    under make_mesh((2, 1)), whose masks are those of the port's hash."""
    rng = np.random.default_rng(33)
    B, S, H, E, rate = 4, 24, 2, 32, 0.2
    x = rng.standard_normal((B, S, E)).astype(np.float32)
    wb = []
    for _ in range(4):
        wb += [(rng.standard_normal((E, E)) * 0.1).astype(np.float32),
               (rng.standard_normal((E,)) * 0.1).astype(np.float32)]
    jmesh.make_mesh((WORLD, 1))
    want = np.asarray(jab.attention_block(x, *wb, num_heads=H, dropout_rate=rate,
                                          dropout_seed=jnp.int32(seed)))
    jmesh.set_current_mesh(None)
    whole = np.asarray(jab.attention_block(x, *wb, num_heads=H, dropout_rate=rate,
                                           dropout_seed=jnp.int32(seed)))
    monkeypatch.setattr(torch, "randint",
                        lambda *a, **kw: torch.tensor([seed], dtype=torch.int32))
    n = B // WORLD
    for r in range(WORLD):
        with use_mesh(Mesh(data=WORLD, rank=r)):
            got_rate, got_seed = pattention.kernel_seed(torch.Generator(), rate, True, "cpu")
        wrapped = (seed + r * KERNEL_SEED_STRIDE + 2 ** 31) % 2 ** 32 - 2 ** 31
        assert got_rate == rate and int(got_seed) == wrapped
        keep = hd.attention_keep(got_seed, n, H, S, S, rate).numpy()
        np.testing.assert_array_equal(keep, _jax_keep(seed + r * KERNEL_SEED_STRIDE, n, H, S,
                                                      rate))
        t = [torch.from_numpy(x[r * n:(r + 1) * n]), *torch_layout(*wb)]
        got = ab.attention_block(*t, num_heads=H, dropout_rate=got_rate,
                                 dropout_seed=got_seed).numpy()
        np.testing.assert_allclose(got, want[r * n:(r + 1) * n], atol=1e-5, rtol=1e-5)
        if r:  # shard 1's masks are not those of rows 2-3 of the whole batch
            assert np.abs(got - whole[r * n:(r + 1) * n]).max() > 1e-2


def _draw(mesh, fn, seed=5):
    gen = torch.Generator().manual_seed(seed)
    with use_mesh(mesh):
        out = fn(gen)
    return out, gen.get_state()


def _rows(out, rows):
    if isinstance(out, torch.Tensor):
        return out[rows]
    return type(out)(_rows(o, rows) for o in out)


def _assert_same(a, b):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    else:
        for x, y in zip(a, b):
            _assert_same(x, y)


def test_draws_with_a_batch_axis_are_the_rows_of_the_world_1_draws():
    """Dropout, the modality dropout, SpecAugment's span starts and the
    augmentation draw at the global batch size and keep rank r's rows, and
    leave the generator where world 1 leaves it; a draw without a batch axis
    (DeBERTa's position table) is the same on every rank."""
    B = 6
    g = torch.Generator().manual_seed(1)
    feats = [torch.randn(B, 8, generator=g) for _ in range(3)]
    audio, video = torch.randn(B, 400, generator=g), torch.rand(B, 2, 4, 4, 3, generator=g)
    cases = [
        lambda rows: lambda gen: pattention.dropout(torch.ones(B, 3, 5)[rows], 0.5, gen, True),
        lambda rows: lambda gen: modality_dropout(*(f[rows] for f in feats), 0.6, gen),
        lambda rows: lambda gen: spec_augment_mask(len(range(B)[rows]), 40, 0.2, 3, gen, "cpu"),
        lambda rows: lambda gen: augment_batch(audio[rows], video[rows], gen),
    ]
    for case in cases:
        whole, state = _draw(None, case(slice(None)))
        for r in range(3):
            mesh = Mesh(data=3, rank=r)
            rows = mesh.rows(B)
            got, got_state = _draw(mesh, case(rows))
            _assert_same(got, _rows(whole, rows))
            assert torch.equal(got_state, state)
    table = functools.partial(pattention.dropout, torch.ones(10, 4), 0.5, training=True,
                              batch_axis=False)
    whole, _ = _draw(None, lambda gen: table(gen))
    got, _ = _draw(Mesh(data=3, rank=2), lambda gen: table(gen))
    assert torch.equal(got, whole)


# ---------------------------------------------------------------- loaders

class _Loader(list):
    dataset = None
    epochs = []

    def set_epoch(self, epoch):
        self.epochs.append(epoch)


def _host_batches(B=4, n=3):
    rng = np.random.default_rng(3)
    return _Loader({"text": {"input_ids": rng.integers(0, 99, (B, 5)),
                             "attention_mask": rng.integers(0, 2, (B, 5)).astype(np.int32)},
                    "audio": rng.standard_normal((B, 7)).astype(np.float32),
                    "video": rng.integers(0, 256, (B, 2, 2, 2, 3), np.uint8),
                    "emotion": rng.integers(0, 7, B),
                    "sample_ids": [f"s{i}_{j}" for j in range(B)],
                    "text_raw": [f"t{i}_{j}" for j in range(B)]} for i in range(n))


def _flat(batch):
    out = {}
    for k, v in batch.items():
        if isinstance(v, dict):
            out.update({f"{k}.{kk}": vv for kk, vv in v.items()})
        else:
            out[k] = v
    return out


def test_distributed_loader_keeps_the_jax_rows_and_host_fields(monkeypatch):
    """Rank r's arrays are the rows JAX's DistributedLoader hands process r
    of 2 (``make_array_from_process_local_data``'s local rows), the host
    fields whole, as JAX keeps them."""
    loader = _host_batches()
    mesh = jmesh.make_mesh((WORLD, 1))
    monkeypatch.setattr(jax, "process_count", lambda: WORLD)
    monkeypatch.setattr(jax, "make_array_from_process_local_data",
                        lambda sharding, local, global_shape: local)
    for r in range(WORLD):
        monkeypatch.setattr(jax, "process_index", lambda r=r: r)
        want = list(JaxDistributedLoader(loader, mesh))
        got = list(DistributedLoader(loader, Mesh(data=WORLD, rank=r)))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            g, w = _flat(g), _flat(w)
            assert set(g) == set(w)
            for k in w:
                if k in ("sample_ids", "text_raw"):
                    assert g[k] == w[k] and len(g[k]) == 4
                else:
                    np.testing.assert_array_equal(g[k], w[k])
                    assert len(g[k]) == 2
    DistributedLoader(loader, Mesh(data=WORLD)).set_epoch(4)
    assert loader.epochs[-1] == 4


def test_distributed_loader_refuses_a_batch_the_data_axis_does_not_divide():
    with pytest.raises(ValueError, match="does not split"):
        next(iter(DistributedLoader(_host_batches(B=3), Mesh(data=WORLD))))


def test_device_cached_loader_under_a_mesh_yields_the_rank_rows():
    loader = _host_batches(B=4, n=3)
    whole = DeviceCachedLoader(loader, "cpu", seed=2)
    whole.set_epoch(1)
    want = list(whole)
    for r in range(WORLD):
        mesh = Mesh(data=WORLD, rank=r)
        cached = DeviceCachedLoader(loader, "cpu", seed=2, mesh=mesh)
        cached.set_epoch(1)
        for g, w in zip(cached, want):
            g, w = _flat(g), _flat(w)
            for k in w:
                if k in ("sample_ids", "text_raw"):
                    assert g[k] == w[k]
                else:
                    assert torch.equal(g[k], w[k][mesh.rows(4)])


def test_make_mesh_reads_the_world_and_registers_itself():
    mesh = make_mesh((-1, 1), "cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.size == 1
    assert not mesh.distributed and mesh.rows(4) == slice(0, 4)
    from simple_multimodal_tpu_torch.parallel.mesh import current_mesh

    assert current_mesh() is mesh
