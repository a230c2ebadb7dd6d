"""Tensor parallelism of the port (the mesh's ``model`` axis:
``parallel/tensor.py``, the head split of ``models/deberta.py``, the
trainers and ``train_advanced_torch.py --mesh 1,2``) on the CPU: meshes
(1, 2) over 2 processes and (2, 2) over 4, gloo groups in spawned processes
(tests/_torch_dist.py), held to the JAX rule, the JAX (1, 1) model, the JAX
(2, 2) ``deberta_attention`` and the port's world 1.

- Spec parity: every parameter of the tiny hierarchical and late models is
  split as JAX ``param_partition_spec`` splits its ``from_jax`` counterpart
  (each JAX leaf carried through ``state_dict_from_jax`` as its elements'
  shard numbers), with equal sharded element counts; the MulT, adaptive,
  facial and temporal attention weights, which the JAX docstring calls
  replicated, are sharded as the rule's code does.
- Shards round-trip bit-exactly at m = 2 and 4; a width m does not divide
  raises, naming the parameter, as a head count does.
- DeBERTa's head split: the plain ``deberta_attention`` on each (data,
  model) shard with ``kernel_seed``'s offsets at rate 0.2 against JAX
  ``deberta_attention`` (interpret mode) under ``make_mesh((2, 2))``: the
  output and the q/k/v/table gradients within 1e-5, the masks equal.
- Eval logits at (1, 2) and (2, 2) against JAX (1, 1) on the same weights
  within 1e-4 (``tests/test_multidevice.py::test_tp_matches_replicated``).
- Two train steps at (1, 2) and (2, 2) (dropout and augmentation off, the
  contrastive loss on) against world 1 within
  ``test_two_steps_at_world_2_equal_world_1``'s bounds, the replicated
  parameters bit-identical on every process after each step; with the
  gathered weights' gradients summed over the model group, or the clip
  norm over local shards, the check fails.
- Resume (1, 1) → (1, 2) → (1, 1), and the CLI at ``--mesh 1,2`` under a
  two-process launch with rank 0 alone writing.

Every multi-process run starts at once in one module fixture and runs
while the parent computes the references.
"""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist as td
from simple_multimodal_tpu.models import MultimodalEmotionModel
from simple_multimodal_tpu.models.convert_full import convert_multimodal_model
from simple_multimodal_tpu.ops.pallas import deberta_attention as jda
from simple_multimodal_tpu.parallel import mesh as jmesh
from simple_multimodal_tpu_torch.data.sample_data import create_sample_dataset
from simple_multimodal_tpu_torch.models.from_jax import state_dict_from_jax
from simple_multimodal_tpu_torch.ops import attention as pattention
from simple_multimodal_tpu_torch.ops.hopper import deberta_attention as da
from simple_multimodal_tpu_torch.ops.hopper import dropout as hd
from simple_multimodal_tpu_torch.parallel.mesh import (KERNEL_SEED_STRIDE, MODEL_SEED_STRIDE,
                                                       Mesh, set_current_mesh, use_mesh)
from simple_multimodal_tpu_torch.parallel.tensor import (check_heads, param_partition_spec,
                                                         shard_module, shard_state_dict, split,
                                                         stitch)

MESHES = {"1x2": (2, 2), "2x2": (4, 2)}  # name: (world, model axis)


@pytest.fixture(autouse=True)
def _no_mesh():
    yield
    set_current_mesh(None)
    jmesh.set_current_mesh(None)


def _jax_config(tiny_config, fusion_type="hierarchical"):
    cfg = dataclasses.replace(tiny_config)
    cfg.fusion_type = fusion_type
    return cfg


@pytest.fixture(scope="module")
def runs(tiny_config, tmp_path_factory):
    """The groups (1, 2) and (2, 2) (eval, steps, faults; (1, 2) also the
    resume) and the CLI at (1, 2); meanwhile the references: JAX (1, 1)
    logits, world-1 steps, the world-1 trainer's two epochs."""
    root = tmp_path_factory.mktemp("tp")
    data = create_sample_dataset(str(root / "sample"), 2, seed=42, duration=0.3)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "transformers", None)  # no HF cache: skip the import
        jcfg = _jax_config(tiny_config)
        sd = {k: v.numpy() for k, v in td.tiny_model(td.tiny_config(root)).state_dict().items()}
        params = {"params": convert_multimodal_model(sd, jcfg)}
        weights = root / "weights.pt"
        torch.save(state_dict_from_jax(params, td.tiny_config(root)), weights)

        # world 1's first epoch: the checkpoint that (1, 2) resumes; its reads
        # leave the decoded-media sidecars in place before the ranks read them
        w1 = td.port_trainer(root / "w1", weights, data, 1)
        w1.train()
        w1.save_checkpoint("ck1", 0, {})
        ck1 = str(Path(w1.config.save_path) / "ck1")
        w1_state1, w1_step1 = td.state_of(w1), w1.state.step
        set_current_mesh(None)

        groups = {name: td.Group(td.tp_rank, world, root / name, model_axis=m,
                                 weights=str(weights), data=data,
                                 ck1=ck1 if name == "1x2" else None)
                  for name, (world, m) in MESHES.items()}
        groups["cli"] = td.Group(td.cli_rank, 2, root / "cli", own_group=True, data=data,
                                 model_axis=2)
        try:
            steps_w1 = td.train_two_steps(td.tiny_config(root / "s1"), td.global_batch())
            w1.current_epoch = 1
            w1_epoch2 = w1.train_epoch()
            set_current_mesh(None)
            batch = td.global_batch()
            inputs = ({k: v.numpy() for k, v in batch["text"].items()}, batch["audio"].numpy(),
                      batch["video"].numpy())
            model = MultimodalEmotionModel(jcfg)
            jlogits = np.asarray(jax.jit(model.apply)(params, *inputs)["emotion_logits"])
        finally:
            results = {name: g.results() for name, g in groups.items()}
    return dict(results, root=root, weights=weights, data=data, steps_w1=steps_w1,
                jlogits=jlogits, w1_state1=w1_state1, w1_step1=w1_step1,
                w1_epoch2=w1_epoch2, w1_state2=td.state_of(w1), w1=w1)


# ------------------------------------------------------------- the rule

def _encoded(params, m):
    """Each JAX leaf as 1 + the shard its elements fall in over a model axis
    of m under ``param_partition_spec`` (0: replicated)."""
    def one(path, value):
        keys = [getattr(p, "key", str(p)) for p in path]
        spec = jmesh.param_partition_spec(keys, value)
        value = np.asarray(value)
        axes = [i for i, a in enumerate(tuple(spec)) if a == "model"]
        if not axes:
            return np.zeros(value.shape, np.float32)
        n = value.shape[axes[0]]
        shard = np.arange(n) * m // n + 1
        shape = [1] * value.ndim
        shape[axes[0]] = n
        return np.broadcast_to(shard.reshape(shape), value.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(one, params)


@pytest.mark.parametrize("fusion_type", ["hierarchical", "late"])
def test_partition_spec_is_the_jax_rule_leaf_for_leaf(tiny_config, tmp_path, fusion_type):
    """Each port parameter's spec, by name, cuts it as the JAX rule cuts its
    JAX counterpart: the port's shard j holds exactly the elements JAX puts
    on model index j, and a replicated JAX leaf has no spec."""
    m = 2
    jcfg = _jax_config(tiny_config, fusion_type)
    pcfg = td.tiny_config(tmp_path)
    pcfg.fusion_type = fusion_type
    sd = {k: v.numpy() for k, v in td.tiny_model(pcfg).state_dict().items()}
    params = {"params": convert_multimodal_model(sd, jcfg)}
    leaves = jax.tree_util.tree_leaves_with_path(params)
    jax_sharded = sum(np.size(v) for path, v in leaves
                      if jmesh.param_partition_spec([getattr(p, "key", str(p)) for p in path], v)
                      != jax.sharding.PartitionSpec())
    placed = state_dict_from_jax(_encoded(params, m), pcfg)
    assert set(placed) == set(sd)
    port_sharded, sharded = 0, set()
    for name, t in placed.items():
        spec = param_partition_spec(name, t.ndim)
        if not t.any():
            assert spec is None, name
            continue
        assert spec is not None, name
        for j in range(m):
            assert (split(t, spec, m, j, name) == j + 1).all(), (name, j)
        port_sharded += t.numel()
        sharded.add(name)
    assert port_sharded == jax_sharded > 0
    if fusion_type == "hierarchical":
        docstring_says_replicated = {
            "fusion_layer.mult_fusion.text_to_audio.attention.in_proj_weight",
            "fusion_layer.mult_fusion.text_to_audio.attention.out_proj.weight",
            "fusion_layer.mult_fusion.video_to_audio.ffn.0.weight",
            "fusion_layer.mult_fusion.video_to_audio.ffn.3.weight",
            "fusion_layer.mult_fusion.audio_self_attn.in_proj_weight",
            "fusion_layer.adaptive_fusion.attention.in_proj_weight",
            "fusion_layer.adaptive_fusion.attention.out_proj.weight",
            "video_encoder.facial_attention.in_proj_weight",
            "audio_encoder.temporal_attention.out_proj.weight",
        }
        assert docstring_says_replicated <= sharded


@pytest.mark.parametrize("m", [2, 4])
def test_shards_round_trip_bit_exactly(tmp_path, m):
    cfg = td.tiny_config(tmp_path)
    model = td.tiny_model(cfg)
    whole = model.state_dict()
    shards = [shard_state_dict(whole, Mesh(data=1, model=m, rank=j)) for j in range(m)]
    n_sharded = 0
    for name, t in whole.items():
        spec = param_partition_spec(name, t.ndim)
        if spec is None:
            assert all(s[name] is t for s in shards), name
            continue
        n_sharded += 1
        assert all(s[name].numel() * m == t.numel() for s in shards), name
        assert torch.equal(stitch([s[name] for s in shards], spec), t), name
    assert n_sharded > 0
    if m > 2:  # the tiny DeBERTa's 2 heads split over 2 alone
        return
    # the module's own shards are the state's, tagged with the whole shape
    shard_module(model, Mesh(data=1, model=m, rank=m - 1))
    for name, p in model.named_parameters():
        assert torch.equal(p.detach(), shards[m - 1][name]), name
        if param_partition_spec(name, p.ndim) is not None:
            assert p.tp.shape == tuple(whole[name].shape), name


def test_a_model_axis_that_splits_no_width_or_head_count_raises(tmp_path):
    with pytest.raises(ValueError, match="does not split into 1 x 3 shards"):
        shard_state_dict(td.tiny_model(td.tiny_config(tmp_path)).state_dict(),
                         Mesh(data=1, model=3, rank=0))
    with pytest.raises(ValueError, match="does not divide .*'s 2 attention heads"):
        shard_module(td.tiny_model(td.tiny_config(tmp_path)), Mesh(data=1, model=4, rank=0))
    check_heads(6, 12, "DeBERTa")
    with pytest.raises(ValueError, match="DeBERTa's 12 attention heads"):
        check_heads(5, 12, "DeBERTa")


# ------------------------------------------------------- the head split

def _jax_keep(seed, B, H, S, rate):
    u32 = jnp.uint32
    shape = (B, H, S, S)
    it = [jax.lax.broadcasted_iota(u32, shape, d) for d in range(4)]
    return np.asarray(jda._hash_keep(u32(np.int64(seed) & 0xFFFFFFFF),
                                     it[0] * np.uint32(H) + it[1], it[2], it[3], rate))


@pytest.mark.parametrize("seed", [777, 2 ** 31 - 2])  # the second wraps past shard (0, 0)
def test_deberta_head_split_is_the_jax_2x2_shard_map(seed, monkeypatch):
    """Shard (i, j) of a (2, 2) mesh: rows i, heads j. The seed
    ``kernel_seed(model_axis=True)`` gives there is the JAX shard's (seed +
    i·1000003 + j·7919, int32), its masks are the JAX kernel's, and the
    port's plain kernel on the shard's rows, heads and head-sharded tables
    gives the JAX output's block; the q/k/v gradients are its blocks and the
    tables' gradients summed over the data shards are JAX's columns."""
    rng = np.random.default_rng(41)
    B, S, H, D, span, max_pos, rate = 4, 128, 4, 16, 16, 64, 0.2
    q, k, v, ct = (rng.standard_normal((B, S, H, D)).astype(np.float32) for _ in range(4))
    pos_k, pos_q = (rng.standard_normal((2 * span, H * D)).astype(np.float32) for _ in range(2))
    mask = np.ones((B, S), np.int32)
    mask[1, S // 2:] = 0
    mask[2, 100:] = 0
    kw = dict(span=span, max_position=max_pos, dropout_rate=rate)

    jmesh.make_mesh((2, 2))
    def fn(*a):
        return jda.deberta_attention(*a, mask, dropout_seed=jnp.int32(seed), **kw)

    want, vjp = jax.vjp(fn, q, k, v, pos_k, pos_q)
    want_grads = [np.asarray(g) for g in vjp(ct)]
    want = np.asarray(want)
    jmesh.set_current_mesh(None)

    monkeypatch.setattr(torch, "randint",
                        lambda *a, **kw: torch.tensor([seed], dtype=torch.int32))
    n, h = B // 2, H // 2
    table_grads = [np.zeros_like(pos_k), np.zeros_like(pos_q)]
    for r in range(4):
        i, j = divmod(r, 2)
        rows, heads, cols = slice(i * n, (i + 1) * n), slice(j * h, (j + 1) * h), \
            slice(j * h * D, (j + 1) * h * D)
        with use_mesh(Mesh(data=2, model=2, rank=r)):
            got_rate, got_seed = pattention.kernel_seed(torch.Generator(), rate, True, "cpu",
                                                        model_axis=True)
        offset = i * KERNEL_SEED_STRIDE + j * MODEL_SEED_STRIDE
        assert got_rate == rate
        assert int(got_seed) == (seed + offset + 2 ** 31) % 2 ** 32 - 2 ** 31
        np.testing.assert_array_equal(hd.attention_keep(got_seed, n, h, S, S, rate).numpy(),
                                      _jax_keep(seed + offset, n, h, S, rate))
        ins = [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_()
               for a in (q[rows, :, heads], k[rows, :, heads], v[rows, :, heads],
                         pos_k[:, cols], pos_q[:, cols])]
        got = da.deberta_attention(*ins, torch.from_numpy(mask[rows]), dropout_seed=got_seed,
                                   **kw)
        np.testing.assert_allclose(got.detach().numpy(), want[rows, :, heads],
                                   atol=1e-5, rtol=1e-5)
        got.backward(torch.from_numpy(np.ascontiguousarray(ct[rows, :, heads])))
        for t, w in zip(ins[:3], want_grads[:3]):
            np.testing.assert_allclose(t.grad.numpy(), w[rows, :, heads], atol=1e-5, rtol=1e-5)
        for acc, t in zip(table_grads, ins[3:]):
            acc[:, cols] += t.grad.numpy()
    for got, w in zip(table_grads, want_grads[3:]):
        np.testing.assert_allclose(got, w, atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------ the meshes

@pytest.mark.parametrize("mesh", list(MESHES))
def test_eval_logits_match_jax_1x1(runs, mesh):
    for r in runs[mesh]:
        np.testing.assert_allclose(r["logits"].numpy(), runs["jlogits"], atol=1e-4)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_two_steps_equal_world_1(runs, mesh):
    """``test_two_steps_at_world_2_equal_world_1``'s bounds; the replicated
    parameters bit-identical on every process after each step, the whole
    state equal on every process."""
    ranks = [r["steps"] for r in runs[mesh]]
    assert td.step_faults(ranks[0], runs["steps_w1"]) == []
    for other in ranks[1:]:
        assert other[:2] == ranks[0][:2] and other[3] == ranks[0][3]
        for name, v in ranks[0][2].items():
            assert torch.equal(v, other[2][name]), name


@pytest.mark.parametrize("fault", td.FAULTS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_the_check_sees_a_planted_fault(runs, mesh, fault):
    """The gathered weights' gradients summed over the model group, or the
    clip norm over local shards: the gradient norm and the parameters part
    from world 1; with the local clip norm the replicated parameters part
    between model processes too."""
    ranks = [r[fault] for r in runs[mesh]]
    faults = td.step_faults(ranks[0], runs["steps_w1"])
    assert any(f[0] == "grad_norm" for f in faults) and len(faults) > 2
    if fault == "clip_norm_local":
        assert len({r[3][0] for r in ranks}) > 1


def test_resume_from_1x1_at_1x2_and_back(runs):
    """The world-1 checkpoint after epoch 1 resumes on both processes of
    (1, 2) with the whole state as saved; their epoch 2 is world 1's within
    the step bounds; their checkpoint resumes at (1, 1) bit-exactly and
    trains on."""
    for r in runs["1x2"]:
        step, start_epoch, state = r["resumed"]
        assert (step, start_epoch) == (runs["w1_step1"], 1)
        for name, v in runs["w1_state1"].items():
            assert torch.equal(state[name], v), name
        np.testing.assert_allclose(r["epoch2"]["total_loss"], runs["w1_epoch2"]["total_loss"],
                                   rtol=1e-5)
        step, after = r["after"]
        travel = sum(runs["w1"].optimizer.schedule(c) for c in range(step))
        assert td.param_faults(after, runs["w1_state2"], travel) == []
    step, after = runs["1x2"][0]["after"]
    back = td.port_trainer(runs["root"] / "back", runs["weights"], runs["data"], 1,
                           resume_from=runs["1x2"][0]["ck2"])
    assert back.state.step == step
    for name, v in after.items():
        assert torch.equal(back.model.state_dict()[name], v), name
    back.current_epoch = 2
    assert np.isfinite(back.train_epoch()["total_loss"]) and back.state.step == step + 1


def test_cli_trains_at_mesh_1x2_and_rank_0_alone_writes(runs):
    a, b = runs["cli"]
    assert a["step"] == b["step"] > 0 and a["train_losses"] == b["train_losses"]
    assert np.isfinite(a["train_losses"]).all() and a["val_f1"] == b["val_f1"]
    for name, v in a["state_dict"].items():
        assert torch.equal(v, b["state_dict"][name]), name
    assert b["writes"] == [] and {rank for rank, _ in a["writes"]} == {0}
    assert {Path(p).name for _, p in a["writes"]} >= {"best_model", "final_model_early"}
    saved = torch.load(Path(a["path"]) / "checkpoint.pt", weights_only=True)
    for name, v in a["state_dict"].items():  # the whole state, by the single-process names
        assert torch.equal(saved["state_dict"][name], v), name
