"""The DeepSeek-V3 text tower (Moonlight-16B-A3B's decoder, ``models/deepseek.py``)
on the CPU at the tiny preset, in f32, against the benchmark's plain
reference (``portbench/reference/moonlight.py``): the tower's forward
(1e-5) and every parameter's gradient (1e-4), the router, RoPE's
de-interleave on a hand-worked case, the expert share (the shares' parts
add up to the uncut layer), one whole-model ``make_train_step`` step, the
published weight names, the spans and the expert counter, the model axis's
refusal, and data parallelism at world 2 (two gloo processes) through the
steps and ``train_advanced_torch.py``.
"""
import dataclasses
import math
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile, record_function

import _torch_dist as td
from portbench import spans, trace
from portbench.reference import mesh as ref_mesh
from portbench.reference import model as ref
from portbench.reference import moonlight as ml
from portbench.tests.tiny_moonlight import TOWER, tiny_moonlight_config
from simple_multimodal_tpu_torch.models.deepseek import (MOONLIGHT, DeepseekConfig, DeepseekModel,
                                                         MoE, apply_rope, route)
from simple_multimodal_tpu_torch.ops.hopper.moe_experts import TILE, dispatch, rows_bound
from simple_multimodal_tpu_torch.models.safetensors_io import (deepseek_state_dict,
                                                               load_pretrained_backbones,
                                                               save_safetensors)
from simple_multimodal_tpu_torch.ops.hopper import dropout as kernel_dropout
from simple_multimodal_tpu_torch.parallel.mesh import Mesh
from simple_multimodal_tpu_torch.parallel.tensor import shard_module

ROOT = Path(__file__).resolve().parents[1]
S = 12


def tower_cfg(share=(0, 1)):
    """The reference's tower numbers for the tiny preset with ``share``."""
    cfg = tiny_moonlight_config(share)
    return ml.tower_config(cfg)


def program_tower(share=(0, 1), seed=0):
    """The tiny tower with ``share``, its weights those of the uncut
    reference spec drawn from ``seed`` (f32 CPU), the held experts' of them
    (every share holds the same weights); → (tower, the weights it holds,
    the reference's tower numbers)."""
    c = tower_cfg(share)
    cfg = dataclasses.replace(DeepseekConfig.tiny(), vocab_size=TOWER["vocab_size"],
                              expert_share=tuple(share))
    tower = DeepseekModel(cfg)
    names = {n for n, _, _ in ml.tower_spec(c)}
    P = {k: v for k, v in _weights(tower_cfg(), seed).items() if k in names}
    tower.load_state_dict({k[len(ml.PREFIX):]: v for k, v in P.items()})
    return tower, P, c


def _weights(c, seed):
    from portbench import weights

    return weights.make(ml.tower_spec(c), seed, "cpu")


def _ids(B=2, seed=1):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(100, TOWER["vocab_size"], (B, S), generator=g)
    mask = torch.ones(B, S, dtype=torch.long)
    mask[1, 8:] = 0  # right padding
    return ids * mask, mask


@pytest.mark.parametrize("share", [(0, 1), (1, 4)])
def test_tower_forward_matches_the_reference(share):
    tower, P, c = program_tower(share)
    ids, mask = _ids()
    with torch.no_grad():
        got = tower(ids, mask, torch.float32)
        want = ml.tower(ref.Run(), P, c, ids)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_every_gradient_matches_the_reference():
    tower, P, c = program_tower((0, 2))
    ids, mask = _ids()
    w = torch.randn(2, S, c["hidden_size"], generator=torch.Generator().manual_seed(3))
    (tower(ids, mask, torch.float32) * w).sum().backward()
    leaves = {k: v.requires_grad_() for k, v in P.items() if "correction_bias" not in k}
    (ml.tower(ref.Run(), P, c, ids) * w).sum().backward()
    got = dict(tower.named_parameters())
    assert len(got) == len(leaves)
    for name, leaf in leaves.items():
        g = got[name[len(ml.PREFIX):]].grad
        want = leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)
        torch.testing.assert_close(g if g is not None else torch.zeros_like(want), want,
                                   atol=1e-4, rtol=1e-4, msg=name)


# ------------------------------------------------------------------ routing

def test_the_bias_changes_the_choice_and_not_the_weight():
    logits = torch.tensor([[2.0, 1.0, 0.5, -1.0]])
    plain, w_plain = route(logits, torch.zeros(4), 2, 1.0)
    bias = torch.tensor([0.0, 0.0, 0.0, 0.9])  # lifts expert 3 past expert 1
    chosen, w = route(logits, bias, 2, 1.0)
    assert sorted(plain[0].tolist()) == [0, 1] and sorted(chosen[0].tolist()) == [0, 3]
    s = torch.sigmoid(logits[0])
    want = {j: float(s[j] / (s[0] + s[3])) for j in (0, 3)}  # the scores, not score + bias
    assert {int(j): float(x) for j, x in zip(chosen[0], w[0])} == pytest.approx(want, abs=1e-7)
    ref_choice, ref_w = ml.route({"num_experts_per_tok": 2, "routed_scaling_factor": 1.0},
                                 logits, bias)
    assert torch.equal(ref_choice, chosen) and torch.equal(ref_w, w)


def test_weights_sum_to_the_scaling_factor_when_every_choice_is_held():
    tower, _, _ = program_tower((0, 1))
    moe = tower.layers[1].mlp
    x = torch.randn(5, 64, generator=torch.Generator().manual_seed(2))
    _, w = route(x @ moe.gate.weight.t(), moe.gate.e_score_correction_bias, 4, 2.446)
    torch.testing.assert_close(w.sum(-1), torch.full((5,), 2.446))


def test_permuted_experts_give_the_same_layer():
    """Relabelling the experts (router rows, biases and expert weights
    together) leaves the layer's output as it was."""
    tower, _, _ = program_tower((0, 1))
    moe = tower.layers[1].mlp
    x = torch.randn(1, 6, 64, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        want = moe(x, torch.float32)
        perm = torch.randperm(16, generator=torch.Generator().manual_seed(5))
        moe.gate.weight.copy_(moe.gate.weight[perm])
        moe.gate.e_score_correction_bias.copy_(moe.gate.e_score_correction_bias[perm])
        old = {j: {k: v.clone() for k, v in moe.experts[str(j)].state_dict().items()}
               for j in range(16)}
        for new, j in enumerate(perm.tolist()):
            moe.experts[str(new)].load_state_dict(old[j])
        got = moe(x, torch.float32)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


def test_an_expert_with_no_rows_gets_a_zero_gradient():
    """A held expert that no token chooses still gets a gradient, of zeros
    (so every data-parallel rank reduces the same list); the output is the
    same as with the expert left out."""
    tower, _, _ = program_tower((0, 1))
    moe = tower.layers[1].mlp
    with torch.no_grad():
        moe.gate.e_score_correction_bias.zero_()
        moe.gate.e_score_correction_bias[5] = -100.0  # no token chooses expert 5
    x = torch.randn(1, 6, 64, generator=torch.Generator().manual_seed(6))
    out = moe(x, torch.float32)
    out.square().sum().backward()
    assert int(moe.routed_rows[5]) == 0
    for p in moe.experts["5"].parameters():
        assert p.grad is not None and not p.grad.any()
    assert all(p.grad is not None and p.grad.any() for p in moe.experts["0"].parameters()
               if int(moe.routed_rows[0]))
    with torch.no_grad():
        torch.testing.assert_close(moe(x, torch.float32), out.detach())


def test_rope_deinterleave_on_a_hand_worked_case():
    """d = 4 at position p: (a, b, c, d) is read as (a, c, b, d), then
    rotated by p and p·θ^(−1/2)."""
    theta, p = 50000.0, 3
    x = torch.tensor([1.0, 2.0, 3.0, 4.0])
    a, b, c, d = x.tolist()
    f0, f1 = p * 1.0, p * theta ** -0.5
    want = torch.tensor([a * math.cos(f0) - b * math.sin(f0), c * math.cos(f1) - d * math.sin(f1),
                         b * math.cos(f0) + a * math.sin(f0), d * math.cos(f1) + c * math.sin(f1)])
    seq = torch.zeros(1, p + 1, 1, 4)
    seq[0, p, 0] = x
    from simple_multimodal_tpu_torch.models.deepseek import rope_tables

    cos, sin = rope_tables(p + 1, 4, theta, "cpu")
    torch.testing.assert_close(apply_rope(seq, cos, sin)[0, p, 0], want, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(ml.rope(seq, theta)[0, p, 0], want, atol=1e-6, rtol=1e-6)


def test_expert_shares_add_up_to_the_uncut_layer():
    """Eight shares of a tiny MoE layer (two experts each): their parts,
    with the shared experts counted once, are the uncut reference layer."""
    full, P, c = program_tower((0, 1))
    x = torch.randn(2, S, 64, generator=torch.Generator().manual_seed(6))
    lp = ml.PREFIX + "layers.1.mlp."
    with torch.no_grad():
        want = ml.moe(ref.Run(), P, c, lp, x)
        shared = full.layers[1].mlp.shared_experts(x, torch.float32)
        total = shared.clone()
        for i in range(8):
            part, _, _ = program_tower((i, 8))
            total += part.layers[1].mlp(x, torch.float32) - shared
    torch.testing.assert_close(total, want, atol=1e-5, rtol=1e-5)


# ------------------------------------------------------- the routed experts

def per_expert_loop(moe, h):
    """The held experts as ``MoE.forward`` ran them before ``moe_experts``
    (f32): a host read of the row counts, then for each held expert its
    rows' gather, its MLP on ``gemm_linear`` and an f32 ``index_add_``; an
    idle expert enters the graph times zero."""
    cfg = moe.cfg
    k, n = cfg.num_experts_per_tok, len(moe.held)
    choice, weights = route(F.linear(h.float(), moe.gate.weight),
                            moe.gate.e_score_correction_bias, k, cfg.routed_scaling_factor)
    local = choice - moe.held.start
    slot = torch.where((local >= 0) & (local < n), local, n).reshape(-1)
    order = torch.argsort(slot, stable=True)
    sizes = torch.bincount(slot, minlength=n + 1)[:n].tolist()
    out = torch.zeros(h.shape, dtype=torch.float32)
    weights = weights.reshape(-1)
    start, idle = 0, []
    for j, rows in zip(moe.held, sizes):
        if rows:
            idx = order[start:start + rows]
            tokens = idx // k
            y = moe.experts[str(j)](h[tokens], torch.float32)
            out.index_add_(0, tokens, y.float() * weights[idx, None])
        else:
            idle += [p.sum() for p in moe.experts[str(j)].parameters()]
        start += rows
    if idle:
        out = out + 0.0 * torch.stack(idle).sum()
    return out


# correction biases that force a routing: expert 5 taken by no token, expert 3 by every one
ROUTINGS = {"as drawn": {}, "an idle expert": {5: -100.0}, "an expert every token takes": {3: 100.0},
            "both": {3: 100.0, 5: -100.0}}


@pytest.mark.parametrize("bias", list(ROUTINGS.values()), ids=list(ROUTINGS))
def test_grouped_experts_match_the_loop_and_the_reference(bias):
    """A MoE layer on ``moe_experts``' plain version against the parent's
    per-expert loop (with the same shared experts) and against the
    reference's layer: the output at 1e-5, the input's and every
    parameter's gradient at 1e-4, and the counts the dispatch keeps."""
    tower, P, c = program_tower((0, 1))
    moe = tower.layers[1].mlp
    lp = ml.PREFIX + "layers.1.mlp."
    with torch.no_grad():
        for j, b in bias.items():
            moe.gate.e_score_correction_bias[j] = b
    P = dict(P, **{lp + "gate.e_score_correction_bias": moe.gate.e_score_correction_bias.clone()})
    x = torch.randn(2, S, 64, generator=torch.Generator().manual_seed(8))
    w = torch.randn(2, S, 64, generator=torch.Generator().manual_seed(9))
    names = [n for n, _ in moe.named_parameters()]

    def run(fn, leaves):
        xs = x.clone().requires_grad_()
        for t in leaves:
            t.grad = None
        out = fn(xs)
        (out * w).sum().backward()
        # the reference gives an idle expert no gradient: zeros
        return [out.detach(), xs.grad] + [torch.zeros_like(t) if t.grad is None else t.grad
                                          for t in leaves]

    def loop(xs):
        h = xs.reshape(-1, 64)
        return (moe.shared_experts(h, torch.float32) + per_expert_loop(moe, h)).reshape(x.shape)

    params = list(moe.parameters())
    got = run(lambda xs: moe(xs, torch.float32), params)
    want_loop = run(loop, params)
    leaves = [P[lp + n].clone().requires_grad_() for n in names]
    ref_p = dict(P, **{lp + n: t for n, t in zip(names, leaves)})
    want_ref = run(lambda xs: ml.moe(ref.Run(), ref_p, c, lp, xs), leaves)
    for want in (want_loop, want_ref):
        for i, (a, b) in enumerate(zip(got, want)):
            tol = 1e-5 if i == 0 else 1e-4
            torch.testing.assert_close(a, b, atol=tol, rtol=tol,
                                       msg=(["output", "input"] + names)[i])
    h = x.reshape(-1, 64)
    with torch.no_grad():
        choice, _ = route(F.linear(h, moe.gate.weight), moe.gate.e_score_correction_bias, 4, 1.0)
    plan = dispatch(choice, 0, 16)
    assert torch.equal(plan.counts.long(), torch.bincount(choice.reshape(-1), minlength=16))
    if 5 in bias:
        assert int(plan.counts[5]) == 0 and not any(p.grad.any() for p in
                                                    moe.experts["5"].parameters())
    if 3 in bias:
        assert int(plan.counts[3]) == h.shape[0]
    assert torch.equal(moe.routed_rows, plan.counts.long())


@pytest.mark.parametrize("share,T", [((0, 1), 40), ((1, 4), 300), ((3, 4), 1)])
def test_dispatch_places_every_held_choice_once_in_expert_order(share, T):
    """``dispatch``: each held (token, choice) gets one row inside its
    expert's segment, in (token, choice) order; segments are padded to
    multiples of 128 and fit the bound; the other choices get −1."""
    k, experts = 4, 16
    n = experts // share[1]
    start = share[0] * n
    g = torch.Generator().manual_seed(T)
    choice = torch.stack([torch.randperm(experts, generator=g)[:k] for _ in range(T)])
    plan = dispatch(choice, start, n)
    offsets, counts, pos = plan.offsets.tolist(), plan.counts.tolist(), plan.pos.reshape(-1)
    assert offsets[0] == 0 and all(o % TILE == 0 for o in offsets)
    assert offsets[-1] <= plan.rows == rows_bound(T, k, n)
    for e in range(n):
        assert offsets[e + 1] - offsets[e] == -(-counts[e] // TILE) * TILE
        mine = [i for i, j in enumerate(choice.reshape(-1).tolist()) if j == start + e]
        assert len(mine) == counts[e]
        assert pos[mine].tolist() == list(range(offsets[e], offsets[e] + counts[e]))
        assert plan.entry[pos[mine].long()].tolist() == mine
    held = (choice >= start) & (choice < start + n)
    assert torch.equal(plan.pos < 0, ~held)
    assert torch.equal(plan.slot, torch.where(held, choice - start, n))


# -------------------------------------------------------- the whole model

def test_a_train_step_matches_the_reference():
    """The benchmark's loop at the tiny sizes, on the CPU (in this process,
    whose test set-up has JAX loaded, so past ``run.main``'s import check):
    ``make_train_step`` with the tower against the reference's steps."""
    import json
    import time
    from types import SimpleNamespace

    from portbench import harness

    sys.path.insert(0, str(ROOT / "portbench"))
    import run

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell, _, traffic, limits = run.cell_files(bench, "moonlight.train")
    loop = run.load_file(ROOT / "portbench" / "loops" / "train_moonlight.py", "loop_moonlight")
    torch.manual_seed(0)
    ctx = harness.Context(args=SimpleNamespace(seed=2147483701, seconds=0.3, trace=0), cell=cell,
                          cfg=tiny_moonlight_config((1, 2)), traffic=traffic, limits=limits,
                          start=time.perf_counter(), device=torch.device("cpu"), root=ROOT)
    loop.run(ctx)
    assert ctx.correct and ctx.attempted >= 1 and ctx.failed == 0
    numbers = {k: v for k, (v, _) in ctx.checks.items()}
    for line in ctx.info:  # a number the cell prints without comparing it
        if line.endswith("(not compared in this cell)"):
            numbers[line.split()[0]] = float(line.split()[1])
    assert numbers["loss_gap"] < 1e-5 and numbers["grad_gap"] < 1e-4
    assert numbers["update_gap"] < 1e-3


# ------------------------------------------------------------ weight names

def test_a_checkpoint_with_every_expert_loads_only_the_held_share(tmp_path):
    """A synthetic DeepseekV3ForCausalLM file (all 16 experts, three layers
    and an LM head) into a two-layer tower holding experts 4-7 (the second
    of four shares): only those experts, and no third layer nor head, are
    read, under the published names."""
    whole = DeepseekModel(DeepseekConfig.tiny())
    g = torch.Generator().manual_seed(7)
    sd = {"model." + k: torch.randn(v.shape, generator=g) for k, v in whole.state_dict().items()}
    sd["lm_head.weight"] = torch.randn(1000, 64, generator=g)
    save_safetensors(sd, str(tmp_path / "model.safetensors"))
    cfg = dataclasses.replace(DeepseekConfig.tiny(), num_hidden_layers=2, expert_share=(1, 4))
    got = deepseek_state_dict(str(tmp_path), cfg)
    experts = {int(k.split(".experts.")[1].split(".")[0]) for k in got if ".experts." in k}
    assert experts == {4, 5, 6, 7}
    assert not any(k.startswith(("layers.2.", "lm_head")) for k in got)

    model = td.tiny_model(td.tiny_config(tmp_path, text_model_name=MOONLIGHT, text_num_layers=2,
                                         text_expert_share=(1, 4)))
    model.text_encoder.model.embed_tokens = torch.nn.Embedding(1000, 64)  # the file's vocabulary
    load_pretrained_backbones(model, text=str(tmp_path))
    tower = model.text_encoder.model
    for name, v in tower.state_dict().items():
        assert torch.equal(v, sd["model." + name]), name
    assert list(tower.layers[1].mlp.experts) == ["4", "5", "6", "7"]


# ------------------------------------------------------- spans and counter

def _moonlight_port(tmp_path):
    cfg = td.tiny_config(tmp_path, text_model_name=MOONLIGHT)
    model = td.tiny_model(cfg)
    from simple_multimodal_tpu_torch.train.optim import make_optimizer
    from simple_multimodal_tpu_torch.train.steps import make_train_step

    step = make_train_step(model, make_optimizer(cfg, model, 10), cfg, augment=True)
    return model, step


def test_the_tower_spans_nest_under_the_text_encoder(tmp_path):
    from simple_multimodal_tpu_torch.train.state import TrainState

    model, step = _moonlight_port(tmp_path)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(trace.WINDOW):
            step(TrainState.create(0), td.global_batch(4))
    ops, _, _ = spans.events(prof)
    (text,) = [op for op in ops if op.name == "smm.encode.text"]
    found = {n: [op for op in ops if op.name == n]
             for n in ("smm.mla", "smm.moe.route", "smm.moe.experts", "smm.moe.shared")}
    L = len(model.text_encoder.model.layers)
    assert {n: len(v) for n, v in found.items()} == {
        "smm.mla": L, "smm.moe.route": L - 1, "smm.moe.experts": L - 1, "smm.moe.shared": L - 1}
    for n, v in found.items():
        assert all(text.start <= op.start and op.end <= text.end and op.tid == text.tid
                   for op in v), n


def test_the_counter_adds_no_host_synchronisation(tmp_path, monkeypatch):
    """A train step reads back from the tensors exactly what the DeBERTa
    model's step reads: no MoE layer reads its routing (no ``tolist`` of
    the row counts), the counter adds nothing, and it holds every routed
    row."""
    from simple_multimodal_tpu_torch.train.state import TrainState

    reads = []
    for method in ("tolist", "item", "cpu", "numpy", "__bool__", "__int__", "__float__"):
        original = getattr(torch.Tensor, method)

        def counted(self, *a, _original=original, _method=method, **kw):
            reads.append(_method)
            return _original(self, *a, **kw)

        monkeypatch.setattr(torch.Tensor, method, counted)
    batch = td.global_batch(4)
    deberta_model = td.tiny_model(td.tiny_config(tmp_path / "d"))
    from simple_multimodal_tpu_torch.train.optim import make_optimizer
    from simple_multimodal_tpu_torch.train.steps import make_train_step

    deberta_step = make_train_step(deberta_model, make_optimizer(deberta_model.config,
                                                                 deberta_model, 10),
                                   deberta_model.config, augment=True)
    model, step = _moonlight_port(tmp_path / "m")
    tower = model.text_encoder.model
    reads.clear()
    deberta_step(TrainState.create(0), batch)
    base = list(reads)
    reads.clear()
    step(TrainState.create(0), batch)
    moe_layers = sum(isinstance(layer.mlp, MoE) for layer in tower.layers)
    assert sorted(reads) == sorted(base)
    monkeypatch.undo()
    k = tower.cfg.num_experts_per_tok
    assert tower.routed_rows().sum().item() == moe_layers * 4 * 16 * k


# ---------------------------------------------------------------- parallel

def test_the_model_axis_refuses_the_tower_naming_its_parameters(tmp_path):
    model, _ = _moonlight_port(tmp_path)
    with pytest.raises(ValueError, match=r"text_encoder\.model.*q_proj.*mlp\.experts\.\*\."
                                         r"gate_proj\.weight.*d,1"):
        shard_module(model, Mesh(data=1, model=2))
    cli = td.load_cli()
    with pytest.raises(ValueError, match="kv_b_proj"):
        cli.main(["--device", "cpu", "--preset", "tiny", "--text_model_name", MOONLIGHT,
                  "--mesh", "1,2", "--data_path", str(tmp_path)])


def test_the_reference_hashes_each_block_as_its_rank():
    seed = torch.tensor([2 ** 31 - 2], dtype=torch.int32)  # wraps on rank 1
    with ref_mesh.ranks(2):
        got_ffn = ref_mesh.frozen.ffn_keep(seed, 1, 4, 3, 8, 0.5, "cpu")
        got_att = ref_mesh.frozen.attention_keep(seed, 4, 2, 3, 3, 0.5, "cpu")
    for r in range(2):
        wrapped = ((seed.long() + r * 1000003 + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)
        assert torch.equal(got_ffn[2 * r:2 * r + 2],
                           kernel_dropout.ffn_keep(wrapped, 1, 2, 3, 8, 0.5, device="cpu"))
        assert torch.equal(got_att[2 * r:2 * r + 2],
                           kernel_dropout.attention_keep(wrapped, 2, 2, 3, 3, 0.5, device="cpu"))
    assert not torch.equal(got_ffn[:2], got_ffn[2:])


def moonlight_rank(rank, world, tmp, data):
    """Two train steps of the tiny Moonlight model under a (world, 1) mesh
    (none at world 1) on the global batch, the second under the profiler,
    then one epoch of ``train_advanced_torch.py --mesh world,1`` with the
    tower."""
    import functools

    from simple_multimodal_tpu_torch.parallel import mesh
    from simple_multimodal_tpu_torch.train.optim import make_optimizer
    from simple_multimodal_tpu_torch.train.state import TrainState
    from simple_multimodal_tpu_torch.train.steps import make_train_step

    cfg = td.tiny_config(Path(tmp) / f"s{rank}", text_model_name=MOONLIGHT)
    model = td.tiny_model(cfg)
    m = mesh.make_mesh((world, 1), device="cpu") if world > 1 else None
    step = make_train_step(model, make_optimizer(cfg, model, 10), cfg, mesh=m)
    batch = td.global_batch()
    if m is not None:
        batch = td.rows_of(batch, m.rows(8))
    state, losses = TrainState.create(3), []
    state, parts = step(state, batch)
    losses.append(float(parts["total_loss"]))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(trace.WINDOW):
            state, parts = step(state, batch)
    losses.append(float(parts["total_loss"]))
    ops, _, _ = spans.events(prof)
    (backward,) = [op for op in ops if op.name == "smm.backward"]
    reduce = [op for op in ops if op.name == "smm.allreduce"]
    nested = all(backward.start <= op.start and op.end <= backward.end for op in reduce)
    out = {"losses": losses, "state": {k: v.clone() for k, v in model.state_dict().items()},
           "allreduce": len(reduce), "nested": nested, "bytes": m.reduced_bytes if m else 0}
    mesh.set_current_mesh(None)
    if world > 1:  # the CLI makes its own group, as under torchrun
        import os

        torch.distributed.destroy_process_group()
        mesh.initialize_distributed = functools.partial(
            mesh.initialize_distributed, td.store_url(tmp, moonlight_rank) + ".cli")
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0")
    cli = td.load_cli()
    cli.ModelConfig = lambda **kw: td.tiny_config(Path(tmp) / f"c{rank}", **kw)
    res = cli.main(["--device", "cpu", "--preset", "tiny", "--mesh", f"{world},1",
                    "--text_model_name", MOONLIGHT, "--text_num_layers", "2",
                    "--data_path", data, "--save_path", str(Path(tmp) / "cli"),
                    "--epochs", "1", "--batch_size", "4"])
    t = res["trainer"]
    out.update(cli_step=t.state.step, cli_losses=t.train_losses, cli_state=td.state_of(t))
    mesh.set_current_mesh(None)
    return out


@pytest.fixture(scope="module")
def data_parallel(tmp_path_factory):
    import importlib.util

    root = tmp_path_factory.mktemp("moonlight_dp")
    spec = importlib.util.spec_from_file_location("create_sample_data_torch",
                                                  ROOT / "create_sample_data_torch.py")
    data_cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(data_cli)
    data = data_cli.main(["--output_dir", str(root / "data" / "sample"), "--num_samples", "2"])
    own = shutil.copytree(data, root / "w1data")  # its own decoded-media sidecars
    group = td.Group(moonlight_rank, 2, root / "w2", data=str(data))
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setitem(sys.modules, "transformers", None)  # no HF cache: skip the import
            one = moonlight_rank(0, 1, str(root / "w1"), str(own))
    finally:
        ranks = group.results()
    return one, ranks


def test_data_parallel_steps_equal_one_process(data_parallel):
    one, ranks = data_parallel
    for r in ranks:
        np.testing.assert_allclose(r["losses"], one["losses"], rtol=1e-5)
        for name, v in one["state"].items():
            torch.testing.assert_close(r["state"][name], v, atol=1e-5, rtol=1e-4, msg=name)
    assert one["allreduce"] == 0 and one["bytes"] == 0


def test_the_allreduce_span_sits_in_the_backward_and_counts_its_bytes(data_parallel):
    one, ranks = data_parallel
    params = sum(v.numel() for k, v in one["state"].items() if "correction_bias" not in k)
    tower = sum(v.numel() for k, v in one["state"].items()
                if k.startswith("text_encoder.model.") and "correction_bias" not in k)
    for r in ranks:
        assert r["allreduce"] == 2 and r["nested"]  # the gradients, then the loss parts
        # two steps' gradients in f32: every tower weight's (an idle expert's
        # zeros too), no more than every parameter's; and the few loss parts
        assert 2 * 4 * tower < r["bytes"] <= 2 * 4 * (params + 64)


def test_the_cli_trains_the_tower_on_one_and_two_ranks(data_parallel):
    one, (a, b) = data_parallel
    assert one["cli_step"] > 0 and np.isfinite(one["cli_losses"]).all()
    assert a["cli_step"] == b["cli_step"] > 0 and a["cli_losses"] == b["cli_losses"]
    assert np.isfinite(a["cli_losses"]).all()
    for name, v in a["cli_state"].items():
        assert torch.equal(v, b["cli_state"][name]), name
    assert "text_encoder.model.layers.1.mlp.experts.15.down_proj.weight" in a["cli_state"]
    assert not any(k.startswith("text_encoder.model.layers.2.") for k in a["cli_state"])
