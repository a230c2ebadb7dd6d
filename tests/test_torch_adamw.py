"""The host side of the card's AdamW kernels (``ops/hopper/adamw.py``) on
the CPU: the chunk table, the tables' alignment with the optimizer's names
and backbone group, the gradient table's handling of None, the leaves it
refuses, and the kernels' arithmetic over the chunk table, written out in
plain torch, against the chain that ``AdamWChain.update`` runs on the CPU.
The kernels themselves run in ``tests/test_torch_gpu.py``.
"""
import math

import pytest
import torch

from simple_multimodal_tpu_torch.config import ModelConfig
from simple_multimodal_tpu_torch.models.multimodal_model import create_model
from simple_multimodal_tpu_torch.ops.hopper import adamw
from simple_multimodal_tpu_torch.train import optim

RAGGED = (1, 3, 4097, 2 ** 20 + 5)


@pytest.fixture(scope="module")
def tiny_opt(tmp_path_factory):
    """The tiny model's optimizer on the CPU (hierarchical fusion)."""
    tmp = tmp_path_factory.mktemp("adamw")
    cfg = ModelConfig(encoder_preset="tiny", text_max_length=16, audio_max_length=3200,
                      video_max_frames=4, video_frame_size=(32, 32), fusion_hidden_size=32,
                      fusion_num_heads=4, graph_hidden_size=16, data_path=str(tmp / "d"),
                      save_path=str(tmp / "c"), log_path=str(tmp / "l"))
    cfg.fusion_type = "hierarchical"
    model = create_model(cfg, device="cpu", dtype=torch.float32,
                         generator=torch.Generator().manual_seed(0))
    return optim.make_optimizer(cfg, model, total_steps=10)


@pytest.mark.parametrize("numels,chunk", [
    (RAGGED, adamw.CHUNK),
    (RAGGED + (0, adamw.CHUNK, adamw.CHUNK + 1, 2 * adamw.CHUNK), adamw.CHUNK),
    ((5, 0, 8, 9, 1, 31), 4),
])
def test_chunk_table_covers_every_element_once(numels, chunk):
    """Every element of every leaf lies in exactly one chunk, each chunk in
    one leaf, in leaf order, none empty or longer than ``chunk``."""
    leaf, begin = adamw.chunk_table(numels, chunk)
    assert len(begin) == len(numels) + 1 and begin[0] == 0 and begin[-1] == len(leaf)
    seen = [torch.zeros(n, dtype=torch.int32) for n in numels]
    for c, i in enumerate(leaf):
        assert begin[i] <= c < begin[i + 1]
        start = (c - begin[i]) * chunk
        length = min(chunk, numels[i] - start)
        assert 0 < length <= chunk
        seen[i][start:start + length] += 1
    for i, s in enumerate(seen):
        assert bool((s == 1).all()), i
        assert begin[i + 1] - begin[i] == math.ceil(numels[i] / chunk)


def test_tables_align_with_the_optimizer(tiny_opt):
    """The tables follow the optimizer's leaves: one numel and backbone flag
    a name, in its order, every chunk inside its leaf, the elements
    counted; the chain on the CPU builds none."""
    opt = tiny_opt
    assert opt.fused is None and opt.fused_elements == 0
    t = adamw.AdamWTables(opt.params, opt.mu, opt.nu, opt.backbone)
    assert t.numel.tolist() == [p.numel() for p in opt.params]
    assert t.backbone.tolist() == [int(optim.is_backbone_name(n)) for n in opt.names]
    assert 0 < sum(t.backbone.tolist()) < len(opt.names)
    assert t.elements == sum(p.numel() for p in opt.params)
    assert t.chunk_leaf_t.tolist() == t.chunk_leaf and t.chunk_begin_t.tolist() == t.chunk_begin
    n = len(opt.params)
    ptrs = t.pointers.tolist()
    assert ptrs == [x.data_ptr() for x in (*opt.params, *opt.mu, *opt.nu)] and len(ptrs) == 3 * n


def test_none_gradients_have_null_pointers(tiny_opt):
    opt = tiny_opt
    t = adamw.AdamWTables(opt.params, opt.mu, opt.nu, opt.backbone)
    grads = [None if i % 3 == 0 else torch.zeros_like(p) for i, p in enumerate(opt.params)]
    ptrs = t.grad_pointers(grads)
    assert ptrs == [0 if g is None else g.data_ptr() for g in grads]
    assert ptrs.count(0) == len(grads[::3])


def _leaves():
    return [torch.zeros(n) for n in (6, 4, 10)]


@pytest.mark.parametrize("which,bad,error", [
    ("param", lambda: torch.zeros(4, 2).t(), ValueError),
    ("param", lambda: torch.zeros(4, dtype=torch.bfloat16), TypeError),
    ("mu", lambda: torch.zeros(8)[::2], ValueError),
    ("nu", lambda: torch.zeros(4, dtype=torch.float64), TypeError),
    ("nu", lambda: torch.zeros(4, device="meta"), ValueError),
    ("nu", lambda: torch.zeros(5), ValueError),
])
def test_tables_refuse_a_leaf_the_kernels_do_not_take(which, bad, error):
    """A non-contiguous, non-f32, wrongly sized or off-device leaf raises."""
    leaves = {k: _leaves() for k in ("param", "mu", "nu")}
    leaves[which][1] = bad()
    leaves["param"][1] = leaves["param"][1] if which == "param" else torch.zeros(4)
    with pytest.raises(error):
        adamw.AdamWTables(leaves["param"], leaves["mu"], leaves["nu"], [True, False, False])


@pytest.mark.parametrize("bad,error", [
    (lambda: torch.zeros(2, 2).t(), ValueError),
    (lambda: torch.zeros(4, dtype=torch.bfloat16), TypeError),
    (lambda: torch.zeros(5), ValueError),
    (lambda: torch.zeros(4, device="meta"), ValueError),
])
def test_gradient_table_refuses_a_gradient_the_kernels_do_not_take(bad, error):
    params = _leaves()
    t = adamw.AdamWTables(params, _leaves(), _leaves(), [False] * 3)
    with pytest.raises(error):
        t.grad_pointers([torch.zeros(6), bad(), None])
    with pytest.raises(ValueError):
        t.grad_pointers([torch.zeros(6), None])


def test_gradient_table_refuses_a_parameter_moved_after_the_build():
    params = [torch.nn.Parameter(x) for x in _leaves()]
    t = adamw.AdamWTables(params, _leaves(), _leaves(), [False] * 3)
    params[2].data = torch.zeros(10)
    with pytest.raises(RuntimeError):
        t.grad_pointers([None] * 3)


def _kernel_norms(t, grads):
    """foreach_sumsq_kernel's sums over the chunk table: a partial a chunk,
    folded per leaf."""
    partial = []
    for c, i in enumerate(t.chunk_leaf):
        start = (c - t.chunk_begin[i]) * t.chunk
        g = grads[i]
        partial.append(torch.zeros(()) if g is None else
                       g.reshape(-1)[start:start + t.chunk].square().sum())
    return torch.stack([torch.stack(partial[t.chunk_begin[i]:t.chunk_begin[i + 1]]).sum()
                        for i in range(t.n_leaves)]).sqrt()


def _kernel_update(t, grads, norm, opt, lr):
    """foreach_adamw_kernel's element step over the chunk table, in its
    order, on the tables' leaves in place."""
    coef = 1.0 if norm < opt.clip_norm else opt.clip_norm / norm
    h = dict(b1=opt.b1, b2=opt.b2, a1=1.0 - opt.b1, a2=1.0 - opt.b2,
             bc1=1.0 - opt.b1 ** opt.count, bc2=1.0 - opt.b2 ** opt.count)
    params, mu, nu = t.leaves
    for c, i in enumerate(t.chunk_leaf):
        s = slice((c - t.chunk_begin[i]) * t.chunk, (c - t.chunk_begin[i] + 1) * t.chunk)
        p, m, v = (x.data.reshape(-1)[s] for x in (params[i], mu[i], nu[i]))
        g = torch.zeros_like(p) if grads[i] is None else grads[i].reshape(-1)[s] * coef
        m.mul_(h["b1"]).add_(h["a1"] * g)
        v.mul_(h["b2"]).add_(h["a2"] * g * g)
        u = (m / h["bc1"]) / ((v / h["bc2"]).sqrt() + opt.eps)
        u = (u + opt.weight_decay * p) * (opt.backbone_lr_scale if t.backbone[i] else 1.0)
        p.add_(-lr * u)


@pytest.mark.parametrize("clip", [1.0, 1e-3, math.inf])
def test_kernel_arithmetic_over_the_chunk_table_follows_the_chain(clip):
    """Three updates of ragged leaves (a None gradient among them; backbone
    and other leaves; 17 chunks in the largest), the kernels' steps written
    out over the chunk table against the chain: the per-leaf and global
    norms within 1e-6 of the exact ones (the CPU's own f32 norm is ~1e-5
    off at 2^20 elements, so the update takes the chain's norm), the leaves
    within 1e-6 of their largest magnitude."""
    gen = torch.Generator().manual_seed(3)
    names = ["text_encoder.model.a", "fusion.b", "audio_encoder.model.c", "head.d"]
    init = [torch.randn(n, generator=gen) for n in RAGGED]

    def chain(leaves):
        return optim.AdamWChain(zip(names, [torch.nn.Parameter(x.clone()) for x in leaves]),
                                lambda count: 1e-2 / (1 + count), clip, weight_decay=0.1)

    want, got = chain(init), chain(init)
    t = adamw.AdamWTables(got.params, got.mu, got.nu, got.backbone)
    for step in range(3):
        grads = [None if i == 1 and step == 1 else torch.randn(n, generator=gen)
                 for i, n in enumerate(RAGGED)]
        exact = torch.stack([torch.zeros((), dtype=torch.float64) if g is None else
                             g.double().norm() for g in grads])
        norms = _kernel_norms(t, grads)
        torch.testing.assert_close(norms.double(), exact, rtol=1e-6, atol=0)
        torch.testing.assert_close(optim.global_norm(grads, got.params, norms=norms).double(),
                                   exact.norm(), rtol=1e-6, atol=0)
        want_norm = want.update([None if g is None else g.clone() for g in grads])
        lr = got.schedule(got.count)
        got.count += 1
        _kernel_update(t, grads, float(want_norm), got, lr)
    for a, b in zip((*got.params, *got.mu, *got.nu), (*want.params, *want.mu, *want.nu)):
        assert float((a - b).detach().abs().max()) <= 1e-6 * float(b.detach().abs().max())
