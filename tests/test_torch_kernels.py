"""The port's three Hopper kernels: their plain PyTorch versions against the
JAX package's kernels (interpret mode on CPU) and ``_xla_reference``s, in
f32 at atol=rtol=1e-5 (the same math; only the summation order differs);
the stateless dropout hash bit-equal to ``_hash_keep`` in its three index
schemes; and, with hash dropout at rate 0.1, each plain version's output
(1e-5) and input gradients (1e-4) against ``jax.vjp`` of the reference.

The CUDA kernels themselves run only on a GPU: tests/test_torch_gpu.py
compares them with the plain versions there.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_multimodal_tpu.models.deberta import log_bucket as jax_log_bucket
from simple_multimodal_tpu.ops.pallas import attention_block as jab
from simple_multimodal_tpu.ops.pallas import deberta_attention as jda
from simple_multimodal_tpu.ops.pallas import ffn_block as jfb
from simple_multimodal_tpu_torch.ops.hopper import attention_block as ab
from simple_multimodal_tpu_torch.ops.hopper import deberta_attention as da
from simple_multimodal_tpu_torch.ops.hopper import ffn_block as fb

TOL = dict(atol=1e-5, rtol=1e-5)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# ----------------------------------------------------------- attention_block

def _block_args(B, S, E, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, E)).astype(np.float32)
    wb = []
    for _ in range(4):
        wb += [(rng.standard_normal((E, E)) / np.sqrt(E)).astype(np.float32),
               (rng.standard_normal((E,)) * 0.1).astype(np.float32)]
    g = (1.0 + 0.1 * rng.standard_normal((E,))).astype(np.float32)
    b = (0.1 * rng.standard_normal((E,))).astype(np.float32)
    return x, wb, g, b


@pytest.mark.parametrize("with_ln,residual", [(False, False), (True, True),
                                              (False, True), (True, False)])
def test_attention_block_plain_matches_jax(with_ln, residual):
    B, S, E, H = 2, 13, 32, 2  # S not a multiple of 8
    x, wb, g, b = _block_args(B, S, E, seed=1)
    eps = 1e-12
    jln = (jnp.asarray(g), jnp.asarray(b), eps) if with_ln else None
    want_kernel = np.asarray(jab.attention_block(x, *wb, num_heads=H, interpret=True,
                                                 ln=jln, residual=residual))
    want_ref = np.asarray(jab._xla_reference(x, *wb, num_heads=H, ln=jln,
                                             residual=residual))
    tln = (*_t(g, b), eps) if with_ln else None
    got = ab.attention_block(*_t(x, *wb), num_heads=H, ln=tln, residual=residual).numpy()
    np.testing.assert_allclose(got, want_kernel, **TOL)
    np.testing.assert_allclose(got, want_ref, **TOL)


# ----------------------------------------------------------------- ffn_block

@pytest.mark.parametrize("ln_mode", ["none", "pre", "post"])
def test_ffn_block_plain_matches_jax(ln_mode):
    B, S, E, F = 2, 13, 32, 64
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, S, E)).astype(np.float32)
    w1 = (rng.standard_normal((E, F)) / np.sqrt(E)).astype(np.float32)
    b1 = (0.1 * rng.standard_normal((F,))).astype(np.float32)
    w2 = (rng.standard_normal((F, E)) / np.sqrt(F)).astype(np.float32)
    b2 = (0.1 * rng.standard_normal((E,))).astype(np.float32)
    g = (1.0 + 0.1 * rng.standard_normal((E,))).astype(np.float32)
    b = (0.1 * rng.standard_normal((E,))).astype(np.float32)
    post = ln_mode == "post"
    jln = None if ln_mode == "none" else (jnp.asarray(g), jnp.asarray(b), 1e-7)
    want_kernel = np.asarray(jfb.ffn_block(x, w1, b1, w2, b2, ln=jln, ln_post=post,
                                           residual=True, interpret=True))
    want_ref = np.asarray(jfb._xla_reference(x, w1, b1, w2, b2, ln=jln, ln_post=post,
                                             residual=True))
    tln = None if ln_mode == "none" else (*_t(g, b), 1e-7)
    got = fb.ffn_block(*_t(x, w1, b1, w2, b2), ln=tln, ln_post=post,
                       residual=True).numpy()
    np.testing.assert_allclose(got, want_kernel, **TOL)
    np.testing.assert_allclose(got, want_ref, **TOL)


# --------------------------------------------------------- deberta_attention

def _deberta_args(S, span, seed):
    B, H, D = 3, 2, 16
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, S, H, D)).astype(np.float32) for _ in range(3))
    pos_k = rng.standard_normal((2 * span, H * D)).astype(np.float32)
    pos_q = rng.standard_normal((2 * span, H * D)).astype(np.float32)
    mask = np.ones((B, S), np.int32)
    mask[1, S // 2:] = 0  # a padded row
    mask[2] = 0           # an all-masked row (missing text)
    return q, k, v, pos_k, pos_q, mask


def _xla_reference_unpadded(q, k, v, pos_k, pos_q, mask, span, max_pos):
    B, S, H, D = q.shape
    tc, tp = jda.build_rel_tables(jnp.asarray(pos_k).reshape(2 * span, H, D),
                                  jnp.asarray(pos_q).reshape(2 * span, H, D),
                                  S, S, span, max_pos)
    sw = lambda a: jnp.swapaxes(jnp.asarray(a), 1, 2)  # noqa: E731
    out = jda._xla_reference(sw(q), sw(k), sw(v), tc, tp, jnp.asarray(mask),
                             float(1.0 / np.sqrt(3.0 * D)))
    return np.asarray(jnp.swapaxes(out, 1, 2))


def test_deberta_attention_plain_matches_jax():
    S, span, max_pos = 20, 16, 64
    q, k, v, pos_k, pos_q, mask = _deberta_args(S, span, seed=3)
    got = da.deberta_attention(*_t(q, k, v, pos_k, pos_q, mask), span=span,
                               max_position=max_pos).numpy()
    # _xla_reference on unpadded inputs: every row, the all-masked one included
    np.testing.assert_allclose(got, _xla_reference_unpadded(
        q, k, v, pos_k, pos_q, mask, span, max_pos), **TOL)
    # the interpret-mode kernel zero-pads S to 128, which changes only the
    # all-masked row (it then also averages over the padding)
    want = np.asarray(jda.deberta_attention(q, k, v, pos_k, pos_q, mask, span=span,
                                            max_position=max_pos, interpret=True))
    np.testing.assert_allclose(got[:2], want[:2], **TOL)
    # all-masked row: uniform attention over the S real keys
    np.testing.assert_allclose(got[2], np.broadcast_to(v[2].mean(0), got[2].shape),
                               **TOL)


def test_deberta_attention_plain_matches_jax_kernel_unpadded():
    """At S=128 the TPU kernel pads nothing: all rows agree, the all-masked
    one included."""
    S, span, max_pos = 128, 16, 64
    q, k, v, pos_k, pos_q, mask = _deberta_args(S, span, seed=4)
    got = da.deberta_attention(*_t(q, k, v, pos_k, pos_q, mask), span=span,
                               max_position=max_pos).numpy()
    want = np.asarray(jda.deberta_attention(q, k, v, pos_k, pos_q, mask, span=span,
                                            max_position=max_pos, interpret=True))
    np.testing.assert_allclose(got, want, **TOL)


def test_log_bucket_matches_jax():
    rel = np.arange(-700, 701)
    for span, max_pos in ((16, 64), (256, 512)):
        np.testing.assert_array_equal(da.log_bucket(rel, span, max_pos),
                                      jax_log_bucket(rel, span, max_pos))


@pytest.mark.parametrize("S,span,max_pos", [(20, 16, 64), (512, 256, 512)])
def test_rel_index_maps_match_build_rel_tables(S, span, max_pos):
    """Gathering with the index maps gives build_rel_tables' tables:
    c2p row u is rel = (S-1) - u over q - k; p2c row u is rel = (S-1) - u
    over k - q (bucket negated)."""
    H, D = 1, 2
    table = np.arange(2 * span * H * D, dtype=np.float32).reshape(2 * span, H, D)
    tc, tp = jda.build_rel_tables(jnp.asarray(table), jnp.asarray(table), S, S,
                                  span, max_pos)
    tc, tp = np.asarray(tc)[0], np.asarray(tp)[0]  # [W, D]
    idx_c, idx_p = da.rel_index_maps(S, span, max_pos)
    assert idx_c.shape == idx_p.shape == (2 * S - 1,)
    u = np.arange(2 * S - 1)
    np.testing.assert_array_equal(table[idx_c[2 * S - 2 - u], 0], tc[u])
    np.testing.assert_array_equal(table[idx_p[u], 0], tp[u])
    # the bucket map is antisymmetric, so the two maps coincide
    np.testing.assert_array_equal(idx_c, idx_p)


# ------------------------------------------------------ wrappers and imports

def test_hopper_modules_import_without_nvcc_or_gpu():
    env = dict(os.environ, PATH="/usr/bin:/bin", CUDA_VISIBLE_DEVICES="",
               CUDA_HOME="/nonexistent", PYTHONPATH=REPO)
    code = ("import torch\n"
            "from simple_multimodal_tpu_torch.ops.hopper import _build, "
            "attention_block, ffn_block, deberta_attention\n"
            "x = torch.zeros(1, 3, 16)\n"
            "w, b = torch.eye(16), torch.zeros(16)\n"
            "attention_block.attention_block(x, w, b, w, b, w, b, w, b, num_heads=1)\n"
            "assert _build._lib is None\n"
            "assert attention_block.attention_block.launches == 0\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_wrappers_refuse_devices_without_a_kernel():
    x = torch.zeros(1, 3, 16, device="meta")
    w, b = torch.zeros(16, 16, device="meta"), torch.zeros(16, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        ab.attention_block(x, w, b, w, b, w, b, w, b, num_heads=1)
    with pytest.raises(RuntimeError, match="no kernel"):
        fb.ffn_block(x, w, b, w, b)
    q = torch.zeros(1, 3, 1, 16, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        da.deberta_attention(q, q, q, torch.zeros(32, 16, device="meta"),
                             torch.zeros(32, 16, device="meta"), None, span=16,
                             max_position=64)


# ------------------------------------------------- hash dropout and backward

from simple_multimodal_tpu_torch.ops.hopper import dropout as hd  # noqa: E402

SEED, RATE = 123456789, 0.1
GTOL = dict(atol=1e-4, rtol=1e-4)


def _jax_attention_keep(seed, B, H, S, rate):
    u32 = jnp.uint32
    shape = (B, H, S, S)
    it = [jax.lax.broadcasted_iota(u32, shape, d) for d in range(4)]
    return np.asarray(jda._hash_keep(u32(seed), it[0] * np.uint32(H) + it[1], it[2], it[3],
                                     rate))


@pytest.mark.parametrize("seed", [0, SEED, 2 ** 31 - 2])
@pytest.mark.parametrize("rate", [0.1, 0.5, 0.97])
def test_hash_attention_scheme_is_bit_equal_to_jax(seed, rate):
    B, H, S = 2, 3, 37
    got = hd.attention_keep(seed, B, H, S, S, rate).numpy()
    np.testing.assert_array_equal(got, _jax_attention_keep(seed, B, H, S, rate))


def test_hash_deberta_scheme_is_bit_equal_to_jax():
    """DeBERTa's ``_drop_ids`` (head = b·H + group offset + g) over a
    whole-head block is the attention scheme."""
    B, H, S = 3, 4, 29
    got = hd.attention_keep(SEED, B, H, S, S, RATE).numpy()
    for b in range(B):
        want = np.asarray(jda._hash_keep(*jda._drop_ids(np.array([SEED], np.int32), b, 0,
                                                        (H, S, S), H), RATE))
        np.testing.assert_array_equal(got[b], want)


@pytest.mark.parametrize("salt", [hd.SALT_MID, hd.SALT_OUT])
def test_hash_ffn_scheme_is_bit_equal_to_jax(salt):
    """(seed + salt, b, s, c), also through the kernels' flattened rows:
    row r of B·S is (b, s) = (r // S, r % S)."""
    B, S, C = 3, 13, 40
    ones = jnp.ones((B, S, C), jnp.float32)
    want = np.asarray(jfb._ref_drop(ones, jnp.array([SEED], jnp.int32), RATE, salt)) != 0
    np.testing.assert_array_equal(hd.ffn_keep(SEED, salt, B, S, C, RATE).numpy(), want)
    row = torch.arange(B * S)[:, None]
    flat = hd.hash_u32((SEED + salt) & hd.MASK32, row // S, row % S,
                       torch.arange(C)[None]) >= hd.threshold(RATE)
    np.testing.assert_array_equal(flat.numpy().reshape(B, S, C), want)
    for b in range(B):  # the Pallas kernel's own tile form
        tile = np.asarray(jfb._drop_keep(np.array([SEED], np.int32), b, 0, (S, C), RATE, salt))
        np.testing.assert_array_equal(tile, want[b])


def _vjp_check(jax_fn, jax_args, torch_fn, torch_args, ct):
    """Output at 1e-5 and every input gradient at 1e-4 (f32), port autograd
    against jax.vjp on the same cotangent."""
    want, vjp = jax.vjp(jax_fn, *[jnp.asarray(a) for a in jax_args])
    want_grads = vjp(jnp.asarray(ct))
    ts = [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_() for a in torch_args]
    got = torch_fn(*ts)
    got.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for i, (t, w) in enumerate(zip(ts, want_grads)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), **GTOL, err_msg=f"grad {i}")


@pytest.mark.parametrize("with_ln,residual", [(False, False), (True, True)])
def test_attention_block_plain_with_dropout_matches_jax(with_ln, residual):
    B, S, E, H = 2, 13, 32, 2
    x, wb, g, b = _block_args(B, S, E, seed=5)
    ct = np.random.default_rng(6).standard_normal((B, S, E)).astype(np.float32)
    seed = jnp.array([SEED], jnp.int32)
    n = 11 if with_ln else 9

    def jfn(*a):
        ln = (a[9], a[10], 1e-12) if with_ln else None
        return jab._xla_reference(*a[:9], num_heads=H, ln=ln, residual=residual,
                                  seed=seed, rate=RATE)

    def tfn(*a):
        ln = (a[9], a[10], 1e-12) if with_ln else None
        return ab.attention_block(*a[:9], num_heads=H, ln=ln, residual=residual,
                                  dropout_rate=RATE, dropout_seed=SEED)

    args = ([x] + wb + [g, b])[:n]
    _vjp_check(jfn, args, tfn, args, ct)


@pytest.mark.parametrize("ln_mode", ["none", "pre", "post"])
def test_ffn_block_plain_with_dropout_matches_jax(ln_mode):
    B, S, E, F = 2, 13, 32, 64
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, S, E)).astype(np.float32)
    w1 = (rng.standard_normal((E, F)) / np.sqrt(E)).astype(np.float32)
    b1 = (0.1 * rng.standard_normal((F,))).astype(np.float32)
    w2 = (rng.standard_normal((F, E)) / np.sqrt(F)).astype(np.float32)
    b2 = (0.1 * rng.standard_normal((E,))).astype(np.float32)
    g = (1.0 + 0.1 * rng.standard_normal((E,))).astype(np.float32)
    b = (0.1 * rng.standard_normal((E,))).astype(np.float32)
    ct = rng.standard_normal((B, S, E)).astype(np.float32)
    post, seed = ln_mode == "post", jnp.array([SEED], jnp.int32)
    args = [x, w1, b1, w2, b2] + ([] if ln_mode == "none" else [g, b])

    def jfn(*a):
        ln = (a[5], a[6], 1e-7) if len(a) > 5 else None
        return jfb._xla_reference(*a[:5], ln=ln, ln_post=post, residual=True, seed=seed,
                                  rate_mid=RATE, rate_out=RATE)

    def tfn(*a):
        ln = (a[5], a[6], 1e-7) if len(a) > 5 else None
        return fb.ffn_block(*a[:5], ln=ln, ln_post=post, residual=True, dropout_rate_mid=RATE,
                            dropout_rate_out=RATE, dropout_seed=SEED)

    _vjp_check(jfn, args, tfn, args, ct)


def test_deberta_attention_plain_with_dropout_matches_jax():
    S, span, max_pos = 20, 16, 64
    q, k, v, pos_k, pos_q, mask = _deberta_args(S, span, seed=8)
    mask[2, :5] = 1  # no all-masked row: its gradient is where the two paths pad differently
    B, _, H, D = q.shape
    ct = np.random.default_rng(9).standard_normal(q.shape).astype(np.float32)
    seed = jnp.array([SEED], jnp.int32)

    def jfn(q_, k_, v_, pk, pq):
        tc, tp = jda.build_rel_tables(pk.reshape(2 * span, H, D), pq.reshape(2 * span, H, D),
                                      S, S, span, max_pos)
        sw = lambda a: jnp.swapaxes(a, 1, 2)  # noqa: E731
        out = jda._xla_reference(sw(q_), sw(k_), sw(v_), tc, tp, jnp.asarray(mask),
                                 float(1.0 / np.sqrt(3.0 * D)), seed, RATE)
        return sw(out)

    tmask = torch.from_numpy(mask)

    def tfn(q_, k_, v_, pk, pq):
        return da.deberta_attention(q_, k_, v_, pk, pq, tmask, span=span, max_position=max_pos,
                                    dropout_rate=RATE, dropout_seed=SEED)

    _vjp_check(jfn, [q, k, v, pos_k, pos_q], tfn, [q, k, v, pos_k, pos_q], ct)


def test_fold_order_groups_offsets_by_table_row():
    S, span, max_pos = 512, 256, 512
    idx_c, _ = da.rel_index_maps(S, span, max_pos)
    order, offsets = da.fold_order(idx_c, 2 * span)
    assert offsets[0] == 0 and offsets[-1] == 2 * S - 1
    for t in range(2 * span):
        rows = order[offsets[t]:offsets[t + 1]]
        assert (idx_c[rows] == t).all() and (np.diff(rows) > 0).all()
