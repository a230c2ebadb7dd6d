"""The port's Hopper kernels: their plain PyTorch versions against the JAX
package's kernels (interpret mode on CPU) and ``_xla_reference``s, in
f32 at atol=rtol=1e-5 (the same math; only the summation order differs);
the stateless dropout hash bit-equal to ``_hash_keep`` in its three index
schemes; with hash dropout at rate 0.1, each plain version's output
(1e-5) and input gradients (1e-4) against ``jax.vjp`` of the reference;
``flash_attention`` and ``wav_frontend`` the same way (outputs 1e-5 in f32
and 2e-2 in bf16, gradients 1e-4 against ``jax.grad`` through the Pallas
custom VJPs); ``wav_frontend_bwd_plain``, the closed form the backward
kernels are held to, against autograd of the plain version (1e-5 of each
gradient's largest magnitude) and ``jax.vjp`` of the JAX ``wav_frontend``
(1e-4); the fold of pass 1's per-block partials against ``F.group_norm``.

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
from simple_multimodal_tpu.ops.pallas import flash_attention as jfa
from simple_multimodal_tpu.ops.pallas import wav_frontend as jwf
from simple_multimodal_tpu_torch.ops.hopper import attention_block as ab
from simple_multimodal_tpu_torch.ops.hopper import deberta_attention as da
from simple_multimodal_tpu_torch.ops.hopper import ffn_block as fb
from simple_multimodal_tpu_torch.ops.hopper import flash_attention as fa
from simple_multimodal_tpu_torch.ops.hopper import wav_frontend as wf
from _torch_layout import torch_conv, torch_layout

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
    got = ab.attention_block(*_t(x), *torch_layout(*wb), num_heads=H, ln=tln,
                             residual=residual).numpy()
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
    got = fb.ffn_block(*_t(x), *torch_layout(w1, b1, w2, b2), ln=tln, ln_post=post,
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
            "attention_block, ffn_block, deberta_attention, flash_attention, wav_frontend\n"
            "x = torch.zeros(1, 3, 16)\n"
            "w, b = torch.eye(16), torch.zeros(16)\n"
            "attention_block.attention_block(x, torch.cat([w, w, w]), torch.zeros(48), w, b,\n"
            "                                num_heads=1)\n"
            "q = torch.zeros(1, 3, 1, 16)\n"
            "flash_attention.flash_attention(q, q, q)\n"
            "wav_frontend.wav_frontend(torch.ones(1, 40), torch.ones(8, 1, 10), b[:8], b[:8], 5)\n"
            "assert _build._lib is None\n"
            "assert attention_block.attention_block.launches == 0\n"
            "assert flash_attention.flash_attention.launches == 0\n"
            "assert wav_frontend.wav_frontend.launches == 0\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_wrappers_refuse_devices_without_a_kernel():
    x = torch.zeros(1, 3, 16, device="meta")
    w, b = torch.zeros(16, 16, device="meta"), torch.zeros(16, device="meta")
    w_qkv, b_qkv = torch.zeros(48, 16, device="meta"), torch.zeros(48, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        ab.attention_block(x, w_qkv, b_qkv, w, b, num_heads=1)
    with pytest.raises(RuntimeError, match="no kernel"):
        fb.ffn_block(x, w, b, w, b)
    q = torch.zeros(1, 3, 1, 16, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        da.deberta_attention(q, q, q, torch.zeros(32, 16, device="meta"),
                             torch.zeros(32, 16, device="meta"), None, span=16,
                             max_position=64)
    with pytest.raises(RuntimeError, match="no kernel"):
        fa.flash_attention(q, q, q)
    with pytest.raises(RuntimeError, match="no kernel"):
        wf.wav_frontend(torch.zeros(1, 40, device="meta"), torch.zeros(8, 1, 10, device="meta"),
                        torch.zeros(8, device="meta"), torch.zeros(8, device="meta"), 5)


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


def _vjp_check(jax_fn, jax_args, torch_fn, ct, to_torch=lambda a: _t(*a)):
    """Output at 1e-5 and every input gradient at 1e-4 (f32), port autograd
    against jax.vjp on the same cotangent; ``to_torch`` turns the JAX
    arguments, and the same way their gradients, into the port's."""
    want, vjp = jax.vjp(jax_fn, *[jnp.asarray(a) for a in jax_args])
    want_grads = to_torch([np.array(w) for w in vjp(jnp.asarray(ct))])
    ts = [t.clone().requires_grad_() for t in to_torch(jax_args)]
    got = torch_fn(*ts)
    got.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for i, (t, w) in enumerate(zip(ts, want_grads)):
        np.testing.assert_allclose(t.grad.numpy(), w.numpy(), **GTOL, err_msg=f"grad {i}")


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
        ln = (a[5], a[6], 1e-12) if with_ln else None
        return ab.attention_block(*a[:5], num_heads=H, ln=ln, residual=residual,
                                  dropout_rate=RATE, dropout_seed=SEED)

    args = ([x] + wb + [g, b])[:n]
    _vjp_check(jfn, args, tfn, ct, lambda a: [*_t(a[0]), *torch_layout(*a[1:9]), *_t(*a[9:])])


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

    _vjp_check(jfn, args, tfn, ct, lambda a: [*_t(a[0]), *torch_layout(*a[1:5]), *_t(*a[5:])])


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

    _vjp_check(jfn, [q, k, v, pos_k, pos_q], tfn, ct)


def test_fold_order_groups_offsets_by_table_row():
    S, span, max_pos = 512, 256, 512
    idx_c, _ = da.rel_index_maps(S, span, max_pos)
    order, offsets = da.fold_order(idx_c, 2 * span)
    assert offsets[0] == 0 and offsets[-1] == 2 * S - 1
    for t in range(2 * span):
        rows = order[offsets[t]:offsets[t + 1]]
        assert (idx_c[rows] == t).all() and (np.diff(rows) > 0).all()


# ----------------------------------------------------------- flash_attention

def _flash_args(B, Sq, Sk, H, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, Sk, H, D)).astype(np.float32) for _ in range(2))
    return rng, q, k, v


def _flash_bias(kind, rng, B, Sq, Sk, H):
    """None; a [B, 1, 1, Sk] key mask (-1e30 on the tail of row 1); that mask
    plus a full [B, H, Sq, Sk] bias; or a [1, 1, Sq, Sk] bias."""
    if kind == "none":
        return None
    mask = np.zeros((B, 1, 1, Sk), np.float32)
    mask[1, ..., Sk // 2:] = -1e30
    if kind == "keymask":
        return mask
    if kind == "full":
        return (0.5 * rng.standard_normal((B, H, Sq, Sk))).astype(np.float32) + mask
    return (0.5 * rng.standard_normal((1, 1, Sq, Sk))).astype(np.float32)


# (B, Sq, Sk, H, D), Pallas blocks, bias: D = 96 with a length that is no
# multiple of the block; Sq != Sk; the two masking biases; a broadcast bias
FLASH_CASES = [((2, 70, 70, 2, 96), 32, "none"), ((2, 40, 72, 2, 32), 32, "none"),
               ((2, 64, 64, 2, 16), 32, "keymask"), ((2, 45, 70, 2, 32), 16, "full"),
               ((2, 48, 48, 2, 16), 16, "qk")]


@pytest.mark.parametrize("shape,block,bias_kind", FLASH_CASES)
def test_flash_attention_plain_matches_jax(shape, block, bias_kind):
    B, Sq, Sk, H, D = shape
    rng, q, k, v = _flash_args(*shape, seed=11)
    bias = _flash_bias(bias_kind, rng, B, Sq, Sk, H)
    want = np.asarray(jfa.flash_attention(q, k, v, bias=bias, block_q=block, block_k=block,
                                          interpret=True))
    got = fa.flash_attention(*_t(q, k, v), None if bias is None else torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_flash_attention_plain_matches_jax_in_bf16():
    """bf16 in both: 2e-2 covers the rounding of the probabilities and of
    the output (the TPU kernel rounds them before normalising, the plain
    version after)."""
    shape = (1, 64, 64, 2, 32)
    _, q, k, v = _flash_args(*shape, seed=12)
    want = jfa.flash_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                               block_q=32, block_k=32, interpret=True)
    got = fa.flash_attention(*(t.to(torch.bfloat16) for t in _t(q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("shape,block,bias_kind", FLASH_CASES)
def test_flash_attention_plain_gradients_match_jax(shape, block, bias_kind):
    """dq, dk, dv and dbias (reduced over the bias's broadcast axes) of a
    weighted-sum loss against jax.grad through the Pallas backward, 1e-4."""
    B, Sq, Sk, H, D = shape
    rng, q, k, v = _flash_args(*shape, seed=13)
    bias = _flash_bias(bias_kind, rng, B, Sq, Sk, H)
    w = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    args = [q, k, v] + ([] if bias is None else [bias])

    def loss(*a):
        out = jfa.flash_attention(*a[:3], bias=a[3] if len(a) > 3 else None, block_q=block,
                                  block_k=block, interpret=True)
        return jnp.sum(out * w)

    want = jax.grad(loss, argnums=tuple(range(len(args))))(*args)
    ts = [t.requires_grad_() for t in _t(*args)]
    (fa.flash_attention(*ts) * torch.from_numpy(w)).sum().backward()
    for i, (t, g) in enumerate(zip(ts, want)):
        assert t.grad.shape == t.shape
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **GTOL, err_msg=f"grad {i}")


def test_flash_attention_fully_masked_row_attends_uniformly():
    """A row whose every key carries a -1e30 bias: the output is the mean of
    its Sk values, as in the TPU kernel, and the gradients are those of that
    uniform softmax (dv = mean over keys of the summed cotangent). The TPU
    kernel's backward differs there: its saved logsumexp -1e30 + log(Sk)
    rounds to -1e30, so it recomputes the probabilities as 1, Sk times too
    large."""
    B, Sq, Sk, H, D = 2, 32, 32, 2, 16
    rng, q, k, v = _flash_args(B, Sq, Sk, H, D, seed=14)
    bias = np.zeros((B, 1, 1, Sk), np.float32)
    bias[1] = -1e30
    want = np.asarray(jfa.flash_attention(q, k, v, bias=bias, block_q=16, block_k=16,
                                          interpret=True))
    ts = [t.requires_grad_() for t in _t(q, k, v)]
    got = fa.flash_attention(*ts, torch.from_numpy(bias))
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    np.testing.assert_allclose(got.detach().numpy()[1],
                               np.broadcast_to(v[1].mean(0), (Sq, H, D)), **TOL)
    w = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(ts[2].grad.numpy()[1],
                               np.broadcast_to(w[1].sum(0) / Sk, (Sk, H, D)), **GTOL)
    assert all(bool(torch.isfinite(t.grad).all()) for t in ts)


# -------------------------------------------------------------- wav_frontend

def _wav_args(T, C=512, B=2, seed=15):
    rng = np.random.default_rng(seed)
    wav = (0.3 * rng.standard_normal((B, T))).astype(np.float32)
    kern = (0.1 * rng.standard_normal((10, 1, C))).astype(np.float32)
    g = (1 + 0.2 * rng.standard_normal(C)).astype(np.float32)
    b = (0.1 * rng.standard_normal(C)).astype(np.float32)
    return rng, wav, kern, g, b


def _wav_t(wav, kern, g, b):
    """``_wav_args``' JAX arguments (or their gradients) as the port's."""
    tw, tg, tb = _t(wav, g, b)
    return [tw, torch_conv(kern), tg, tb]


@pytest.mark.parametrize("T", [4003, 645])
def test_wav_frontend_plain_matches_xla_reference(T):
    _, wav, kern, g, b = _wav_args(T, C=64)
    want = np.asarray(jwf._xla_reference(wav, kern, g, b, 5, 1e-5, False, jnp.float32))
    got = wf.wav_frontend(*_wav_t(wav, kern, g, b), 5)
    assert got.shape == want.shape == (2, (T - 10) // 5 + 1, 64)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("T", [4003, 2560, 645])
def test_wav_frontend_plain_matches_jax_kernel_in_bf16(T):
    """Against the Pallas kernel (interpret mode) at C = 512 in bf16: 2e-2,
    bf16 rounding only, the JAX test's own tolerance."""
    _, wav, kern, g, b = _wav_args(T)
    want = jax.jit(lambda *a: jwf.wav_frontend(*a, stride=5, interpret=True))(
        jnp.asarray(wav), jnp.asarray(kern, jnp.bfloat16), jnp.asarray(g), jnp.asarray(b))
    tw, tk, tg, tb = _wav_t(wav, kern, g, b)
    got = wf.wav_frontend(tw, tk.to(torch.bfloat16), tg, tb, 5)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape == (2, (T - 10) // 5 + 1, 512)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=2e-2, rtol=0)


def test_wav_frontend_plain_gradients_match_jax():
    """All four gradients of a weighted-sum loss against jax.grad through
    wav_frontend's custom VJP (autodiff of its _xla_reference), f32, 1e-4."""
    T, C = 1285, 128
    rng, wav, kern, g, b = _wav_args(T, C=C)
    T1 = (T - 10) // 5 + 1
    w = rng.standard_normal((2, T1, C)).astype(np.float32)

    def loss(*a):
        return jnp.sum(jwf.wav_frontend(*a, stride=5, interpret=True) * w)

    want = _wav_t(*[np.array(gj) for gj in jax.grad(loss, argnums=(0, 1, 2, 3))(wav, kern, g, b)])
    ts = [t.requires_grad_() for t in _wav_t(wav, kern, g, b)]
    (wf.wav_frontend(*ts, 5) * torch.from_numpy(w)).sum().backward()
    for i, (t, gj) in enumerate(zip(ts, want)):
        np.testing.assert_allclose(t.grad.numpy(), gj.numpy(), **GTOL, err_msg=f"grad {i}")


def _wav_stats(wav, kern, stride=5):
    """Per-(b, c) mean and rstd of the conv, two-pass, as the plain version."""
    y = torch.nn.functional.conv1d(wav[:, None], kern, stride=stride)
    var, mean = torch.var_mean(y.float(), dim=-1, unbiased=False)
    return mean, torch.rsqrt(var + 1e-5)


@pytest.mark.parametrize("T,C", [(4003, 16), (645, 128), (1285, 128)])
def test_wav_frontend_bwd_plain_matches_autograd_of_plain(T, C):
    """The backward's closed form against autograd of wav_frontend_plain,
    all four gradients, f32, within 1e-5 of each gradient's largest
    magnitude (dkernel sums ~1600 products a tap: both sides lie ~5e-7 of it
    from an f64 autograd, in another summation order)."""
    rng, wav, kern, g, b = _wav_args(T, C=C)
    gy = torch.from_numpy(rng.standard_normal((2, (T - 10) // 5 + 1, C)).astype(np.float32))
    ts = [t.requires_grad_() for t in _wav_t(wav, kern, g, b)]
    want = torch.autograd.grad(wf.wav_frontend_plain(*ts, 5), ts, gy)
    mean, rstd = _wav_stats(*_wav_t(wav, kern, g, b)[:2])
    got = wf.wav_frontend_bwd_plain(gy, *_wav_t(wav, kern, g, b), mean, rstd, 5)
    for i, (a, w) in enumerate(zip(got, want)):
        assert a.dtype == w.dtype and a.shape == w.shape
        np.testing.assert_allclose(a.numpy(), w.numpy(), atol=1e-5 * float(w.abs().max()),
                                   rtol=0, err_msg=f"grad {i}")


@pytest.mark.parametrize("T", [4003, 1285])
def test_wav_frontend_bwd_plain_matches_jax_vjp(T):
    """The closed form against jax.vjp of the JAX wav_frontend in interpret
    mode (its custom VJP, wav_frontend.py:246), f32, 1e-4."""
    rng, wav, kern, g, b = _wav_args(T, C=128)
    gy = rng.standard_normal((2, (T - 10) // 5 + 1, 128)).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jwf.wav_frontend(*a, stride=5, interpret=True),
                     jnp.asarray(wav), jnp.asarray(kern), jnp.asarray(g), jnp.asarray(b))
    want = _wav_t(*[np.array(w) for w in vjp(jnp.asarray(gy))])
    mean, rstd = _wav_stats(*_wav_t(wav, kern, g, b)[:2])
    got = wf.wav_frontend_bwd_plain(torch.from_numpy(gy), *_wav_t(wav, kern, g, b), mean, rstd,
                                    5)
    for i, (a, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a.numpy(), w.numpy(), **GTOL, err_msg=f"grad {i}")


@pytest.mark.parametrize("T,nb", [(4003, 1), (4003, 3), (645, 2), (2560, 4)])
def test_wav_fold_stats_plain_matches_group_norm(T, nb):
    """Pass 1's partials (block x of a row summing tiles x, x + nb, ...)
    folded as wav_fold_stats_kernel folds them give F.group_norm's
    statistics, and scale and shift applied to y give its output."""
    _, wav, kern, g, b = _wav_args(T, C=16)
    tw, tk, tg, tb = _wav_t(wav, kern, g, b)
    y = torch.nn.functional.conv1d(tw[:, None], tk, stride=5)  # [B, C, T1]
    part = wf.stats_partials_plain(y.transpose(1, 2), nb)
    assert part.shape == (2, nb, 2, 16)
    coef = wf.fold_stats_plain(part, y.shape[-1], tg, tb)
    mean, rstd = _wav_stats(tw, tk)
    np.testing.assert_allclose(coef[0].numpy(), mean.numpy(), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(coef[1].numpy(), rstd.numpy(), rtol=1e-3)
    want = torch.nn.functional.group_norm(y, 16, tg, tb, 1e-5)
    got = y * coef[2][..., None] + coef[3][..., None]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("B,ntiles,sms,want", [(8, 250, 132, 33), (8, 500, 132, 33),
                                               (2, 32, 132, 32), (1, 1, 132, 1),
                                               (64, 250, 132, 5), (300, 10, 132, 1)])
def test_wav_row_blocks(B, ntiles, sms, want):
    """Blocks per batch row: about two an SM over the batch, at most a row's
    tiles, at least one."""
    assert wf.row_blocks(B, ntiles, sms) == want


def test_fused_feature_encoder_matches_the_unfused_one():
    """The fused front end's feature encoder (wav_frontend, then the other
    convs as channels-last 2-D convs) against the unfused conv1d stack on
    the same weights, f32, 1e-5; its frames come out as a contiguous NWC
    tensor."""
    import dataclasses

    from simple_multimodal_tpu_torch.models.wav2vec2 import FeatureEncoder, Wav2Vec2Config

    cfg = Wav2Vec2Config.tiny()
    torch.manual_seed(0)
    enc = FeatureEncoder(cfg)
    with torch.no_grad():
        for p in enc.parameters():
            p.add_(0.1 * torch.randn_like(p))
    wav = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 16000)).astype(np.float32))
    want = enc(wav, torch.float32)
    enc.cfg = dataclasses.replace(cfg, fused_frontend=True)
    got = enc(wav, torch.float32)
    assert got.shape == want.shape == (2, 49, 16) and got.is_contiguous()
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), **TOL)
