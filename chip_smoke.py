#!/usr/bin/env python3
"""Smoke run of the PyTorch port (simple_multimodal_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one NVIDIA H100 (sm_90a) and nvcc. Phases, each ending in
``torch.cuda.synchronize()``:

1. device and build: the card's name and power limit, the torch/CUDA
   versions, the kernels built from ``csrc/`` (seconds printed);
2. each Hopper kernel's forward against its plain PyTorch version at the
   main path's shapes (base preset, B=8; attention_block and ffn_block also
   at a width of 96, which keeps the WMMA GEMM and core; deberta_attention
   also at S = 130 and 522, off its 64-row tiles, with padded and all-masked
   rows, its body printed and asserted, no statistics stored), in bf16 (atol=rtol=3e-2: bf16
   rounding of q/k/v, probabilities, the FFN intermediate and the output)
   and in f32 (atol=rtol=1e-3: only the summation order differs), with
   CUDA-event medians of kernel and plain, interleaved plain, kernel,
   kernel, plain;
3. the same sites with hash dropout at rate 0.1 (fixed seed), forward
   and backward (and, first, the kept positions of both blocks' dropouts
   read off outputs built to show them, and of the masks that the backwards
   of attention_block, ffn_block and deberta_attention replay, read off
   gradients built the same way, equal to ``dropout.py``'s masks); the
   backwards of attention_block, ffn_block and deberta_attention in bf16
   also without dropout, each with the body its backward takes printed and
   asserted (the wgmma kernels in bf16 at head width 64 or, for ffn_block,
   E in multiples of 64 and F of 128; the older bodies otherwise), DeBERTa's
   forward body too, its training forward (which keeps the row statistics
   the backward takes) bit-equal to its eval forward, the first case's
   device profile showing one two-product kernel and one row LayerNorm
   backward and no GELU replay per FFN call and one DeBERTa forward kernel
   (no re-run) per DeBERTa call, and two runs
   bit-equal: the output and every input gradient of each kernel's
   autograd.Function against torch.autograd of the plain version on the
   same inputs and seed, in f32 (atol=rtol=1e-3) and bf16 (max error
   <= 5e-2 * max|want| per tensor; the key-bias gradient of
   attention_block, zero in exact arithmetic, against its sibling the
   query-bias gradient), with CUDA-event medians of kernel fwd+bwd and
   plain fwd+bwd;
4. serve: the base-preset hierarchical bf16 model built from a seeded
   generator, saved, loaded through MultimodalEmotionDemo, three requests
   through ``predict`` and one B=8 forward, which must launch
   attention_block 23 times, ffn_block 35 times, deberta_attention 12 times
   and no backward;
5. full width in context: one request in f32 on the card (kernels, TF32
   off) against the CPU (plain versions) with the same weights, at
   atol=rtol=1e-3;
6. train: ``make_train_step`` on the base hierarchical bf16 model at B=8
   with dropout and augmentation on, 5 steps on seeded batches (int16
   audio, yuv420 video, labels): finite losses and gradient norms, every
   parameter moved, and each step launching the three backward kernels
   23/35/12 times; ms/step on the host clock and peak device memory;
7. full width train step: one B=1 step's loss and gradients in f32 with
   dropout and augmentation off (eval mode), TF32 off, card (kernels)
   against CPU (plain versions): loss within 1e-4 relative, each gradient
   within 1e-3 of its largest magnitude above a noise floor of 1e-6 of the
   step's largest gradient;
8. long-clip serve: the same model with ``audio_max_length=320000`` (20 s,
   999 wav2vec2 frames) and the fused wav2vec2 front end on
   (``SMM_WAV_FRONTEND=1``): one request through ``predict`` and one B=8
   forward, which must launch attention_block 23, ffn_block 35,
   deberta_attention 12, flash_attention 1 (the temporal attention),
   wav_frontend 1 and no backward;
9. long clip in f32: one such request on the card (kernels, TF32 off)
   against the CPU (plain versions), atol=rtol=1e-3, as phase 5;
10. long-clip train: ``make_train_step`` on that model at B=8, 5 steps, with
    ``fusion_dropout=0.0``: the setting at which the temporal attention
    drops no probabilities, so that the train step reaches the
    flash_attention backward (with probability dropout in effect the
    attention module takes its plain path, as in the JAX package). Each step
    must launch flash_attention_bwd once beside the three other backwards
    23/35/12; finite losses, every parameter that feeds the loss moves.

Phase 1 also runs the exact self-test of the shared Hopper building blocks
(``csrc/hopper.cuh``: wgmma with both descriptor forms, TMA, the swizzle)
and prints ptxas' registers and spill bytes and the dynamic shared memory of
every wgmma kernel (the flash-attention kernels, the attention core's
dropout variants forward and backward, deberta_attention's forward and
backward pair, the GEMM's two tile shapes and the FFN backward's two-product
kernel) and the
row kernels of the FFN and LayerNorm backwards; a spill or a serialized-wgmma
warning there fails the run. It prints what encoding one TMA tensor map
costs on the host (the wgmma chains build theirs per call).

After phase 1, the GEMM phase holds the wgmma GEMM alone (``smm_gemm``,
``csrc/gemm_wgmma.cu``: the product under ffn_block and attention_block)
against a plain f32 PyTorch expression on the same bf16 inputs, for every
epilogue variant (bias; bias + GELU + dropout; bias + dropout + residual
with f32 out; the GELU derivative with its f32 pre-activation and dropout)
at M in {47280, 3992, 130}, N in {768, 2304, 3072}, K in {768, 3072}
(bf16 out: atol=rtol=3e-2; f32 out: 1e-3; dropped positions exactly zero
and equal to ``dropout.ffn_keep``), with the device time of one call inside
a run of back-to-back calls, the TFLOP/s that is, and ``F.linear`` in bf16
timed the same way beside it: a yardstick the port never calls.

After the GEMM phase, the FFN backward's two-product kernel alone
(``smm_ffn_bwd_mm``, ``csrc/ffn_block_bwd_wgmma.cu``), with and without
dropout, against a plain f32 expression at M in {47280, 3992,
130} (``ffn_bwd two-product`` lines: h and dh_pre at 3e-2, db1 the fold of
its partials, dropped positions, two runs bit-equal, device time and
TFLOP/s), and the LayerNorm backward alone (``smm_ln_bwd``) against autograd
of ``F.layer_norm`` at [47280,768], [4096,768] and [1001,768] (``ln_bwd``
lines: errors, device time, byte bound).

Phases 2 and 3 also hold flash_attention (forward, and forward+backward
with dbias, at [8,999,8,96], at Sq != Sk and at [8,1024,12,64] with a
[B,1,1,Sk] key mask and with a full [B,H,Sq,Sk] bias, and at ragged lengths
that straddle the wgmma kernels' 64- and 128-row tiles: 127, 129, 255 and
257 at head widths 96 and 64, one with a key mask; each line also gives the
achieved TFLOP/s, the first case's forward+backward also the device time
by kernel of the port's kernels and of the library call
(``torch.profiler``), and two backward runs on the same inputs must be
bit-equal in dq, dk, dv and dbias) and wav_frontend
(forward at [8,160000] and [8,320000], C=512; its gradients, which are the
plain version's, once) against their plain versions at the same tolerances,
and time ``F.scaled_dot_product_attention`` beside flash_attention as a
yardstick the port never calls.

``python3 chip_smoke.py --profile`` runs none of the checks: after the build
it prints, for the 10 s and the 20 s model, ``torch.profiler``'s device time
by kernel over two B=8 forwards and two B=8 train steps, with the device's
busy share of the wall time. ``python3 chip_smoke.py --timings [--tree DIR]``
prints only medians (the forward+backward of attention_block, ffn_block and
deberta_attention, deberta_attention's forward alone, the B=8 forward, the
B=8 train step), importing the package from DIR when given: the
way to time a parent commit and a change in turns on one card, one after the other.

Prints a JSON line with every kernel's launches, error, times and bound
(the larger of its operations over 989 TFLOP/s and its bytes over
3.35 TB/s, each input read once and each output written once, computed from
the timed case's tensors), the ``nvidia-smi`` name/power-limit line, and,
last, the ok line. Any failure prints a traceback and exits non-zero
without the ok line.
"""
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

B = 8
ATOL_BF16 = 3e-2
ATOL_F32 = 1e-3
GRAD_TOL_BF16 = 5e-2
DROP_RATE, DROP_SEED = 0.1, 20260516
TRAIN_STEPS = 5  # the first pays for first-use set-up and is left out of the median
LONG_SAMPLES = 320000  # 20 s at 16 kHz: 999 wav2vec2 frames
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12  # H100 SXM: dense bf16 tensor cores, HBM3
REPLACES = {
    "attention_block": "simple_multimodal_tpu/ops/pallas/attention_block.py:165",
    "ffn_block": "simple_multimodal_tpu/ops/pallas/ffn_block.py:136",
    "deberta_attention": "simple_multimodal_tpu/ops/pallas/deberta_attention.py:282",
    "attention_block_bwd": "simple_multimodal_tpu/ops/pallas/attention_block.py:385",
    "ffn_block_bwd": "simple_multimodal_tpu/ops/pallas/ffn_block.py:391",
    "deberta_attention_bwd": "simple_multimodal_tpu/ops/pallas/deberta_attention.py:446",
    "flash_attention": "simple_multimodal_tpu/ops/pallas/flash_attention.py:161",
    "flash_attention_bwd": "simple_multimodal_tpu/ops/pallas/flash_attention.py:290",
    "wav_frontend": "simple_multimodal_tpu/ops/pallas/wav_frontend.py:147 and :166",
}
SOURCES = {name: f"simple_multimodal_tpu_torch/csrc/{name}.cu" for name in REPLACES}
# the main path's flash_attention is bf16 at head width 96: the wgmma kernels
SOURCES["flash_attention"] = "simple_multimodal_tpu_torch/csrc/flash_attention_wgmma.cu"
# the main path's blocks are bf16 at width 768: the wgmma GEMM and core under the chains
SOURCES["attention_block"] = (
    "simple_multimodal_tpu_torch/csrc/attention_block.cu on "
    "simple_multimodal_tpu_torch/csrc/gemm_wgmma.cu and "
    "simple_multimodal_tpu_torch/csrc/attention_core_wgmma.cu")
SOURCES["ffn_block"] = ("simple_multimodal_tpu_torch/csrc/ffn_block.cu on "
                        "simple_multimodal_tpu_torch/csrc/gemm_wgmma.cu")
SOURCES["flash_attention_bwd"] = (
    "simple_multimodal_tpu_torch/csrc/flash_attention_bwd_dq_wgmma.cu and "
    "simple_multimodal_tpu_torch/csrc/flash_attention_bwd_dkv_wgmma.cu")
# bf16 at head width 64: the re-run on the wgmma forward core, dq and dk/dv on the wgmma pair
SOURCES["attention_block_bwd"] = (
    "simple_multimodal_tpu_torch/csrc/attention_block_bwd.cu on "
    "simple_multimodal_tpu_torch/csrc/gemm_wgmma.cu, "
    "simple_multimodal_tpu_torch/csrc/attention_core_wgmma.cu and "
    "simple_multimodal_tpu_torch/csrc/attention_core_bwd_wgmma.cu")
SOURCES["ffn_block_bwd"] = (
    "simple_multimodal_tpu_torch/csrc/ffn_block_bwd.cu on "
    "simple_multimodal_tpu_torch/csrc/ffn_block_bwd_wgmma.cu, "
    "simple_multimodal_tpu_torch/csrc/gemm_wgmma.cu and simple_multimodal_tpu_torch/csrc/gemm.cuh")
SOURCES["deberta_attention"] = ("simple_multimodal_tpu_torch/csrc/deberta_attention.cu on "
                                "simple_multimodal_tpu_torch/csrc/deberta_attention_fwd_wgmma.cu")
SOURCES["deberta_attention_bwd"] = (
    "simple_multimodal_tpu_torch/csrc/deberta_attention_bwd.cu on "
    "simple_multimodal_tpu_torch/csrc/deberta_attention_fwd_wgmma.cu, "
    "simple_multimodal_tpu_torch/csrc/deberta_attention_bwd_dq_wgmma.cu and "
    "simple_multimodal_tpu_torch/csrc/deberta_attention_bwd_dkv_wgmma.cu")
NO_LAUNCHES = dict.fromkeys(REPLACES, 0)
# one B=8 forward (serve) and one B=8 train step, at 10 s and at 20 s of audio
FORWARD_LAUNCHES = {"attention_block": 23, "ffn_block": 35, "deberta_attention": 12}
BACKWARD_LAUNCHES = {"attention_block_bwd": 23, "ffn_block_bwd": 35, "deberta_attention_bwd": 12}
EXPECTED_LAUNCHES = {**NO_LAUNCHES, **FORWARD_LAUNCHES}
TRAIN_LAUNCHES = {**EXPECTED_LAUNCHES, **BACKWARD_LAUNCHES}
LONG_FORWARD_LAUNCHES = dict(EXPECTED_LAUNCHES, flash_attention=1, wav_frontend=1)
LONG_TRAIN_LAUNCHES = dict(LONG_FORWARD_LAUNCHES, **BACKWARD_LAUNCHES, flash_attention_bwd=1)


def log(*a):
    print(*a, flush=True)


def sync():
    import torch

    torch.cuda.synchronize()


def set_tf32(on: bool):
    import torch

    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps: int) -> list:
    """Per-call device times (ms) of ``reps`` back-to-back calls, from CUDA
    events around each call, after one warm-up call."""
    import torch

    fn()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return out


def _back_to_back_ms(fn, reps: int = 10) -> float:
    """Device time of one call inside a run of ``reps`` back-to-back calls."""
    import torch

    fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def median(xs):
    xs = sorted(xs)
    n = len(xs)
    return xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])


def work(name, inputs):
    """(forward FLOP, forward+backward FLOP) of one call of kernel ``name``
    on these inputs: the products the function needs, each counted once (a
    backward costs two products per forward product, the softmax core five
    for the forward's two)."""
    x = inputs[0]
    if name == "attention_block":
        rows, S, E = x.shape
        proj, core = 8 * rows * S * E * E, 4 * rows * S * S * E
        return proj + core, 3 * proj + 3.5 * core
    if name == "ffn_block":
        rows, S, E = x.shape
        f = 4 * rows * S * E * inputs[1].shape[1]
        return f, 3 * f
    if name == "deberta_attention":  # q·kᵀ, p·v, and q, k against the 2·span table rows
        n, S, H, D = x.shape
        core, rel = 4 * n * H * S * S * D, 4 * n * H * S * inputs[3].shape[0] * D
        return core + rel, 3.5 * core + 3 * rel
    if name == "flash_attention":
        n, Sq, H, D = x.shape
        core = 4 * n * H * Sq * inputs[1].shape[1] * D
        return core, 3.5 * core
    if name == "wav_frontend":  # the K-tap conv once; the norm and GELU are O(outputs)
        K, _, C = inputs[1].shape
        f = 2 * K * x.shape[0] * ((x.shape[1] - K) // 5 + 1) * C
        return f, 3 * f
    raise KeyError(name)


def bound(name, inputs, out, backward=False) -> dict:
    """The least time the card could take for one call (forward, or forward
    and backward): the larger of operations / 989 TFLOP/s and bytes /
    3.35 TB/s, every input read once and every output written once (the
    backward reads a cotangent like the output and writes a gradient like
    each input)."""
    flops = work(name, inputs)[1 if backward else 0]
    nbytes = sum(t.numel() * t.element_size() for t in list(inputs) + [out])
    nbytes *= 2 if backward else 1
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def sdpa(q, k, v, bias=None):
    """One library call for flash_attention's function, on [B, S, H, D]
    tensors: the yardstick beside the kernel, used nowhere in the port."""
    import torch.nn.functional as F

    out = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                         v.transpose(1, 2), attn_mask=bias)
    return out.transpose(1, 2)


# ------------------------------------------------------------ phase 2 cases

def _kernel_cases(dev, gen):
    """(kernel name, case label, kernel fn, plain fn, inputs) at the main
    path's shapes. Inputs are f32; each case runs in bf16 and in f32."""
    import torch

    from simple_multimodal_tpu_torch.ops.hopper import (
        attention_block as ab, deberta_attention as da, ffn_block as fb, flash_attention as fa,
        wav_frontend as wf)

    def rn(*shape, std=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * std

    E, H, Fd = 768, 12, 3072
    cases = []

    def attn_inputs(rows, S):
        ws = []
        for _ in range(4):
            ws += [rn(E, E, std=E ** -0.5), rn(E, std=0.1)]
        return [rn(rows, S, E)] + ws, [1.0 + rn(E, std=0.1), rn(E, std=0.1)]

    x, lnp = attn_inputs(B * 30, 197)
    cases.append(("attention_block", "ViT [240,197,768] LN+residual",
                  lambda t, g, b: dict(ln=(g, b, 1e-12), residual=True),
                  x, lnp))
    for frames in (499, 999):  # 10 s and 20 s of audio
        x, lnp = attn_inputs(B, frames)
        cases.append(("attention_block", f"wav2vec2 [8,{frames},768]",
                      lambda t, g, b: dict(ln=None, residual=False), x, lnp))

    def ffn_inputs(rows, S):
        return ([rn(rows, S, E), rn(E, Fd, std=E ** -0.5), rn(Fd, std=0.1),
                 rn(Fd, E, std=Fd ** -0.5), rn(E, std=0.1)],
                [1.0 + rn(E, std=0.1), rn(E, std=0.1)])

    # a width that is no multiple of 64: the WMMA GEMM and (head width 32) core
    x96 = [rn(2 * B, 197, 96)]
    for _ in range(4):
        x96 += [rn(96, 96, std=96 ** -0.5), rn(96, std=0.1)]
    ln96 = [1.0 + rn(96, std=0.1), rn(96, std=0.1)]
    cases.append(("attention_block", "WMMA path [16,197,96] 3 heads LN+residual",
                  lambda t, g, b: dict(ln=(g, b, 1e-12), residual=True, num_heads=3),
                  x96, ln96))

    x, lnp = ffn_inputs(B * 30, 197)
    cases.append(("ffn_block", "ViT [240,197,768] pre-LN",
                  lambda t, g, b: dict(ln=(g, b, 1e-12), ln_post=False), x, lnp))
    x, lnp = ffn_inputs(B, 512)
    cases.append(("ffn_block", "DeBERTa [8,512,768] post-LN",
                  lambda t, g, b: dict(ln=(g, b, 1e-7), ln_post=True), x, lnp))
    for frames in (499, 999):
        x, lnp = ffn_inputs(B, frames)
        cases.append(("ffn_block", f"wav2vec2 [8,{frames},768] post-LN",
                      lambda t, g, b: dict(ln=(g, b, 1e-5), ln_post=True), x, lnp))

    cases.append(("ffn_block", "WMMA path [16,197,96] F=160 pre-LN",
                  lambda t, g, b: dict(ln=(g, b, 1e-12), ln_post=False),
                  [rn(2 * B, 197, 96), rn(96, 160, std=96 ** -0.5), rn(160, std=0.1),
                   rn(160, 96, std=160 ** -0.5), rn(96, std=0.1)],
                  [1.0 + rn(96, std=0.1), rn(96, std=0.1)]))

    S, span = 512, 256
    mask = torch.ones(B, S, dtype=torch.int32, device=dev)
    mask[1, 300:] = 0  # a padded row
    mask[2] = 0        # an all-masked row (missing text)
    d_in = [rn(B, S, H, E // H), rn(B, S, H, E // H), rn(B, S, H, E // H),
            rn(2 * span, E), rn(2 * span, E)]
    cases.append(("deberta_attention",
                  "DeBERTa [8,512,12,64] span 256, padded + all-masked rows",
                  lambda t, g, b: dict(attention_mask=mask, span=span,
                                       max_position=512), d_in, []))
    for Sr in (130, 522):  # lengths off the 64-row tiles (522: a prompt of Queue 1)
        mask_r = torch.ones(B, Sr, dtype=torch.int32, device=dev)
        mask_r[1, Sr // 2:] = 0
        mask_r[2] = 0
        cases.append(("deberta_attention",
                      f"DeBERTa [8,{Sr},12,64] span 256, padded + all-masked rows",
                      lambda t, g, b, m=mask_r: dict(attention_mask=m, span=span,
                                                     max_position=512),
                      [rn(B, Sr, H, E // H), rn(B, Sr, H, E // H), rn(B, Sr, H, E // H),
                       rn(2 * span, E), rn(2 * span, E)], []))

    def no_kw(t, g, b):
        return {}

    def qkv(Sq, Sk, heads, D):
        return [rn(B, Sq, heads, D), rn(B, Sk, heads, D), rn(B, Sk, heads, D)]

    cases.append(("flash_attention", "temporal MHA [8,999,8,96]", no_kw, qkv(999, 999, 8, 96), []))
    cases.append(("flash_attention", "cross q [8,700,12,64], k/v [8,999,12,64]", no_kw,
                  qkv(700, 999, H, 64), []))
    key_mask = torch.zeros(B, 1, 1, 1024, device=dev)
    key_mask[1, ..., 700:] = -1e30  # a padded row
    key_mask[2, ..., :100] = -1e30
    long_qkv = qkv(1024, 1024, H, 64)
    cases.append(("flash_attention", "[8,1024,12,64] + key mask [8,1,1,1024]", no_kw,
                  long_qkv + [key_mask], []))
    cases.append(("flash_attention", "[8,1024,12,64] + bias [8,12,1024,1024]", no_kw,
                  long_qkv + [rn(B, H, 1024, 1024, std=0.5) + key_mask], []))
    # ragged lengths on both sides of the wgmma kernels' 64- and 128-row tiles
    for Sq, Sk, heads, D, masked in ((127, 129, 8, 96, False), (257, 255, 8, 96, False),
                                     (129, 257, H, 64, True), (255, 127, H, 64, False)):
        ragged = qkv(Sq, Sk, heads, D)
        label = f"ragged q [8,{Sq},{heads},{D}], k/v {Sk}"
        if masked:
            pad = torch.zeros(B, 1, 1, Sk, device=dev)
            pad[1, ..., 200:] = -1e30
            pad[2, ..., :130] = -1e30  # across the first 128-key tile's edge
            ragged, label = ragged + [pad], label + " + key mask"
        cases.append(("flash_attention", label, no_kw, ragged, []))
    for samples in (160000, LONG_SAMPLES):
        cases.append(("wav_frontend", f"conv_0+GN+GELU [8,{samples}] C=512",
                      lambda t, g, b: dict(stride=5),
                      [rn(B, samples, std=0.3), rn(10, 1, 512, std=0.1),
                       1.0 + rn(512, std=0.2), rn(512, std=0.1)], []))
    fns = {
        "attention_block": (
            lambda *a, **k: ab.attention_block(*a, **{"num_heads": H, **k}),
            lambda *a, **k: ab.attention_block_plain(*a, **{"num_heads": H, **k})),
        "ffn_block": (fb.ffn_block, fb.ffn_block_plain),
        "deberta_attention": (da.deberta_attention, da.deberta_attention_plain),
        "flash_attention": (fa.flash_attention, fa.flash_attention_plain),
        "wav_frontend": (wf.wav_frontend, wf.wav_frontend_plain),
    }
    return cases, fns


# one PyTorch call that computes the same function, where there is one
LIBRARY = {"flash_attention": sdpa}


def _rate(name, args, ms, fn, backward=False) -> str:
    """For a flash_attention case: the achieved TFLOP/s at ``ms`` per call
    (the products the function needs, ``work``) and, for the forward, the
    device time of one call inside a run of 20 back-to-back calls, which
    leaves out the host's time between two launches."""
    if name != "flash_attention":
        return ""
    import torch

    flop = work(name, args)[1 if backward else 0]
    text = f" tflops={flop / ms / 1e9:.1f}"
    if not backward:
        with torch.no_grad():
            run_ms = _back_to_back_ms(fn, 20)
        text += f" back_to_back_ms={run_ms:.4f} ({flop / run_ms / 1e9:.1f} TFLOP/s)"
    return text


def _forward_route(args, dtype) -> str:
    """The body deberta_attention's forward takes, as the library reports it,
    held against the Python rule and against what the case must take: the
    wgmma kernel in bf16 at head width 64, attention.cuh's otherwise."""
    import torch

    from simple_multimodal_tpu_torch.ops.hopper import _build
    from simple_multimodal_tpu_torch.ops.hopper.attention_block import attention_wgmma_route

    D = args[0].shape[-1]
    route = _build.library().smm_attention_wgmma_route(int(dtype == torch.bfloat16), D, 1)
    want = int(dtype == torch.bfloat16 and D == 64)
    if route != want or attention_wgmma_route(dtype, D, True) != want:
        raise AssertionError(f"deberta_attention forward at head width {D} in {dtype}: route "
                             f"{route}, expected {want}")
    return "wgmma" if route else "wmma/f32"


def phase_kernels(dev) -> dict:
    """Phase 2: every kernel against its plain version. Returns per-kernel
    {max_abs_err, ms, plain_ms, bound_ms, bound_by, library_ms} (times and
    bound from each kernel's first case, bf16)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(0)
    cases, fns = _kernel_cases(dev, gen)
    results = {}
    for name, label, kw_fn, inputs, lnp in cases:
        kern, plain = fns[name]
        for dtype, tol in ((torch.bfloat16, ATOL_BF16), (torch.float32, ATOL_F32)):
            args = [t.to(dtype) for t in inputs]
            ln_args = [t.to(dtype) for t in lnp] + [None] * (2 - len(lnp))
            kw = kw_fn(dtype, *ln_args)
            got = kern(*args, **kw)
            # the plain version in f32 on the same (rounded) inputs
            args32 = [t.float() for t in args]
            kw32 = kw_fn(torch.float32, *[None if t is None else t.float()
                                          for t in ln_args])
            want = plain(*args32, **kw32)
            sync()
            err = (got.float() - want).abs()
            max_err = float(err.max())
            ok = bool(torch.allclose(got.float(), want, atol=tol, rtol=tol))
            finite = bool(torch.isfinite(got).all())
            t_plain1 = time_ms(lambda: plain(*args, **kw), 5)
            t_k1 = time_ms(lambda: kern(*args, **kw), 5)
            t_k2 = time_ms(lambda: kern(*args, **kw), 5)
            t_plain2 = time_ms(lambda: plain(*args, **kw), 5)
            ms, plain_ms = median(t_k1 + t_k2), median(t_plain1 + t_plain2)
            sync()
            route = ""
            if name == "deberta_attention":  # eval: no statistics stored
                route = f" fwd_route={_forward_route(args, dtype)} stats=none"
            log(f"kernel {name:18s} {label:56s} {str(dtype)[6:]:8s} "
                f"max_abs_err={max_err:.3e} tol={tol:g} ok={ok} "
                f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}{route}"
                + _rate(name, args, ms, lambda: kern(*args, **kw)))
            if not (ok and finite):
                raise AssertionError(f"{name} {label} {dtype}: kernel disagrees "
                                     f"with its plain version (max abs err "
                                     f"{max_err:.3e}, tol {tol}, finite={finite})")
            r = results.setdefault(name, {"max_abs_err": 0.0})
            r["max_abs_err"] = max(r["max_abs_err"], max_err)
            if "ms" not in r:  # the first case of each kernel, bf16
                r.update(ms=ms, plain_ms=plain_ms, library_ms=None, **bound(name, args, got))
                if name in LIBRARY:
                    r["library_ms"] = median(time_ms(lambda: LIBRARY[name](*args, **kw), 10))
                log(f"       {name}: bound {r['bound_ms']:.4f} ms by {r['bound_by']}, "
                    f"library_ms={r['library_ms']}")
            del got, want, args, args32
            torch.cuda.empty_cache()
    log(f"kernel times above: CUDA-event medians on {smi_line()}")
    return results


def _base_config(tmp):
    from simple_multimodal_tpu_torch.config import ModelConfig

    cfg = ModelConfig(encoder_preset="base", data_path=os.path.join(tmp, "data"),
                      save_path=os.path.join(tmp, "checkpoints"),
                      log_path=os.path.join(tmp, "logs"))
    cfg.fusion_type = "hierarchical"
    return cfg


def _long_config(tmp):
    """The long-clip model: 20 s of audio; ``fusion_dropout=0.0`` so that the
    temporal attention drops no probabilities in training either."""
    cfg = _base_config(tmp)
    cfg.audio_max_length = LONG_SAMPLES
    cfg.fusion_dropout = 0.0
    return cfg


@contextlib.contextmanager
def fused_frontend():
    """Models built inside take wav2vec2's fused front end
    (``SMM_WAV_FRONTEND=1``, the package's switch; read at construction)."""
    before = os.environ.get("SMM_WAV_FRONTEND")
    os.environ["SMM_WAV_FRONTEND"] = "1"
    try:
        yield
    finally:
        if before is None:
            del os.environ["SMM_WAV_FRONTEND"]
        else:
            os.environ["SMM_WAV_FRONTEND"] = before


def _requests(rng, samples=160000):
    """Four requests with text, int16 audio and yuv420 / RGB video."""
    from simple_multimodal_tpu_torch.data.video_wire import pack_yuv420

    def wav():
        return (rng.standard_normal(samples) * 3000).astype("int16")

    def clip():
        return rng.integers(0, 256, (30, 224, 224, 3), dtype="uint8")

    return [
        ("I am so happy about my new job!", None, None),
        ("Work has been stressful this week.", wav(), None),
        ("My family visited today.", wav(), pack_yuv420(clip())),
        ("", wav(), clip()),
    ]


def _check_probs(probs, where):
    import torch

    p = probs.float()
    if not bool(torch.isfinite(p).all()):
        raise AssertionError(f"{where}: non-finite probabilities")
    err = float((p.sum(-1) - 1.0).abs().max())
    if err > 1e-2:  # bf16 rounding of 7 probabilities
        raise AssertionError(f"{where}: probabilities sum to 1 ± {err:.3e}")


def phase_serve_and_count(dev, tmp: str, long: bool = False):
    """Phase 4 (and, with ``long``, phase 8 on the 20 s model with the fused
    front end): serve requests through the demo, then one B=8 forward with
    the launch counters reset just before it. ``tmp`` holds the config's
    directories and the checkpoint."""
    import numpy as np
    import torch

    from simple_multimodal_tpu_torch.data.tokenizer import HashTokenizer
    from simple_multimodal_tpu_torch.data.video_wire import pack_yuv420
    from simple_multimodal_tpu_torch.models.multimodal_model import create_model
    from simple_multimodal_tpu_torch.ops import hopper
    from simple_multimodal_tpu_torch.serving.demo import MultimodalEmotionDemo, save_checkpoint

    cfg = _long_config(tmp) if long else _base_config(tmp)
    tag = "long-clip serve" if long else "serve"
    expected = LONG_FORWARD_LAUNCHES if long else EXPECTED_LAUNCHES
    samples = cfg.audio_max_length
    t0 = time.perf_counter()
    model = create_model(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    if dev.type == "cuda" and model.dtype != torch.bfloat16:
        raise AssertionError(f"base model on cuda should compute in bf16, got {model.dtype}")
    ckpt = os.path.join(tmp, "model_long.pt" if long else "model.pt")
    save_checkpoint(ckpt, model, cfg)
    del model
    demo = MultimodalEmotionDemo(checkpoint_path=ckpt, device=dev)
    sync()
    if demo.model.audio_encoder.model.cfg.fused_frontend != long:
        raise AssertionError(f"{tag}: the fused front end should be {'on' if long else 'off'}")
    log(f"{tag}: base hierarchical bf16 model ({samples} audio samples) built, saved and "
        f"loaded in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    requests = _requests(rng, samples)
    for i, (text, audio, video) in enumerate(requests[2:3] if long else requests):
        t0 = time.perf_counter()
        analysis = demo.predict(text, audio, video)
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        dist = analysis["emotion_distribution"]
        _check_probs(torch.tensor(list(dist.values()))[None], f"request {i}")
        given = "+".join(m for m, x in (("text", text), ("audio", audio), ("video", video))
                         if x is not None)
        log(f"{tag}: request {i} ({given}) -> {analysis['predicted_emotion']} "
            f"conf={analysis['confidence']:.3f} "
            f"valence={analysis['valence']:.3f} latency_ms={ms:.1f}")

    words = ["great", "sad", "angry", "afraid", "surprised", "disgusted", "fine", "ok"]
    texts = [f"request number {i}: feeling {words[i % len(words)]} today" for i in range(B)]
    enc = HashTokenizer(model_max_length=cfg.text_max_length)(texts)
    batch = (
        {k: torch.from_numpy(v).to(dev) for k, v in enc.items()},
        torch.from_numpy((rng.standard_normal((B, samples)) * 3000).astype("int16")).to(dev),
        torch.from_numpy(pack_yuv420(rng.integers(0, 256, (B, 30, 224, 224, 3),
                                                  dtype="uint8"))).to(dev),
    )
    with torch.inference_mode():
        demo.model(*batch)  # warm-up
        sync()
        hopper.reset_launch_counts()
        out = demo.model(*batch)
        sync()
        counts = hopper.launch_counts()
        _check_probs(out["emotion_probs"], "B=8 forward")
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            demo.model(*batch)
            sync()
            times.append(time.perf_counter() - t0)
    log(f"{tag} counts: one B={B} forward launched {counts} (expected {expected})")
    if counts != expected:
        raise AssertionError(f"{tag}: launch counts {counts} != {expected}")
    log(f"{tag}: B={B} forward median {median(times) * 1e3:.1f} ms = "
        f"{B / median(times):.2f} clips/s (host clock, inputs on the device; "
        f"{smi_line()})")
    if not long:
        _frontend_ab(demo, batch)
    return counts, demo


def _frontend_ab(demo, batch):
    """Information: the B=8 forward at 10 s with wav2vec2's fused front end
    off (the default) and on, interleaved off, on, on, off, five forwards
    each, on the same model and inputs."""
    import torch

    fe = demo.model.audio_encoder.model.feature_extractor
    off = fe.cfg
    times = {False: [], True: []}
    with torch.inference_mode():
        for fused in (False, True, True, False):
            fe.cfg = dataclasses.replace(off, fused_frontend=fused)
            demo.model(*batch)  # warm-up
            sync()
            for _ in range(5):
                t0 = time.perf_counter()
                demo.model(*batch)
                sync()
                times[fused].append((time.perf_counter() - t0) * 1e3)
    fe.cfg = off
    log(f"serve: B={B} forward at 10 s, fused front end off {median(times[False]):.2f} ms "
        f"(min {min(times[False]):.2f}, max {max(times[False]):.2f}), on "
        f"{median(times[True]):.2f} ms (min {min(times[True]):.2f}, max "
        f"{max(times[True]):.2f}); 10 forwards each, interleaved; {smi_line()}")


def phase_full_width_f32(demo, tag="f32 full width"):
    """Phase 5 (and phase 9 on the long-clip demo): one base-width request
    in f32 on the card (kernels, TF32 off) against the CPU (plain versions),
    same weights."""
    import numpy as np
    import torch

    from simple_multimodal_tpu_torch.models.multimodal_model import MultimodalEmotionModel

    cfg, rng = demo.config, np.random.default_rng(1)
    set_tf32(False)
    text, audio, video = _requests(rng, cfg.audio_max_length)[3]
    text = "Full width check, all three modalities."
    state = demo.model.state_dict()
    outs = {}
    for where in ("card", "cpu"):
        m = MultimodalEmotionModel(cfg, dtype=torch.float32)
        m.load_state_dict(state)
        dev = demo.device if where == "card" else torch.device("cpu")
        m = m.to(dev).eval()
        t_in, a_in, v_in = demo.prepare(text, audio, video)
        inputs = ({k: v.to(dev) for k, v in t_in.items()}, a_in.to(dev), v_in.to(dev))
        t0 = time.perf_counter()
        with torch.inference_mode():
            outs[where] = {k: v.float().cpu() for k, v in m(*inputs).items()
                           if isinstance(v, torch.Tensor)}
        sync()
        log(f"{tag}: {where} forward {time.perf_counter() - t0:.2f} s")
        del m
    keys = ("emotion_logits", "valence", "arousal", "text_features",
            "audio_features", "video_features")
    for k in keys:
        a, b = outs["card"][k], outs["cpu"][k]
        err = float((a - b).abs().max())
        log(f"{tag}: {k:16s} max_abs_err={err:.3e} (atol=rtol={ATOL_F32:g})")
        if not torch.allclose(a, b, atol=ATOL_F32, rtol=ATOL_F32):
            raise AssertionError(f"{tag}: {k} GPU kernels vs CPU plain "
                                 f"differ by {err:.3e}")
    with torch.inference_mode():
        bf = demo.forward(text, audio, video)["emotion_probs"].float().cpu()
    log(f"info: bf16 vs f32 emotion_probs max abs deviation "
        f"{float((bf - outs['card']['emotion_probs']).abs().max()):.3e}")
    sync()


# ------------------------------------------------------------ phase 3

def _grad_errors(got, want, dtype, names):
    """(ok, max abs error, worst relative error) of the output and every
    gradient, by the rule of the dtype (module docstring, phase 3)."""
    import torch

    ok, max_abs, worst = True, 0.0, 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        a = a.float()
        err = float((a - b).abs().max())
        if not bool(torch.isfinite(a).all()):
            return False, float("inf"), float("inf")
        max_abs = max(max_abs, err)
        if dtype == torch.float32:
            good = bool(torch.allclose(a, b, atol=ATOL_F32, rtol=ATOL_F32))
            rel = err / max(float(b.abs().max()), 1e-30)
        else:
            # the key bias (input 4 of attention_block) has a zero gradient
            # in exact arithmetic: scale by the query bias's (input 2)
            ref = want[3] if names[i] == "bk" else b
            rel = err / max(float(ref.abs().max()), 1e-30)
            good = rel <= GRAD_TOL_BF16
        worst = max(worst, rel)
        ok = ok and good
    return ok, max_abs, worst


def _arg_names(name, n):
    if name == "attention_block":
        base = ["x", "wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo", "ln_g", "ln_b"]
    elif name == "ffn_block":
        base = ["x", "w1", "b1", "w2", "b2", "ln_g", "ln_b"]
    elif name == "flash_attention":
        base = ["q", "k", "v", "bias"]
    else:
        base = ["q", "k", "v", "pos_k", "pos_q"]
    return ["out"] + base[:n]


def phase_backward(dev) -> dict:
    """Phase 3: every kernel's autograd.Function with hash dropout, forward
    and backward, against autograd of its plain version. Returns per-kernel
    {max_abs_err, ms, plain_ms} of the backward entries (fwd+bwd times from
    each kernel's first case, bf16)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(1)
    cases, fns = _kernel_cases(dev, gen)
    drop = {"attention_block": dict(dropout_rate=DROP_RATE, dropout_seed=DROP_SEED),
            "ffn_block": dict(dropout_rate_mid=DROP_RATE, dropout_rate_out=DROP_RATE,
                              dropout_seed=DROP_SEED),
            "deberta_attention": dict(dropout_rate=DROP_RATE, dropout_seed=DROP_SEED),
            "flash_attention": {}}  # the function has no dropout
    results = {}
    wav_checked = False
    _check_dropout_positions(dev)
    for name, label, kw_fn, inputs, lnp in cases:
        kern, plain = fns[name]
        n_in = len(inputs)
        if name == "wav_frontend":  # no backward kernel: the plain version's gradients, once
            if not wav_checked:
                _check_wav_gradients(kern, plain, inputs, gen, label)
                wav_checked = True
            continue

        if kw_fn(None, 1, 1).get("ln") is None:
            lnp = []  # the site has no LayerNorm: its params take no gradient
        names = _arg_names(name, n_in + len(lnp))
        redesigned = name in ("attention_block", "deberta_attention", "ffn_block")
        for dtype in (torch.bfloat16, torch.float32):
            # the two redesigned backwards in bf16: with the dropout and without
            rates = (DROP_RATE, 0.0) if redesigned and dtype == torch.bfloat16 else (
                DROP_RATE if drop[name] else 0.0,)
            for rate in rates:
                drop_kw = drop[name] if rate else {}

                def call(fn, args, n_in=n_in, kw_fn=kw_fn, drop_kw=drop_kw):
                    lnargs = list(args[n_in:]) + [None] * (2 - len(args[n_in:]))
                    return fn(*args[:n_in], **kw_fn(None, *lnargs), **drop_kw)

                args = [t.to(dtype).requires_grad_() for t in inputs + lnp]
                args32 = [t.detach().float().requires_grad_() for t in args]
                gy = torch.randn(inputs[0].shape, generator=gen, device=dev).to(dtype)
                out = call(kern, args)
                got = [out.detach()] + list(torch.autograd.grad(out, args, gy))
                out32 = call(plain, args32)
                want = [out32.detach()] + list(torch.autograd.grad(out32, args32, gy.float()))
                del out, out32
                sync()
                ok, max_err, worst = _grad_errors(got, want, dtype, names)
                extra = ""
                if redesigned:
                    # no output is summed with atomics: a second run gives the same bits
                    out = call(kern, args)
                    again = [out.detach()] + list(torch.autograd.grad(out, args, gy))
                    sync()
                    same = all(bool(torch.equal(a, b)) for a, b in zip(got, again))
                    route = _backward_route(name, args, kw_fn, dtype)
                    extra = f" bit_equal={same} bwd_route={'wgmma' if route else 'wmma/f32'}"
                    ok = ok and same
                    if name == "deberta_attention":
                        # the forward that kept its statistics gives the eval forward's bits
                        with torch.no_grad():
                            ev = call(kern, args)
                        sync()
                        kept = bool(torch.equal(ev, got[0]))
                        extra += f" fwd_route={_forward_route(args, dtype)} " \
                                 f"train_fwd_equals_eval={kept}"
                        ok = ok and kept
                        del ev
                    del out, again
                del got, want

                def fwd_bwd(fn, xs=args):
                    o = fn(xs)
                    torch.autograd.grad(o, xs, gy)

                t_p1 = time_ms(lambda: fwd_bwd(lambda xs: call(plain, xs)), 3)
                t_k1 = time_ms(lambda: fwd_bwd(lambda xs: call(kern, xs)), 3)
                t_k2 = time_ms(lambda: fwd_bwd(lambda xs: call(kern, xs)), 3)
                t_p2 = time_ms(lambda: fwd_bwd(lambda xs: call(plain, xs)), 3)
                ms, plain_ms = median(t_k1 + t_k2), median(t_p1 + t_p2)
                sync()
                log(f"fwd+bwd {name:18s} {label:56s} {str(dtype)[6:]:8s} rate={rate} "
                    f"max_abs_err={max_err:.3e} worst_rel={worst:.3e} ok={ok} "
                    f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}{extra}"
                    + _rate(name, args, ms, None, backward=True))
                if not ok:
                    raise AssertionError(f"{name} {label} {dtype} rate={rate}: the backward "
                                         f"disagrees with autograd of the plain version (max abs "
                                         f"err {max_err:.3e}, worst relative {worst:.3e}) or two "
                                         f"runs differ ({extra})")
                r = results.setdefault(name + "_bwd", {"max_abs_err": 0.0})
                r["max_abs_err"] = max(r["max_abs_err"], max_err)
                if "ms" not in r:
                    with torch.no_grad():
                        out_like = call(kern, args)
                    r.update(ms=ms, plain_ms=plain_ms, library_ms=None,
                             **bound(name, args, out_like, backward=True))
                    if name in LIBRARY:
                        r["library_ms"] = median(time_ms(
                            lambda: fwd_bwd(lambda xs: LIBRARY[name](*xs)), 6))
                    log(f"        {name}_bwd: fwd+bwd bound {r['bound_ms']:.4f} ms by "
                        f"{r['bound_by']}, library_ms={r['library_ms']}")
                    if name in LIBRARY:
                        for who, fn in (("kernel", lambda xs: call(kern, xs)),
                                        ("library", lambda xs: LIBRARY[name](*xs))):
                            _log_device_times(f"{name} {label} fwd+bwd, {who}",
                                              lambda fn=fn: fwd_bwd(fn))
                    elif redesigned:
                        calls = _log_device_times(f"{name} {label} fwd+bwd",
                                                  lambda: fwd_bwd(lambda xs: call(kern, xs)),
                                                  top=10)
                        _check_bodies(name, dtype, calls)
                    del out_like
                del args, args32
                torch.cuda.empty_cache()
    _check_flash_backward_is_deterministic(dev, gen)
    log(f"fwd+bwd times above: CUDA-event medians on {smi_line()}")
    return results


def _check_bodies(name, dtype, calls: dict):
    """From the device-time profile of one fwd+bwd (calls per kernel name):
    in bf16 the FFN backward launches the two-product kernel and the row
    LayerNorm backward (pre- and post-LN) and no GELU replay, and
    deberta_attention's training backward re-runs no forward (at most one
    ``deberta_fwd_wgmma_kernel`` a call: the forward's own). The profiler
    can miss the first launches of its window (0.8 calls a repetition where
    there is one), so a body is held present or absent, not counted."""
    import torch

    if dtype != torch.bfloat16:
        return

    def n(key):
        return sum(c for k, c in calls.items() if key in k)

    if name == "ffn_block":
        bad = not n("ffn_bwd_wgmma_kernel") or n("gelu_drop_kernel") or not n("ln_bwd_rows_kernel")
    elif name == "deberta_attention":
        bad = not 0 < n("deberta_fwd_wgmma_kernel") <= 1 or n("attention_wmma_kernel")
    else:
        return
    log(f"        {name}: kernels per fwd+bwd " + ", ".join(
        f"{k}={n(k):g}" for k in ("ffn_bwd_wgmma_kernel", "ln_bwd_rows_kernel", "gelu_drop_kernel",
                                  "deberta_fwd_wgmma_kernel", "attention_wmma_kernel")))
    if bad:
        raise AssertionError(f"{name} fwd+bwd in bf16 launched other bodies than expected: "
                             f"{calls}")


def _backward_route(name, args, kw_fn, dtype) -> int:
    """Which body the backward of this attention_block or deberta_attention
    case takes, as the library reports it (1: the wgmma kernels, 0:
    ``attention_bwd.cuh``), held against the Python statement of the same
    rule and against what the case must take: wgmma in bf16 at head widths
    64 (and 128 for attention_block), the old bodies in f32 and elsewhere."""
    import torch

    from simple_multimodal_tpu_torch.ops.hopper import _build
    from simple_multimodal_tpu_torch.ops.hopper.attention_block import attention_wgmma_route

    if name == "ffn_block":
        from simple_multimodal_tpu_torch.ops.hopper.ffn_block import ffn_bwd_route

        E, Fd = args[0].shape[-1], args[1].shape[1]
        route = _build.library().smm_ffn_bwd_route(int(dtype == torch.bfloat16), E, Fd)
        want = int(dtype == torch.bfloat16 and E % 64 == 0 and Fd % 128 == 0)
        if route != want or ffn_bwd_route(dtype, E, Fd) != want:
            raise AssertionError(f"ffn_block backward at [{E}, {Fd}] in {dtype}: route {route}, "
                                 f"expected {want}")
        return route
    if name == "attention_block":
        D, rel = args[0].shape[-1] // kw_fn(None, None, None).get("num_heads", 12), False
    else:
        D, rel = args[0].shape[-1], True
    route = _build.library().smm_attention_wgmma_route(int(dtype == torch.bfloat16), D, int(rel))
    want = int(dtype == torch.bfloat16 and (D == 64 or (D == 128 and not rel)))
    if route != want or attention_wgmma_route(dtype, D, rel) != want:
        raise AssertionError(f"{name} backward at head width {D} in {dtype}: route {route}, "
                             f"expected {want}")
    return route


def _check_dropout_positions(dev):
    """The kept positions of both blocks' dropouts, not only the values:
    each block is given weights that copy the dropped tensor to the output
    (identity out-projection and one-hot values for attention_block, so that
    out[b, q, h, d] = p[b, h, q, k0 + d]; a selecting W2 for ffn_block's
    intermediate; the output itself for its output dropout), so an output is
    zero exactly where the kernel dropped. Compared for equality with
    ``dropout.attention_keep`` / ``ffn_keep`` over every position, at S = 499
    and 197 (ragged in every tile size), in bf16 (wgmma) and f32. The
    backwards of attention_block and deberta_attention replay the mask: a
    cotangent that is one-hot over 64 queries makes a gradient (dx through
    identity projections; dv) show the dropped probabilities the same way."""
    import torch

    from simple_multimodal_tpu_torch.ops.hopper.attention_block import attention_block
    from simple_multimodal_tpu_torch.ops.hopper.deberta_attention import deberta_attention
    from simple_multimodal_tpu_torch.ops.hopper.dropout import (
        SALT_MID, SALT_OUT, attention_keep, ffn_keep)
    from simple_multimodal_tpu_torch.ops.hopper.ffn_block import ffn_block

    E, H, D, Fd = 768, 12, 64, 3072
    gen = torch.Generator(device=dev).manual_seed(5)

    def rn(*shape, std=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * std

    def same(tag, got_kept, want):
        # a dropped element must be exactly zero; a kept one is zero only if
        # its value happens to be (an f32 sum that cancels to 0.0: a few in
        # 10^7), so at most one in a million may be
        wrong = int((got_kept & ~want).sum())
        zero = int((~got_kept & want).sum())
        log(f"fwd+bwd dropout positions {tag}: {want.numel()} positions, "
            f"{int((~want).sum())} dropped, {wrong} kept where dropout.py drops, "
            f"{zero} kept ones that are zero")
        if wrong or zero > 1 + want.numel() // 10 ** 6:
            raise AssertionError(f"{tag}: the kernel's kept positions differ from dropout.py's "
                                 f"({wrong} wrongly kept, {zero} zero) of {want.numel()}")

    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype)[6:]
        for rows, S in ((B, 499), (4, 197)):
            keep = attention_keep(DROP_SEED, rows, H, S, S, DROP_RATE, device=dev)
            got = torch.zeros_like(keep)
            wv = torch.zeros(E, E, device=dev)
            wv[:D] = torch.eye(D, device=dev).repeat(1, H)  # x[:, :, :D] -> every head's values
            zeros = torch.zeros(E, device=dev)
            ws = [rn(E, E, std=E ** -0.5), rn(E, std=0.1), rn(E, E, std=E ** -0.5),
                  rn(E, std=0.1), wv, zeros, torch.eye(E, device=dev), zeros]
            for k0 in range(0, S, D):
                n = min(D, S - k0)
                x = rn(rows, S, E)
                x[:, :, :D] = 0.0
                x[:, k0:k0 + n, :D] = torch.eye(D, device=dev)[:n]  # key k0 + d -> column d
                out = attention_block(x.to(dtype), *[w.to(dtype) for w in ws], num_heads=H,
                                      dropout_rate=DROP_RATE, dropout_seed=DROP_SEED)
                sync()
                shown = out.reshape(rows, S, H, D).permute(0, 2, 1, 3) != 0  # [b, h, q, d]
                if bool(shown[..., n:].any()):
                    raise AssertionError("attention_block: weight on keys past the end")
                got[..., k0:k0 + n] = shown[..., :n]
            same(f"attention_block [{rows},{S},{E}] {name}", got, keep)
            # the backward replays the mask: zero q and k projections (uniform
            # p), identity value and out projections and a cotangent that is
            # one-hot over 64 queries give dx[b, k, h, d] = p~[b, h, q0 + d, k]
            got = torch.zeros_like(keep)
            none, eye = torch.zeros(E, E, device=dev), torch.eye(E, device=dev)
            ws = [none, rn(E, std=0.1), none, rn(E, std=0.1), eye, zeros, eye, zeros]
            x = rn(rows, S, E).to(dtype).requires_grad_()
            for q0 in range(0, S, D):
                n = min(D, S - q0)
                gy = torch.zeros(rows, S, H, D, device=dev)
                gy[:, q0:q0 + n] = torch.eye(D, device=dev)[:n, None, :]
                out = attention_block(x, *[w.to(dtype) for w in ws], num_heads=H,
                                      dropout_rate=DROP_RATE, dropout_seed=DROP_SEED)
                (dx,) = torch.autograd.grad(out, [x], gy.reshape(rows, S, E).to(dtype))
                sync()
                shown = dx.reshape(rows, S, H, D).permute(0, 2, 3, 1) != 0  # [b, h, d, k]
                if bool(shown[:, :, n:].any()):
                    raise AssertionError("attention_block backward: weight on queries past the end")
                got[:, :, q0:q0 + n] = shown[:, :, :n]
            same(f"attention_block backward [{rows},{S},{E}] {name}", got, keep)
        # deberta_attention's backward: dv[b, k, h, d] = p~[b, h, q0 + d, k] for the
        # same one-hot cotangent (small scores: no probability underflows)
        rows, S, span = 2, 512, 256
        keep = attention_keep(DROP_SEED, rows, H, S, S, DROP_RATE, device=dev)
        got = torch.zeros_like(keep)
        q, k = rn(rows, S, H, D, std=0.1).to(dtype), rn(rows, S, H, D, std=0.1).to(dtype)
        v = rn(rows, S, H, D).to(dtype).requires_grad_()
        pk, pq = rn(2 * span, E, std=0.1).to(dtype), rn(2 * span, E, std=0.1).to(dtype)
        for q0 in range(0, S, D):
            gy = torch.zeros(rows, S, H, D, device=dev)
            gy[:, q0:q0 + D] = torch.eye(D, device=dev)[:, None, :]
            out = deberta_attention(q, k, v, pk, pq, None, span=span, max_position=512,
                                    dropout_rate=DROP_RATE, dropout_seed=DROP_SEED)
            (dv,) = torch.autograd.grad(out, [v], gy.to(dtype))
            sync()
            got[:, :, q0:q0 + D] = dv.permute(0, 2, 3, 1) != 0  # [b, h, d, k]
        same(f"deberta_attention backward [{rows},{S},{H},{D}] {name}", got, keep)
        rows, S = B, 499
        x = rn(rows, S, E, std=0.3)  # small pre-activations: no GELU underflows to 0
        w1, b1, b2 = rn(E, Fd, std=E ** -0.5), rn(Fd, std=0.1), rn(E, std=0.1)
        got = torch.zeros(rows, S, Fd, dtype=torch.bool, device=dev)
        for c0 in range(0, Fd, E):  # out = the intermediate's columns c0 .. c0 + E
            w2 = torch.zeros(Fd, E, device=dev)
            w2[c0:c0 + E] = torch.eye(E, device=dev)
            out = ffn_block(x.to(dtype), w1.to(dtype), b1.to(dtype), w2.to(dtype),
                            torch.zeros(E, device=dev, dtype=dtype), residual=False,
                            dropout_rate_mid=DROP_RATE, dropout_seed=DROP_SEED)
            sync()
            got[..., c0:c0 + E] = out != 0
        same(f"ffn_block mid [{rows},{S},{Fd}] {name}", got,
             ffn_keep(DROP_SEED, SALT_MID, rows, S, Fd, DROP_RATE, device=dev))
        # the backward replays the mid mask: W1 = the identity on columns c0 .. c0 + E
        # and no LayerNorm or residual give dx = dh_pre[:, c0 .. c0 + E]
        got = torch.zeros(rows, S, Fd, dtype=torch.bool, device=dev)
        w2 = rn(Fd, E, std=Fd ** -0.5).to(dtype)
        gy = rn(rows, S, E).to(dtype)
        xg = x.to(dtype).requires_grad_()
        for c0 in range(0, Fd, E):
            w1e = torch.zeros(E, Fd, device=dev)
            w1e[:, c0:c0 + E] = torch.eye(E, device=dev)
            out = ffn_block(xg, w1e.to(dtype), b1.to(dtype), w2,
                            torch.zeros(E, device=dev, dtype=dtype), residual=False,
                            dropout_rate_mid=DROP_RATE, dropout_seed=DROP_SEED)
            (dx,) = torch.autograd.grad(out, [xg], gy)
            sync()
            got[..., c0:c0 + E] = dx != 0
        same(f"ffn_block backward mid [{rows},{S},{Fd}] {name}", got,
             ffn_keep(DROP_SEED, SALT_MID, rows, S, Fd, DROP_RATE, device=dev))
        out = ffn_block(x.to(dtype), w1.to(dtype), b1.to(dtype),
                        rn(Fd, E, std=Fd ** -0.5).to(dtype), b2.to(dtype), residual=False,
                        dropout_rate_out=DROP_RATE, dropout_seed=DROP_SEED)
        sync()
        same(f"ffn_block out [{rows},{S},{E}] {name}", out != 0,
             ffn_keep(DROP_SEED, SALT_OUT, rows, S, E, DROP_RATE, device=dev))
    torch.cuda.empty_cache()


def _log_device_times(tag: str, fn, reps: int = 5, top: int = 5):
    """Device time by kernel (``torch.profiler``, self time per call over
    ``reps`` calls after a warm-up): what each launch of a wrapper costs on
    the card, without the host's time between launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        sync()

    def self_us(e):
        us = getattr(e, "self_device_time_total", None)
        return e.self_cuda_time_total if us is None else us

    rows = sorted((e for e in prof.key_averages() if self_us(e) > 0), key=self_us, reverse=True)
    total = sum(self_us(e) for e in rows) / reps / 1e3
    log(f"device time {tag}: {total:.4f} ms per call in all")
    for e in rows[:top]:
        log(f"device time {tag}: {self_us(e) / reps / 1e3:9.4f} ms {e.count / reps:5.1f} calls  "
            f"{e.key[:110]}")
    return {e.key: e.count / reps for e in rows}


def _check_flash_backward_is_deterministic(dev, gen):
    """Every output tile of the flash_attention backward is summed by one
    block in a fixed order: two runs on the same inputs give the same bits
    in dq, dk, dv and dbias, in bf16 (wgmma kernels, ragged lengths, D = 96)
    and in f32 (FMA kernels)."""
    import torch

    from simple_multimodal_tpu_torch.ops.hopper.flash_attention import flash_attention

    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (torch.randn(B, n, 8, 96, generator=gen, device=dev).to(dtype).requires_grad_()
                   for n in (257, 383, 383))
        bias = torch.randn(B, 8, 257, 383, generator=gen, device=dev).requires_grad_()
        gy = torch.randn(B, 257, 8, 96, generator=gen, device=dev).to(dtype)
        runs = [torch.autograd.grad(flash_attention(q, k, v, bias), [q, k, v, bias], gy)
                for _ in range(2)]
        sync()
        same = [bool(torch.equal(a, b)) for a, b in zip(*runs)]
        log(f"fwd+bwd flash_attention two backward runs bit-equal (dq, dk, dv, dbias) "
            f"{str(dtype)[6:]}: {same}")
        if not all(same):
            raise AssertionError(f"flash_attention backward is not deterministic in {dtype}: "
                                 f"dq, dk, dv, dbias equal = {same}")


def _check_wav_gradients(kern, plain, inputs, gen, label):
    """wav_frontend's backward is autograd of its plain version on the saved
    inputs: all four gradients against that, f32, atol=rtol=1e-3."""
    import torch

    args = [t.clone().requires_grad_() for t in inputs]
    args2 = [t.clone().requires_grad_() for t in inputs]
    out = kern(*args, stride=5)
    gy = torch.randn(out.shape, generator=gen, device=out.device)
    got = torch.autograd.grad(out, args, gy)
    want = torch.autograd.grad(plain(*args2, stride=5), args2, gy)
    sync()
    for n, a, b in zip(("wav", "kernel", "gn_scale", "gn_bias"), got, want):
        err = float((a - b).abs().max())
        log(f"fwd+bwd wav_frontend       {label:56s} float32  d{n}: max_abs_err={err:.3e}")
        if not torch.allclose(a, b, atol=ATOL_F32, rtol=ATOL_F32):
            raise AssertionError(f"wav_frontend {label}: gradient of {n} off by {err:.3e}")
    del out, got, want, args, args2
    torch.cuda.empty_cache()


# ------------------------------------------------------------ phases 6, 7

def _train_batch(rng, cfg, dev):
    import numpy as np
    import torch

    from simple_multimodal_tpu_torch.data.tokenizer import HashTokenizer
    from simple_multimodal_tpu_torch.data.video_wire import pack_yuv420

    words = ["great", "sad", "angry", "afraid", "surprised", "disgusted", "fine", "ok"]
    texts = [f"clip {i}: feeling {words[int(rng.integers(0, 8))]} today" for i in range(B)]
    enc = HashTokenizer(model_max_length=cfg.text_max_length)(texts)
    return {
        "text": {k: torch.from_numpy(v).to(dev) for k, v in enc.items()},
        "audio": torch.from_numpy((rng.standard_normal((B, cfg.audio_max_length))
                                   * 3000).astype(np.int16)).to(dev),
        "video": torch.from_numpy(pack_yuv420(rng.integers(
            0, 256, (B, cfg.video_max_frames, 224, 224, 3), dtype=np.uint8))).to(dev),
        "emotion": torch.from_numpy(rng.integers(0, cfg.num_emotions, B)).to(dev),
    }


# heads that do not feed the training loss (the hierarchical sentiment
# heads, kept for checkpoint parity; the auxiliary heads, whose loss term is
# dead as in the reference): no gradient, and a decay step lr·wd·p (1e-9 of
# p) below the f32 resolution of p, so no step moves them, in JAX either
UNUSED = ("classifier.sentiment_classifier.", "classifier.positive_classifier.",
          "classifier.negative_classifier.", "valence_regressor.", "arousal_regressor.",
          "uncertainty_head.")


def phase_train(dev, tmp: str, long: bool = False) -> dict:
    """Phase 6: TRAIN_STEPS base-preset B=8 bf16 train steps with dropout
    and augmentation on. With ``long``, phase 10: the same on the 20 s model
    with the fused front end and ``fusion_dropout=0.0``, the setting at
    which the temporal attention (8 heads of width 96 over 999 frames) drops
    no probabilities and so goes through flash_attention and its backward
    kernels in training, as the JAX package's train step does. Returns the
    launch counts of one step."""
    import numpy as np
    import torch

    from simple_multimodal_tpu_torch.models.multimodal_model import create_model
    from simple_multimodal_tpu_torch.ops import hopper
    from simple_multimodal_tpu_torch.train.optim import make_optimizer
    from simple_multimodal_tpu_torch.train.state import TrainState
    from simple_multimodal_tpu_torch.train.steps import make_train_step

    cfg = _long_config(tmp) if long else _base_config(tmp)
    tag = "long-clip train" if long else "train"
    expected = LONG_TRAIN_LAUNCHES if long else TRAIN_LAUNCHES
    model = create_model(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    if model.dtype != torch.bfloat16:
        raise AssertionError(f"base model on cuda should compute in bf16, got {model.dtype}")
    opt = make_optimizer(cfg, model, total_steps=100)
    step = make_train_step(model, opt, cfg, augment=True, compute_contrastive_loss=True)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = TrainState.create(0)
    rng = np.random.default_rng(2)
    times, counts = [], None
    torch.cuda.reset_peak_memory_stats()
    for i in range(TRAIN_STEPS):
        batch = _train_batch(rng, cfg, dev)
        sync()
        hopper.reset_launch_counts()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        sync()
        times.append(time.perf_counter() - t0)
        c = hopper.launch_counts()
        vals = {k: float(v) for k, v in metrics.items()}
        log(f"{tag}: step {i} {times[-1] * 1e3:.1f} ms loss={vals['total_loss']:.4f} "
            f"emotion={vals['emotion_loss']:.4f} contrastive={vals['contrastive_loss']:.4f} "
            f"grad_norm={vals['grad_norm']:.4f} launches={c}")
        if not all(np.isfinite(v) for v in vals.values()):
            raise AssertionError(f"{tag} step {i}: non-finite metrics {vals}")
        if c != expected:
            raise AssertionError(f"{tag} step {i}: launch counts {c} != {expected}")
        counts = c
    peak = torch.cuda.max_memory_allocated()
    still = [n for n, p in model.named_parameters()
             if not n.startswith(UNUSED) and torch.equal(p.detach(), before[n])]
    if still:
        raise AssertionError(f"{tag}: {len(still)} parameters did not move, e.g. {still[:5]}")
    log(f"{tag}: B={B} base hierarchical bf16 ({cfg.audio_max_length} audio samples, "
        f"fusion_dropout={cfg.fusion_dropout}), dropout and augmentation on: median "
        f"{median(times[1:]) * 1e3:.1f} ms/step over the {TRAIN_STEPS - 1} steps after the first "
        f"(host clock, "
        f"batches on the device), peak device memory {peak / 2**30:.2f} GiB "
        f"(torch.cuda.max_memory_allocated); {smi_line()}")
    return counts


def phase_full_width_train_f32(demo):
    """Phase 7: one base-width B=1 step's loss and gradients in f32, eval
    mode (no dropout, no augmentation), TF32 off, card against CPU."""
    import numpy as np
    import torch

    from simple_multimodal_tpu_torch.models.multimodal_model import MultimodalEmotionModel
    from simple_multimodal_tpu_torch.train.losses import total_loss

    cfg, rng = demo.config, np.random.default_rng(3)
    set_tf32(False)
    _, audio, video = _requests(rng)[2]
    state = demo.model.state_dict()
    res = {}
    for where in ("card", "cpu"):
        m = MultimodalEmotionModel(cfg, dtype=torch.float32)
        m.load_state_dict(state)
        dev = demo.device if where == "card" else torch.device("cpu")
        m = m.to(dev).eval()
        t_in, a_in, v_in = demo.prepare("A full width train step check.", audio, video)
        t0 = time.perf_counter()
        out = m({k: v.to(dev) for k, v in t_in.items()}, a_in.to(dev), v_in.to(dev),
                compute_contrastive_loss=True)
        loss, _ = total_loss(out, torch.tensor([4], device=dev))
        loss.backward()
        sync()
        res[where] = (float(loss.detach()), {n: p.grad.detach().cpu()
                                             for n, p in m.named_parameters()
                                             if p.grad is not None})
        log(f"f32 train step: {where} forward+backward {time.perf_counter() - t0:.2f} s, "
            f"loss {res[where][0]:.6f}")
        del m, out, loss
    (l_card, g_card), (l_cpu, g_cpu) = res["card"], res["cpu"]
    if abs(l_card - l_cpu) > 1e-4 * abs(l_cpu):
        raise AssertionError(f"f32 train step: loss {l_card} on the card vs {l_cpu} on the CPU")
    if set(g_card) != set(g_cpu):
        raise AssertionError("f32 train step: different parameters got gradients")
    # each leaf within 1e-3 of its largest magnitude, above an f32 noise
    # floor of 1e-6 of the step's largest gradient: leaves whose gradient
    # cancels to ~0 in exact arithmetic (attention key biases; the GAT's
    # att_dst, whose softmax over sources cancels it unless the LeakyReLU
    # changes slope) are rounding noise in both
    floor = 1e-6 * max(float(g.abs().max()) for g in g_cpu.values())
    rows = []
    for n, want in g_cpu.items():
        err = float((g_card[n] - want).abs().max())
        scale = float(want.abs().max())
        rows.append(((err - floor) / max(scale, 1e-30), err, scale, n))
    rows.sort(reverse=True)
    for rel, err, scale, n in rows[:3]:
        log(f"f32 train step: {n} max_abs_err={err:.3e} max|grad|={scale:.3e}")
    worst, _, _, worst_name = rows[0]
    log(f"f32 train step: loss rel err {abs(l_card - l_cpu) / abs(l_cpu):.3e}; worst gradient "
        f"{max(worst, 0.0):.3e} of its max magnitude above the noise floor {floor:.3e} "
        f"({worst_name}), {len(g_cpu)} leaves")
    if worst > 1e-3:
        raise AssertionError(f"f32 train step: gradient {worst_name} off by {worst:.3e} "
                             "of its max magnitude")

def _report_profile(prof, tag: str, wall_ms: float, reps: int, top: int = 40):
    """Device time by kernel (self time of the device-side rows), per
    repetition, and the device's busy share of the wall time."""
    import torch

    def self_ms(e):
        us = getattr(e, "self_device_time_total", None)
        return (e.self_cuda_time_total if us is None else us) / 1e3

    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and self_ms(e) > 0]
    rows.sort(key=self_ms, reverse=True)
    busy = sum(self_ms(e) for e in rows) / reps
    log(f"profile {tag}: wall {wall_ms / reps:.1f} ms, device busy {busy:.1f} ms "
        f"({100 * busy / (wall_ms / reps):.1f}% of wall; idle "
        f"{100 - 100 * busy / (wall_ms / reps):.1f}%), per repetition over {reps}; {smi_line()}")
    for e in rows[:top]:
        log(f"profile {tag}: {self_ms(e) / reps:9.3f} ms {e.count / reps:7.1f} calls  {e.key[:100]}")


def phase_profile(dev, tmp: str):
    """``--profile``: where the device time goes in the B=8 forward and the
    B=8 train step, at 10 s of audio and at 20 s with the fused front end."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from simple_multimodal_tpu_torch.models.multimodal_model import create_model
    from simple_multimodal_tpu_torch.train.optim import make_optimizer
    from simple_multimodal_tpu_torch.train.state import TrainState
    from simple_multimodal_tpu_torch.train.steps import make_train_step

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    reps = 2
    for long in (False, True):
        tag = "20 s" if long else "10 s"
        with fused_frontend() if long else contextlib.nullcontext():
            cfg = _long_config(tmp) if long else _base_config(tmp)
            model = create_model(cfg, device=dev, generator=torch.Generator().manual_seed(0))
        batch = _train_batch(np.random.default_rng(4), cfg, dev)
        inputs = (batch["text"], batch["audio"], batch["video"])
        with torch.inference_mode():
            model(*inputs)  # warm-up
            sync()
            with profile(activities=acts) as prof:
                t0 = time.perf_counter()
                for _ in range(reps):
                    model(*inputs)
                sync()
                wall = (time.perf_counter() - t0) * 1e3
        _report_profile(prof, f"{tag} B={B} forward", wall, reps)
        step = make_train_step(model, make_optimizer(cfg, model, total_steps=100), cfg,
                               augment=True, compute_contrastive_loss=True)
        state, _ = step(TrainState.create(0), batch)  # warm-up
        sync()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                state, _ = step(state, batch)
            sync()
            wall = (time.perf_counter() - t0) * 1e3
        _report_profile(prof, f"{tag} B={B} train step", wall, reps)
        del model, step, state, prof
        torch.cuda.empty_cache()


def phase_timings(dev, tmp: str, steps: int = 8):
    """``--timings``: no checks, only the times a parent/change comparison
    needs, each a median: forward+backward of attention_block, ffn_block and
    deberta_attention at the main path's shapes and deberta_attention's
    forward alone (bf16, dropout 0.1, CUDA events, 10 calls), the B=8
    forward (host clock, 10 calls) and the B=8
    train step (``steps`` steps, the first left out). With ``--tree DIR``
    the package is imported from DIR (an unpacked other commit), so two
    trees can be timed in turns by the same script on one card."""
    import numpy as np
    import torch

    from simple_multimodal_tpu_torch.models.multimodal_model import create_model
    from simple_multimodal_tpu_torch.train.optim import make_optimizer
    from simple_multimodal_tpu_torch.train.state import TrainState
    from simple_multimodal_tpu_torch.train.steps import make_train_step

    gen = torch.Generator(device=dev).manual_seed(1)
    cases, fns = _kernel_cases(dev, gen)
    out = {}
    for name, label, kw_fn, inputs, lnp in cases:
        if (name not in ("attention_block", "deberta_attention", "ffn_block")
                or "WMMA path" in label or (name == "deberta_attention" and "512" not in label)):
            continue
        if kw_fn(None, 1, 1).get("ln") is None:
            lnp = []
        n_in = len(inputs)
        args = [t.to(torch.bfloat16).requires_grad_() for t in inputs + lnp]
        gy = torch.randn(inputs[0].shape, generator=gen, device=dev).to(torch.bfloat16)
        drop = (dict(dropout_rate_mid=DROP_RATE, dropout_rate_out=DROP_RATE)
                if name == "ffn_block" else dict(dropout_rate=DROP_RATE))

        def fwd(args=args, n_in=n_in, kw_fn=kw_fn, name=name, drop=drop):
            lnargs = list(args[n_in:]) + [None] * (2 - len(args[n_in:]))
            return fns[name][0](*args[:n_in], **kw_fn(None, *lnargs), **drop,
                                dropout_seed=DROP_SEED)

        def fwd_bwd(args=args, gy=gy, fwd=fwd):
            torch.autograd.grad(fwd(), args, gy)

        out[f"{name} {label.split(' span')[0]} fwd+bwd ms"] = median(time_ms(fwd_bwd, 10))
        if name == "deberta_attention":
            with torch.no_grad():
                out[f"{name} {label.split(' span')[0]} fwd ms"] = median(time_ms(fwd, 10))
        del args, gy
        torch.cuda.empty_cache()
    cfg = _base_config(tmp)
    model = create_model(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    batch = _train_batch(np.random.default_rng(4), cfg, dev)
    inputs = (batch["text"], batch["audio"], batch["video"])
    times = []
    with torch.inference_mode():
        model(*inputs)  # warm-up
        sync()
        for _ in range(10):
            t0 = time.perf_counter()
            model(*inputs)
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
    out["B=8 forward ms"] = median(times)
    step = make_train_step(model, make_optimizer(cfg, model, total_steps=100), cfg,
                           augment=True, compute_contrastive_loss=True)
    state, times = TrainState.create(0), []
    for _ in range(steps):
        sync()
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    out["B=8 train step ms"] = median(times[1:])
    out["train steps ms"] = [round(t, 1) for t in times]
    log("timings " + json.dumps({k: (round(v, 4) if isinstance(v, float) else v)
                                 for k, v in out.items()}) + f" on {smi_line()}")


def phase_device_and_build(report: bool = True):
    """Phase 1. ``report=False`` (another tree's package, ``--tree``) leaves
    out the list of wgmma kernels, which is this tree's."""
    import torch

    from simple_multimodal_tpu_torch.ops.hopper import _build

    log("nvidia-smi:", smi_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"capability {torch.cuda.get_device_capability(0)}")
    set_tf32(False)
    t0 = time.perf_counter()
    _build.library()
    log(f"kernels built/loaded in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {(_build.build_info.get('seconds') or 0.0):.1f} s)")
    for line in _build.build_info.get("log", "").splitlines():
        if "registers" in line or "error" in line or "spill" in line:
            log("  ptxas:", line.strip())
    if report:
        _report_wgmma_kernels(_build)
    from simple_multimodal_tpu_torch.ops.hopper.selftest import hopper_selftest

    log(f"hopper.cuh self-test (exact): {sorted(hopper_selftest(torch.device('cuda', 0)))} ok")
    sync()


# every wgmma kernel the build must show: name -> (instantiations, how to ask
# the library for its dynamic shared memory from the template's integer and flags)
WGMMA_KERNELS = {
    # <D, bias, dropout>: six of flash_attention, two of attention_block's core
    "flash_fwd_wgmma_kernel": (8, lambda lib, n, flags: lib.smm_flash_wgmma_smem(
        3 if flags.endswith("1") else 0, n)),
    # <D, bias, dropout>: six of flash_attention, two of attention_block's backward core
    "flash_bwd_dq_wgmma_kernel": (8, lambda lib, n, flags: lib.smm_flash_wgmma_smem(1, n)),
    "flash_bwd_dkv_wgmma_kernel": (8, lambda lib, n, flags: lib.smm_flash_wgmma_smem(2, n)),
    "gemm_wgmma_kernel": (2, lambda lib, n, flags: lib.smm_gemm_wgmma_smem(n)),
    # ffn_block's backward, the two products over one [M, F] tile (no template)
    "ffn_bwd_wgmma_kernel": (1, lambda lib, n, flags: lib.smm_ffn_bwd_wgmma_smem()),
    # <dropout>: deberta_attention's forward, the backward's pair
    "deberta_fwd_wgmma_kernel": (2, lambda lib, n, flags: lib.smm_deberta_bwd_wgmma_smem(2)),
    "deberta_bwd_dq_wgmma_kernel": (2, lambda lib, n, flags: lib.smm_deberta_bwd_wgmma_smem(0)),
    "deberta_bwd_dkv_wgmma_kernel": (2, lambda lib, n, flags: lib.smm_deberta_bwd_wgmma_smem(1)),
}


# the FFN and LayerNorm backwards' row kernels (csrc/gemm.cuh), checked for spills like the above
ROW_KERNELS = ("ln_bwd_rows_kernel", "drop_cast_sum_kernel", "fold_columns_kernel")


def _report_wgmma_kernels(_build):
    """ptxas' registers and spill bytes and the dynamic shared memory of every
    wgmma kernel (flash attention with the attention core's dropout variant,
    the GEMM), from the build's log. A spill, or ptxas serializing the wgmma
    pipeline, fails the run."""
    import re

    log_text = _build.build_info.get("log", "")
    if log_text == "cached":
        log("wgmma kernels: library loaded from the build cache, no compiler log")
        return
    lib = _build.library()
    lines = log_text.splitlines()
    found = dict.fromkeys(WGMMA_KERNELS, 0)
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '\S*?(" + "|".join(WGMMA_KERNELS)
                      + r")(?:I((?:L[bi]\d+E)+))?", line)
        if not m:
            continue
        # the template arguments, if any: a leading integer (head width, tile width), then flags
        kernel, targs = m.group(1), re.findall(r"L([bi])(\d+)E", m.group(2) or "")
        lead = bool(targs) and targs[0][0] == "i"
        n = int(targs[0][1]) if lead else 0
        flags = "".join(v for _, v in (targs[1:] if lead else targs))
        block = " ".join(x.strip() for x in lines[i + 1:i + 4])
        regs = re.search(r"Used (\d+) registers", block)
        spill = [int(x) for x in re.findall(r"(\d+) bytes spill", block)]
        smem = WGMMA_KERNELS[kernel][1](lib, n, flags)
        targ = f"<{n or ''}{', ' if n and flags else ''}{flags}>" if targs else ""
        log(f"wgmma kernel {kernel}{targ}: "
            f"{regs.group(1) if regs else '?'} registers, spill bytes {spill}, "
            f"dynamic shared memory {smem} bytes")
        found[kernel] += 1
        if not regs or len(spill) != 2 or any(spill):
            raise AssertionError(f"{kernel}<{n}, {flags}>: ptxas reports spills: {block}")
    expected = {k: v[0] for k, v in WGMMA_KERNELS.items()}
    if found != expected:
        raise AssertionError(f"wgmma kernels in the compiler log: {found}, expected {expected}")
    # the row kernels of the FFN and LayerNorm backwards (every instantiation)
    rows_found = 0
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '(\S*?(" + "|".join(ROW_KERNELS) + r")\S*)'",
                      line)
        if not m:
            continue
        block = " ".join(x.strip() for x in lines[i + 1:i + 4])
        regs = re.search(r"Used (\d+) registers", block)
        spill = [int(x) for x in re.findall(r"(\d+) bytes spill", block)]
        smem = re.search(r"(\d+) bytes smem", block)
        if "Li3E" in m.group(1) or (not rows_found and "fold" in m.group(2)):
            log(f"row kernel {m.group(2)} ({m.group(1)[-40:]}): {regs.group(1) if regs else '?'} "
                f"registers, spill bytes {spill}, static shared memory "
                f"{smem.group(1) if smem else '?'} bytes")
        rows_found += 1
        if not regs or len(spill) != 2 or any(spill):
            raise AssertionError(f"{m.group(1)}: ptxas reports spills: {block}")
    if rows_found < len(ROW_KERNELS):
        raise AssertionError(f"row kernels in the compiler log: {rows_found}")
    log(f"row kernels: {rows_found} instantiations of {', '.join(ROW_KERNELS)}, none spills")
    serialized = [x for x in lines if "serializ" in x.lower()]
    if serialized:
        raise AssertionError("ptxas serialized a wgmma pipeline: " + serialized[0])
    import torch

    x = torch.empty(47280 * 768, dtype=torch.bfloat16, device="cuda")
    lib.smm_tensor_map_ns(x.data_ptr(), 47280, 768, 1)  # the first call looks cuTensorMapEncodeTiled up
    ns = lib.smm_tensor_map_ns(x.data_ptr(), 47280, 768, 2000)
    if ns < 0:
        raise AssertionError("cuTensorMapEncodeTiled failed")
    log(f"host cost of one TMA tensor map: {ns} ns (cuTensorMapEncodeTiled, mean of 2000; a "
        f"wgmma GEMM launch encodes 4, the attention core 3: ffn_block 8 per call = "
        f"{8 * ns / 1e3:.2f} us, attention_block 11 = {11 * ns / 1e3:.2f} us)")


# ------------------------------------------------------------ the GEMM phase

GEMM_ROWS = (47280, 3992, 130)
GEMM_SHAPES = tuple((n, k) for n in (768, 2304, 3072) for k in (768, 3072))


def phase_gemm(dev):
    """The wgmma GEMM alone through ``smm_gemm``: every epilogue variant
    against a plain f32 expression, the kept positions against
    ``dropout.ffn_keep``, TFLOP/s, and ``F.linear`` beside it."""
    import torch
    import torch.nn.functional as F

    from simple_multimodal_tpu_torch.ops.hopper import gemm as G
    from simple_multimodal_tpu_torch.ops.hopper.dropout import ffn_keep

    gen = torch.Generator(device=dev).manual_seed(7)
    bf16, f32, S = torch.bfloat16, torch.float32, 197

    def rn(*shape, std=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * std

    for M in GEMM_ROWS:
        for N, K in GEMM_SHAPES:
            a, w = rn(M, K).to(bf16), rn(N, K, std=K ** -0.5).to(bf16)
            bias, res, aux = rn(N, std=0.1).to(bf16), rn(M, N).to(bf16), rn(M, N)
            route = G.gemm_route(M, N, K)
            if not route:
                raise AssertionError(f"gemm [{M},{N},{K}] should take the wgmma kernel")
            variants = {
                "bias": dict(bias=bias),
                "bias+gelu+drop": dict(bias=bias, act="gelu_tanh",
                                       dropout=(DROP_RATE, DROP_SEED, 1, S)),
                "bias+drop+res f32": dict(bias=bias, dropout=(DROP_RATE, DROP_SEED, 2, S),
                                          res=res, out_dtype=f32),
                "dgelu+drop aux": dict(act="dgelu_tanh", aux=aux,
                                       dropout=(DROP_RATE, DROP_SEED, 1, S)),
            }
            flop, text = 2.0 * M * N * K, ""
            for name, kw in variants.items():
                got = G.gemm(a, w, **kw)
                want = G.gemm_plain(a, w, **{**kw, "out_dtype": f32})
                sync()
                tol = ATOL_F32 if kw.get("out_dtype") == f32 else ATOL_BF16
                err = float((got.float() - want).abs().max())
                ok = bool(torch.allclose(got.float(), want, atol=tol, rtol=tol))
                if "dropout" in kw:
                    # a dropped element is exactly zero (its residual exactly
                    # itself); a kept one is not, unless its value is ~0
                    rate, seed, salt, _ = kw["dropout"]
                    keep = ffn_keep(seed, salt, -(-M // S), S, N, rate,
                                    device=dev).reshape(-1, N)[:M]
                    resf = res.float() if "res" in kw else 0.0
                    shown = got.float() - resf
                    bad = (~keep & (shown != 0)) | (keep & (shown == 0)
                                                    & ((want - resf).abs() > 1e-4))
                    ok = ok and not bool(bad.any())
                    del keep, shown, bad
                ms = _back_to_back_ms(lambda: G.gemm(a, w, **kw))
                text += f" | {name}: err={err:.2e} ms={ms:.4f} {flop / ms / 1e9:.0f} TFLOP/s"
                if not ok:
                    raise AssertionError(f"gemm [{M},{N},{K}] {name}: disagrees with the plain "
                                         f"version (max abs err {err:.3e}, tol {tol}) or drops "
                                         f"other positions than dropout.ffn_keep")
                del got, want
            lin = _back_to_back_ms(lambda: F.linear(a, w, bias))
            log(f"gemm [{M},{N},{K}] tile_n={route}{text} | F.linear (library yardstick, "
                f"bias only): ms={lin:.4f} {flop / lin / 1e9:.0f} TFLOP/s")
            del a, w, res, aux
            torch.cuda.empty_cache()
    log(f"gemm times above: device time per call in a run of 10 back-to-back calls, bf16, "
        f"on {smi_line()}")


def _ffn_bwd_mm(a, dy0, w1t, b1, w2t, S, rate):
    """One launch of the FFN backward's two-product kernel alone
    (``smm_ffn_bwd_mm``): (h, dhp, part, db1)."""
    import torch

    from simple_multimodal_tpu_torch.ops.hopper import _build
    from simple_multimodal_tpu_torch.ops.hopper.dropout import threshold

    (M, E), Fd = a.shape, w1t.shape[0]
    dev, p = a.device, _build.ptr
    h = torch.empty(M, Fd, dtype=torch.bfloat16, device=dev)
    dhp = torch.empty(M, Fd, dtype=torch.bfloat16, device=dev)
    part = torch.empty(-(-M // 128), Fd, device=dev)
    db1 = torch.empty(Fd, device=dev)
    seed = torch.tensor([DROP_SEED], dtype=torch.int32, device=dev) if rate else None
    lib = _build.library()
    err = lib.smm_ffn_bwd_mm(p(a), p(dy0), p(w1t), p(b1), p(w2t), M, E, Fd, S, p(seed),
                             threshold(rate), 1.0 / (1.0 - rate), p(h), p(dhp), p(part), p(db1),
                             _build.stream_ptr(a))
    _build.check(lib, err, "ffn_bwd_mm")
    return h, dhp, part, db1


def phase_ffn_bwd_kernels(dev):
    """The FFN backward's two-product kernel alone, with and without the
    mid dropout, against a plain f32 expression on the same bf16
    inputs (h and dh_pre bf16: atol=rtol=3e-2; db1, the fold of the kernel's
    per-strip partials, bit-equal to ``ffn_block.fold_columns`` of those
    partials and within 1e-3 of the f32 sum of the kernel's own dh_pre; the
    dropped positions of h and dh_pre exactly zero and equal to
    ``dropout.ffn_keep``; two runs bit-equal), its device time and TFLOP/s;
    then the LayerNorm backward (``smm_ln_bwd``) against autograd of
    ``F.layer_norm`` with its time and byte bound."""
    import torch
    import torch.nn.functional as F

    from simple_multimodal_tpu_torch.ops.hopper import _build
    from simple_multimodal_tpu_torch.ops.hopper import ffn_block as fb
    from simple_multimodal_tpu_torch.ops.hopper.dropout import SALT_MID, ffn_keep
    from simple_multimodal_tpu_torch.ops.hopper.gemm import gelu_grad

    gen = torch.Generator(device=dev).manual_seed(8)
    bf16, E, Fd, S = torch.bfloat16, 768, 3072, 197
    lib = _build.library()

    def rn(*shape, std=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * std

    w1t, b1 = rn(Fd, E, std=E ** -0.5).to(bf16), rn(Fd, std=0.1).to(bf16)
    w2t = rn(E, Fd, std=Fd ** -0.5).to(bf16)
    for M in GEMM_ROWS:
        a, dy0 = rn(M, E).to(bf16), rn(M, E).to(bf16)
        hpre = a.float() @ w1t.float().t() + b1.float()
        dh = dy0.float() @ w2t.float()
        text = ""
        for rate in (DROP_RATE, 0.0):
            keep = (ffn_keep(DROP_SEED, SALT_MID, -(-M // S), S, Fd, rate,
                             device=dev).reshape(-1, Fd)[:M] if rate else None)
            sc = 1.0 / (1.0 - rate)
            want_h = F.gelu(hpre, approximate="tanh")
            want_d = dh * gelu_grad(hpre, True)
            if rate:
                want_h, want_d = want_h * keep * sc, want_d * keep * sc
            h, dhp, part, db1 = _ffn_bwd_mm(a, dy0, w1t, b1, w2t, S, rate)
            again = _ffn_bwd_mm(a, dy0, w1t, b1, w2t, S, rate)
            sync()
            err_h = float((h.float() - want_h).abs().max())
            err_d = float((dhp.float() - want_d).abs().max())
            ok = bool(torch.allclose(h.float(), want_h, atol=ATOL_BF16, rtol=ATOL_BF16)
                      and torch.allclose(dhp.float(), want_d, atol=ATOL_BF16, rtol=ATOL_BF16))
            folded = torch.equal(db1, fb.fold_columns(part))
            plain_sum = dhp.float().sum(0)
            err_b = float((db1 - plain_sum).abs().max()) / float(plain_sum.abs().max())
            same = all(bool(torch.equal(x, y)) for x, y in zip((h, dhp, part, db1), again))
            wrong = 0
            if rate:  # dropped: exactly zero; kept: zero only by chance
                wrong = int(((h != 0) & ~keep).sum() + ((dhp != 0) & ~keep).sum())
                zero = int(((h == 0) & keep & (want_h.abs() > 1e-3)).sum())
                ok = ok and zero <= 1 + M * Fd // 10 ** 6
            ok = ok and folded and err_b <= 1e-3 and same and not wrong
            ms = _back_to_back_ms(lambda: _ffn_bwd_mm(a, dy0, w1t, b1, w2t, S, rate))
            text += (f" | rate={rate}: err h={err_h:.2e} dhp={err_d:.2e} "
                     f"db1 rel={err_b:.1e} fold_bit_equal={folded} bit_equal={same} "
                     f"wrongly_kept={wrong} ms={ms:.4f} "
                     f"{4.0 * M * E * Fd / ms / 1e9:.0f} TFLOP/s")
            if not ok:
                raise AssertionError(f"ffn_bwd two-product [{M},{E},{Fd}] rate={rate}: "
                                     f"{text.split(' | ')[-1]}")
            del h, dhp, part, db1, again, want_h, want_d, keep
        log(f"ffn_bwd two-product [{M},{E},{Fd}]{text}")
        del a, dy0, hpre, dh
        torch.cuda.empty_cache()
    log(f"ffn_bwd times above: device time per call in a run of 10 back-to-back calls, bf16, "
        f"on {smi_line()}")
    # the LayerNorm backward as the pre-LN sites call it: dy f32 (dxn), x, g and the
    # residual cotangent bf16, dx bf16
    for M in (47280, 4096, 1001):
        x, dy, add = rn(M, E).to(bf16), rn(M, E), rn(M, E).to(bf16)
        g = (1.0 + rn(E, std=0.1)).to(bf16)
        blocks = _build.ln_bwd_blocks(M)
        part = torch.empty(blocks, 2 * E, device=dev)
        dln, dx = torch.empty(2, E, device=dev), torch.empty(M, E, dtype=bf16, device=dev)

        def call():
            err = lib.smm_ln_bwd(dy.data_ptr(), x.data_ptr(), g.data_ptr(), 1e-12, M, E,
                                 add.data_ptr(), dx.data_ptr(), part.data_ptr(), dln.data_ptr(),
                                 _build.stream_ptr(x))
            _build.check(lib, err, "ln_bwd")

        call()
        xf = x.float().requires_grad_()
        gf = g.float().requires_grad_()
        bf = torch.zeros(E, device=dev, requires_grad=True)
        F.layer_norm(xf, (E,), gf, bf, 1e-12).backward(dy)
        want_dx = xf.grad + add.float()
        sync()
        err_dx = float((dx.float() - want_dx).abs().max())
        rel_g = float((dln[0] - gf.grad).abs().max()) / float(gf.grad.abs().max())
        rel_b = float((dln[1] - bf.grad).abs().max()) / float(bf.grad.abs().max())
        ok = bool(torch.allclose(dx.float(), want_dx, atol=ATOL_BF16, rtol=ATOL_BF16)
                  and rel_g <= 1e-3 and rel_b <= 1e-3)
        ms = _back_to_back_ms(call)
        nbytes = M * E * (4 + 2 + 2 + 2) + 2 * E * 2 + 2 * E * 4
        log(f"ln_bwd [{M},{E}] max_abs_err dx={err_dx:.3e} (atol=rtol={ATOL_BF16:g}) "
            f"dgamma rel={rel_g:.1e} dbeta rel={rel_b:.1e} ok={ok} ms={ms:.4f} "
            f"bound_ms={nbytes / PEAK_BYTES * 1e3:.4f} (bytes: {nbytes / 1e6:.0f} MB) "
            f"partials={blocks}")
        if not ok:
            raise AssertionError(f"ln_bwd [{M},{E}] disagrees with autograd of F.layer_norm")
        del x, dy, add, part, dx, xf
        torch.cuda.empty_cache()
    log(f"ln_bwd times above: device time per call in a run of 10 back-to-back calls on "
        f"{smi_line()}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke.py: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; this script runs the port on a GPU",
              file=sys.stderr)
        return 2
    argv = sys.argv[1:]
    if "--tree" in argv:  # time another checkout's package with this script (--timings)
        sys.path.insert(0, os.path.abspath(argv[argv.index("--tree") + 1]))
    try:
        import simple_multimodal_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke.py: run it from the root of a checkout of the "
              "repository (simple_multimodal_tpu_torch not importable)",
              file=sys.stderr)
        return 2
    try:
        dev = torch.device("cuda", 0)
        t_start = time.perf_counter()
        phase_device_and_build(report="--tree" not in argv)
        if "--profile" in argv or "--timings" in argv:
            with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
                (phase_profile if "--profile" in argv else phase_timings)(dev, tmp)
            return 0
        phase_gemm(dev)
        phase_ffn_bwd_kernels(dev)
        kern = phase_kernels(dev)
        kern.update(phase_backward(dev))
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            _, demo = phase_serve_and_count(dev, tmp)
            phase_full_width_f32(demo)
            phase_train(dev, tmp)
            phase_full_width_train_f32(demo)
            del demo
            torch.cuda.empty_cache()
            with fused_frontend():
                # the launches reported: the long clip's forward runs all five
                # forward kernels, its train step all four backward ones
                counts, long_demo = phase_serve_and_count(dev, tmp, long=True)
                phase_full_width_f32(long_demo, tag="f32 long clip")
                del long_demo
                torch.cuda.empty_cache()
                counts.update({k: v for k, v in phase_train(dev, tmp, long=True).items()
                               if k.endswith("_bwd")})
        log(f"all phases in {time.perf_counter() - t_start:.1f} s")
    except Exception:
        traceback.print_exc()
        return 1
    kernels = [{
        "name": name, "route": "cuda", "source": SOURCES[name],
        "replaces": REPLACES[name], "launches": counts[name],
        "max_abs_err": kern[name]["max_abs_err"], "ms": kern[name]["ms"],
        "plain_ms": kern[name]["plain_ms"], "bound_ms": kern[name]["bound_ms"],
        "bound_by": kern[name]["bound_by"], "library_ms": kern[name]["library_ms"],
    } for name in REPLACES]
    log(json.dumps({"kernels": kernels}))
    log(smi_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
