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
   23/35/12 times; ms/step on the host clock and peak device memory; then,
   as information, the step with wav2vec2's fused front end off and on, in
   turns;
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
    must launch flash_attention_bwd and wav_frontend_bwd once beside the
    three other backwards 23/35/12; finite losses, every parameter that
    feeds the loss moves;
11. distillation: a base hierarchical teacher and a student with its
    encoders and the fusion stack halved (hidden 256, 4 heads, half the
    layers), B=8 bf16, dropout and augmentation on, the teacher frozen by
    the model (``requires_grad`` off): after one warm-up step, 3
    steps each launching both models' forwards (46/70/24) and the student's
    backwards (23/35/12); a finite distillation loss > 0; every teacher
    parameter bit-equal with no ``.grad``; every student parameter that
    feeds the loss moves; ms/step and peak memory;
12. few-shot episodes: the base hierarchical few-shot model (adapters, a
    10-row prompt: DeBERTa at S = 522), all but the adapters, the prompt
    and the prototype network frozen, the trainable-only optimizer,
    7-way 5-shot (a support of 35 clips ordered by label) and a query of
    16: after one warm-up episode, 3 episodes each launching the forwards
    of two passes (46/70/24) and the backwards of DeBERTa alone
    (deberta_attention_bwd 24, ffn_block_bwd 24, attention_block_bwd 0:
    ViT and wav2vec2 are frozen and their adapters sit after them); finite
    losses; only the adapters, the prompt and the prototype network move;
    ms/episode, peak memory, and the device time by kernel of one episode;
13. robust: ``make_train_step(logits_key="robust_prediction",
    missing_modality_rate=0.3, compute_contrastive_loss=False)`` at B=8,
    3 steps of 23/35/12 forward and backward launches; then
    ``make_eval_step`` over the seven missing-modality scenarios: finite,
    predictions in [0, 7);
14. late serve: a base ``late`` model (no classifier) saved and loaded
    through MultimodalEmotionDemo; ``predict`` returns three filled
    ``individual_modalities`` summing to 1 ± 1e-2; a B=8 forward launches
    23/35/12;
15. half preset (E 384, 6 layers of 6 heads, F 1536 in all three
    backbones): a B=8 forward launching 11/17/6 and, after a warm-up, 3
    train steps launching 11/17/6 both ways; every parameter that feeds the
    loss moves; ms and peak memory;
16. f32 in context, card (TF32 off) against CPU: a base-width few-shot
    episode (2-way 1-shot, a query of 2, dropout off): loss within 1e-4
    relative, the prompt's, the adapters' and the prototype network's
    gradients within 1e-3 of their largest magnitude; a half-preset B=1
    forward at atol=rtol=1e-3;
17. train from files: ``create_sample_data_torch.py`` writes 6 clips per
    emotion (42: 29 train, 6 val, 7 test; the clip store, mp4 or sidecar,
    and the audio decoder, native or numpy, printed) and
    ``train_advanced_torch.main`` runs in-process ``--mode standard
    --preset base --fusion_type hierarchical --batch_size 8 --epochs 2``:
    8 train steps each launching 23/35/12 both ways, 2 validations and a
    test pass whose batches launch 23/35/12 forwards and no backward,
    every loss finite, ``best_model/`` and ``final_model_hierarchical/``
    with their ``meta.json``; ``--resume`` with ``--epochs 3`` goes on at
    epoch 3 from step 8 to 12; ``load_pretrained_model`` →
    ``MultimodalEmotionDemo.predict`` from a WAV path and the clip,
    bit-equal to the request from arrays the port's loaders decoded; one
    epoch with ``device_data_cache_mb=0`` (the prefetcher). Printed: decode
    seconds cold and warm, seconds per epoch and clips/s on both paths,
    peak device memory;
18. distillation from files: ``train_advanced_torch.main --mode
    distillation --teacher_model <17's final_model_hierarchical> --epochs
    1``: 4 synchronised, timed train steps each launching both models'
    forwards (46/70/24) and the student's backwards (23/35/12), a
    validation and a test batch of 46/70/24 forwards; the teacher bit-equal
    to its checkpoint after the run; ``distilled_student_model`` loaded
    strictly into a standard model of the student's config, which serves
    ``happy_000`` from its paths. Printed: step ms, epoch s, peak memory;
19. ablation: ``--mode ablation --epochs 1``, five fusions, each 4 train
    steps of 23/35/12 both ways and 2 eval batches of 23/35/12 forwards;
    finite validation accuracy and F1 a fusion;
20. ``--mode all`` at the half preset, ``--epochs 1 --episodes 1
    --few_shot_samples 1``: 48 train steps of 11/17/6 both ways and 29 eval
    batches of 11/17/6 forwards (six fusions, the robust epoch and its seven
    scenarios, the ablation), ``errors`` empty, every output directory;
21. evaluation: ``evaluate_model_torch.main`` on 17's model over the test
    split: one batch of 23/35/12 forwards, predictions equal to the
    trainer's test pass and accuracy to ``evaluate_test_set`` on the same
    model, ``evaluation_report.html`` and ``detailed_results.json``, the
    line each skipped plot printed; ``evaluate_dataset`` seconds and clips/s;
22. web server: ``demo/serve_torch.py``'s handler on port 0 in a thread;
    ``POST /api/analyze`` with ``happy_000``'s paths answers ``predict``'s
    distribution bit for bit, 23/35/12 forwards a request; 5 requests timed;
23. weights I/O: 17's backbones written as HF-named safetensors by the
    port's writer and imported by ``tools/import_hf_backbones_torch.py``:
    state dict and one served request bit-equal to the same fresh model
    given them directly; where ``transformers`` imports, its
    DeBERTa-v3-base, wav2vec2-base and ViT-B/16 (random weights, a local
    config) saved, imported, and their f32 hidden states on the card held
    against the port's f32 encoders at atol=rtol=1e-3;
24. data parallel (``parallel/mesh.py``): the base hierarchical model, B=8,
    dropout and augmentation off, the contrastive loss on, two train steps
    and a validation batch, each launching 23/35/12 both ways (the batch
    23/35/12 forwards) on every rank: without a process group in bf16 and
    in f32 (the references); through the data-parallel path over NCCL at
    world 1 in this process in bf16, every collective called (counted),
    bit-equal to the reference (cuDNN deterministic for both); at world 2
    on this one card, two processes started as torchrun starts a rank and
    joined by ``initialize_distributed`` over gloo (NCCL refuses two ranks
    on one device; every kernel runs on the card), 4 rows a rank, and where
    there are two cards or more at world min(cards, 4) under ``torchrun``
    over NCCL, a card a rank: in bf16 and f32 held to the references
    (``DP_BOUNDS``: f32 the CPU test's loss, gradient-norm and parameter
    bounds, a few elements a tensor excepted; bf16 each tensor's update
    against the reference's), every rank's parameters bit-identical, and
    in bf16 with the contrastive term rank-local, which must fail those
    bounds; then ``train_advanced_torch.main --mesh W,1 --epochs 1`` on
    17's files on every rank: the set cached on the card under the mesh,
    4 train steps and 2 eval batches at their launches, losses, validation
    and parameters equal on every rank, rank 0 alone writing
    ``best_model/`` and ``final_model_hierarchical/``; each rank's ms/step
    and peak memory printed. ``python3 chip_smoke.py --data-parallel`` runs
    the build and this phase alone (the four-card call);
25. tensor parallel (``parallel/tensor.py``, the mesh's model axis): first
    ``deberta_attention`` at the per-rank shapes of a model axis of 2 and 4
    ([8,512,6,64] and [8,512,3,64], bf16, tables [512, 384] and [512, 192])
    with hash dropout 0.1 seeded as ``kernel_seed(model_axis=True)`` seeds
    shard (1, 1) of a (2, 2) mesh, forward and backward against the plain
    version (bf16 bounds of phases 2 and 3), timed; then the base
    hierarchical model, B=8, dropout and augmentation off, the contrastive
    loss on, in one process without a process group in bf16 and f32 (TF32
    off, cuDNN deterministic): eval logits, two train steps and a validation
    batch (the references); at mesh (1, 2) on this one card, two processes
    started as torchrun starts a rank and joined by
    ``initialize_distributed`` over gloo, each holding its shards of the
    parameters and Adam moments and taking the whole batch: in bf16 and
    f32 the eval logits (f32 within 1e-4; bf16 their probabilities within
    2^-5, phase 24's bound) and the two steps and the validation batch held to the
    references (``DP_BOUNDS``), every step and batch launching 23/35/12 both
    ways, the replicated parameters bit-identical on both ranks after each
    step; one bf16 step with each planted fault (the gathered weights'
    gradients summed over the model group; the clip norm over local shards),
    which must fail those bounds; the collectives called; then
    ``train_advanced_torch.main --mesh 1,2 --epochs 1`` on 17's files on
    both ranks, as phase 24's CLI, and the saved model loaded into this
    process giving the ranks' logits. Where there are four cards or more,
    the same at mesh (2, 2) under ``torchrun`` over NCCL, a card a rank.
    ``python3 chip_smoke.py --tensor-parallel`` runs the build and this
    phase alone.

Phases 2 and 3 also run the half preset's widths: attention_block at
[240,197,384] and [8,499,384] (6 heads), ffn_block at E 384 / F 1536
(pre-LN [240,197,384], post-LN [8,512,384]) and deberta_attention at
[8,512,6,64], bf16 and f32 at the same tolerances; in bf16 the forward's
GEMM routes (``gemm_route``), the attention core's
(``smm_attention_wgmma_route``) and a device profile of one call must show
the wgmma bodies, and the backwards' routes are held as for every case.

Phase 1 also runs the exact self-test of the shared Hopper building blocks
(``csrc/hopper.cuh``: wgmma with both descriptor forms, TMA, the swizzle)
and prints ptxas' registers and spill bytes and the dynamic shared memory of
every wgmma kernel (the flash-attention kernels, the attention core's
dropout variants forward and backward, deberta_attention's forward and
backward pair, the GEMM's two tile shapes and the FFN backward's two-product
kernel) and the
row kernels of the FFN and LayerNorm backwards, and of every instantiation
of wav_frontend's kernels (its two forward passes, its two backward passes
and their four folds, with their shared memory); a spill or a
serialized-wgmma warning there fails the run. It prints what encoding one TMA tensor map
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

After the GEMM phase, ``gemm_linear`` (the DeepSeek text tower's
projections, its dense layer and its shared experts on ``smm_gemm``, forward
and both backward products) at the tower's shapes (``GEMM_LINEAR_SHAPES``:
8192 tokens, and 771 rows for a ragged M tail): the forward at 3e-2, dx and every stacked weight's dW
within 5e-2 of the tensor's largest magnitude against autograd of the plain
f32 version, and the device time of a forward and backward.
``python3 chip_smoke.py --gemm-linear`` runs the build and this phase alone.

Then the routed experts of one MoE layer (``moe_experts``,
``csrc/moe_experts_wgmma.cu``) at the moonlight.train shapes (T 8192, k 6 of
64 experts, 8 held, E 2048, F 1408), for a skewed routing (an idle expert,
one with 3186 rows) and a drawn one, against the plain f32 version
(``moe_experts_plain``, on the same bf16-rounded operands) and the per-expert
loop they replace (``moe_loop``, on ``gemm_linear``): the forward at 3e-2,
dh, the routing weights' gradient and every dW within 5e-2 of the tensor's
largest magnitude, the same device kernels under both routings
(``moe_experts`` lines: both paths' forward and backward time beside the
products' bound); then a whole MoE layer's forward and backward, which
counts one ``moe_experts`` launch.
``python3 chip_smoke.py --moe-experts`` runs the build and this phase alone.

Then the optimizer update (``phase_adamw``) at the parameter lists of
``portbench/configs/mer_base.json`` and ``mer_moonlight.json`` (models built
on the meta device, f32 leaves filled from a seed): the two AdamW kernels
(``csrc/adamw.cu``) against the chain of foreach passes (``adamw`` lines:
the norm within 1e-6; at mer_base also m and v within 2e-6 and each leaf's
change within 1e-5, relative in norm; one launch of each kernel), then the
update's device time, chain, kernels, kernels, chain, beside the byte bound
(32 B an element over 3.35 TB/s), the host's enqueue time and the device
memory one update adds. ``python3 chip_smoke.py --adamw`` runs the build and
this phase alone.

After that, the FFN backward's two-product kernel alone
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
(forward at [8,160000], [8,320000] and [8,16013], C=512, whose last tiles
hold 127, 127 and 1 frames; forward+backward, dwav included, against
autograd of the plain version and against its closed form
``wav_frontend_bwd_plain``, each tensor within 1e-3 (f32) or 5e-2 (bf16) of
its largest magnitude, two backward runs bit-equal, times with and without
dwav, and the device time by kernel of the first case) against their plain
versions at the same tolerances,
and time ``F.scaled_dot_product_attention`` beside flash_attention as a
yardstick the port never calls.

After phase 3, the positional conv phase holds wav2vec2's grouped 'same'
convolution (``grouped_conv_same``, ``csrc/pos_conv.cu``, a kernel that
replaces no TPU kernel) at [8,499,768] and [8,999,768] (K = 128, 16 groups)
and the half width [8,499,384]: forward against the plain version (bf16
3e-2, f32 1e-3), the input, weight and bias gradients against autograd of
the plain version (5e-2 or 1e-3 of the largest magnitude), dx bit-equal
between two runs; ``pos_conv`` lines give the kernel's forward and input
gradient alone, cuDNN's weight gradient, the layer's forward+backward
through the wrapper, the plain forward, cuDNN's ``F.conv1d`` forward and
backward (a yardstick the port never calls) and the bound, and the device
time by kernel of one forward+backward, which must show the wgmma kernel
and no cuDNN ``dgrad``. ``python3 chip_smoke.py --pos-conv`` runs the build
and this phase alone.

``python3 chip_smoke.py --profile`` runs none of the checks: after the build
it prints, for the 10 s and the 20 s model, the device time by kernel over
two B=8 forwards and two B=8 train steps, with the device's busy share of
the wall time, through ``utils/profiling.py`` (``trace``: ``torch.profiler``
with a Chrome trace written to the run's temporary directory; ``annotate``
around each repetition). ``python3 chip_smoke.py --timings [--tree DIR]``
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
import shutil
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
    # the custom VJP (jax.vjp of _xla_reference; no Pallas kernel of its own)
    "wav_frontend_bwd": "simple_multimodal_tpu/ops/pallas/wav_frontend.py:246",
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
# the front end's backward kernels live beside its forward
SOURCES["wav_frontend_bwd"] = "simple_multimodal_tpu_torch/csrc/wav_frontend.cu"
# kernels that replace no TPU kernel: wav2vec2's positional conv, which the JAX package
# leaves to XLA (forward and input gradient)
NEW_KERNELS = {"grouped_conv_same": "none: simple_multimodal_tpu/models/wav2vec2.py "
                                    "PositionalConvEmbedding, lax.conv_general_dilated"}
SOURCES["grouped_conv_same"] = "simple_multimodal_tpu_torch/csrc/pos_conv.cu"
NO_LAUNCHES = dict.fromkeys([*REPLACES, *NEW_KERNELS, "grouped_conv_same_bwd"], 0)
# one B=8 forward (serve) and one B=8 train step, at 10 s and at 20 s of audio
FORWARD_LAUNCHES = {"attention_block": 23, "ffn_block": 35, "deberta_attention": 12,
                    "grouped_conv_same": 1}
BACKWARD_LAUNCHES = {"attention_block_bwd": 23, "ffn_block_bwd": 35, "deberta_attention_bwd": 12,
                     "grouped_conv_same_bwd": 1}
EXPECTED_LAUNCHES = {**NO_LAUNCHES, **FORWARD_LAUNCHES}
TRAIN_LAUNCHES = {**EXPECTED_LAUNCHES, **BACKWARD_LAUNCHES}
LONG_FORWARD_LAUNCHES = dict(EXPECTED_LAUNCHES, flash_attention=1, wav_frontend=1)
LONG_TRAIN_LAUNCHES = dict(LONG_FORWARD_LAUNCHES, **BACKWARD_LAUNCHES, flash_attention_bwd=1,
                           wav_frontend_bwd=1)
# a distillation step: the teacher's and the student's forwards (the student has the
# teacher's encoders), the student's backward
KD_TRAIN_LAUNCHES = {**NO_LAUNCHES, **{k: 2 * v for k, v in FORWARD_LAUNCHES.items()},
                     **BACKWARD_LAUNCHES}
# a few-shot episode: the support's and the query's forwards through one base model; the
# backward reaches the prompt through DeBERTa alone (ViT and wav2vec2 are frozen and their
# adapters sit after them), 12 attention and 12 FFN backwards a pass
FEWSHOT_LAUNCHES = {**NO_LAUNCHES, **{k: 2 * v for k, v in FORWARD_LAUNCHES.items()},
                    "deberta_attention_bwd": 24, "ffn_block_bwd": 24}
# the half preset, 6 layers a backbone: attention ViT 5 (its last layer is CLS-only, plain) +
# wav2vec2 6; FFN ViT 5 + wav2vec2 6 + DeBERTa 6; DeBERTa's attention 6
HALF_FORWARD_LAUNCHES = {**NO_LAUNCHES, "attention_block": 11, "ffn_block": 17,
                         "deberta_attention": 6, "grouped_conv_same": 1}
HALF_TRAIN_LAUNCHES = {**HALF_FORWARD_LAUNCHES, "attention_block_bwd": 11, "ffn_block_bwd": 17,
                       "deberta_attention_bwd": 6, "grouped_conv_same_bwd": 1}
FAMILY_STEPS = 3  # measured steps (episodes) of the family phases


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
        f = 4 * rows * S * E * inputs[1].shape[0]
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
        C, _, K = inputs[1].shape
        f = 2 * K * x.shape[0] * ((x.shape[1] - K) // 5 + 1) * C
        return f, 3 * f
    raise KeyError(name)


def bound(name, inputs, out, backward=False, no_grad=()) -> dict:
    """The least time the card could take for one call (forward, or forward
    and backward): the larger of operations / 989 TFLOP/s and bytes /
    3.35 TB/s, every input read once and every output written once (the
    backward reads a cotangent like the output and writes a gradient like
    each input, but those of the inputs indexed in ``no_grad``)."""
    flops = work(name, inputs)[1 if backward else 0]
    nbytes = sum(t.numel() * t.element_size() for t in list(inputs) + [out])
    nbytes *= 2 if backward else 1
    nbytes -= sum(inputs[i].numel() * inputs[i].element_size() for i in no_grad)
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

    def block_weights(E):  # w_qkv [3E, E], b_qkv, wo [E, E], bo
        return [rn(3 * E, E, std=E ** -0.5), rn(3 * E, std=0.1), rn(E, E, std=E ** -0.5),
                rn(E, std=0.1)]

    def attn_inputs(rows, S):
        return [rn(rows, S, E)] + block_weights(E), [1.0 + rn(E, std=0.1), rn(E, std=0.1)]

    x, lnp = attn_inputs(B * 30, 197)
    cases.append(("attention_block", "ViT [240,197,768] LN+residual",
                  lambda t, g, b: dict(ln=(g, b, 1e-12), residual=True),
                  x, lnp))
    for frames in (499, 999):  # 10 s and 20 s of audio
        x, lnp = attn_inputs(B, frames)
        cases.append(("attention_block", f"wav2vec2 [8,{frames},768]",
                      lambda t, g, b: dict(ln=None, residual=False), x, lnp))

    def ffn_inputs(rows, S):
        return ([rn(rows, S, E), rn(Fd, E, std=E ** -0.5), rn(Fd, std=0.1),
                 rn(E, Fd, std=Fd ** -0.5), rn(E, std=0.1)],
                [1.0 + rn(E, std=0.1), rn(E, std=0.1)])

    # a width that is no multiple of 64: the WMMA GEMM and (head width 32) core
    x96 = [rn(2 * B, 197, 96)] + block_weights(96)
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
                  [rn(2 * B, 197, 96), rn(160, 96, std=96 ** -0.5), rn(160, std=0.1),
                   rn(96, 160, std=160 ** -0.5), rn(96, std=0.1)],
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
    # the half preset (the distillation student's scale): E = 384, six heads of 64, F = 1536
    Eh, Hh, Fh = 384, 6, 1536

    def half_attn(rows, S):
        return [rn(rows, S, Eh)] + block_weights(Eh), [1.0 + rn(Eh, std=0.1), rn(Eh, std=0.1)]

    x, lnp = half_attn(B * 30, 197)
    cases.append(("attention_block", "half ViT [240,197,384] 6 heads LN+residual",
                  lambda t, g, b: dict(ln=(g, b, 1e-12), residual=True, num_heads=Hh), x, lnp))
    x, lnp = half_attn(B, 499)
    cases.append(("attention_block", "half wav2vec2 [8,499,384] 6 heads",
                  lambda t, g, b: dict(ln=None, residual=False, num_heads=Hh), x, lnp))
    for label, rows, S, post, eps in (("half ViT [240,197,384] F=1536 pre-LN", B * 30, 197,
                                       False, 1e-12),
                                      ("half DeBERTa [8,512,384] F=1536 post-LN", B, 512,
                                       True, 1e-7)):
        cases.append(("ffn_block", label,
                      lambda t, g, b, post=post, eps=eps: dict(ln=(g, b, eps), ln_post=post),
                      [rn(rows, S, Eh), rn(Fh, Eh, std=Eh ** -0.5), rn(Fh, std=0.1),
                       rn(Eh, Fh, std=Fh ** -0.5), rn(Eh, std=0.1)],
                      [1.0 + rn(Eh, std=0.1), rn(Eh, std=0.1)]))
    cases.append(("deberta_attention", "half DeBERTa [8,512,6,64] span 256, padded + all-masked",
                  lambda t, g, b: dict(attention_mask=mask, span=span, max_position=512),
                  [rn(B, S, Hh, 64), rn(B, S, Hh, 64), rn(B, S, Hh, 64),
                   rn(2 * span, Eh), rn(2 * span, Eh)], []))
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
    # 10 s and 20 s of audio (T1 = 31999, 63999: 127 frames in the last tile), and a last
    # tile of one frame
    for samples in (160000, LONG_SAMPLES, 16013):
        cases.append(("wav_frontend", f"conv_0+GN+GELU [8,{samples}] C=512",
                      lambda t, g, b: dict(stride=5),
                      [rn(B, samples, std=0.3), rn(512, 1, 10, std=0.1),
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
    held against what the case must take: the wgmma kernel in bf16 at head
    width 64, attention.cuh's otherwise."""
    import torch

    from simple_multimodal_tpu_torch.ops.hopper import _build

    D = args[0].shape[-1]
    route = _build.library().smm_attention_wgmma_route(int(dtype == torch.bfloat16), D, 1)
    want = int(dtype == torch.bfloat16 and D == 64)
    if route != want:
        raise AssertionError(f"deberta_attention forward at head width {D} in {dtype}: route "
                             f"{route}, expected {want}")
    return "wgmma" if route else "wmma/f32"


def _half_forward_body(name, label, args, kw, fn):
    """The body a half-width (E = 384, head width 64, F = 1536) forward
    takes in bf16, by ``gemm_route`` for every product of the block, the
    library's ``smm_attention_wgmma_route`` for the core, and by a device
    profile of one call: the wgmma GEMM and no WMMA GEMM or WMMA attention
    core."""
    import torch

    from simple_multimodal_tpu_torch.ops.hopper import _build
    from simple_multimodal_tpu_torch.ops.hopper.gemm import gemm_route

    if name == "deberta_attention":
        return  # _forward_route holds its body
    x = args[0]
    M, E = x.shape[0] * x.shape[1], x.shape[-1]
    if name == "attention_block":
        products = ((3 * E, E), (E, E))
        core = _build.library().smm_attention_wgmma_route(1, E // kw["num_heads"], 0)
    else:
        Fd = args[1].shape[0]
        products, core = ((Fd, E), (E, Fd)), 1
    routes = [gemm_route(M, n, k) for n, k in products]
    with torch.no_grad():
        calls = _log_device_times(f"{name} {label} forward", fn, reps=3, top=6)

    def n(key):
        return sum(c for k, c in calls.items() if key in k)

    log(f"        {name} {label}: gemm routes {routes} (tile widths), attention core wgmma "
        f"{core}, gemm_wgmma_kernel={n('gemm_wgmma_kernel'):g} "
        f"gemm_bf16_kernel={n('gemm_bf16_kernel'):g} "
        f"attention_wmma_kernel={n('attention_wmma_kernel'):g}")
    if (not all(routes) or core != 1 or not n("gemm_wgmma_kernel")
            or n("gemm_bf16_kernel") or n("attention_wmma_kernel")):
        raise AssertionError(f"{name} {label}: the half-width forward left the wgmma bodies "
                             f"(routes {routes}, core {core}, kernels {calls})")


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
            if label.startswith("half") and dtype == torch.bfloat16:
                _half_forward_body(name, label, args, kw, lambda: kern(*args, **kw))
            log(f"kernel {name:18s} {label:56s} {str(dtype)[6:]:8s} "
                f"max_abs_err={max_err:.3e} tol={tol:g} ok={ok} "
                f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                f"bound_ms={bound(name, args, got)['bound_ms']:.4f}{route}"
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
    ckpt = os.path.join(tmp, "model_long" if long else "model")
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
            # attention_block's packed q|k|v gradients part by part; the key
            # bias has a zero gradient in exact arithmetic: scaled by the
            # query bias's
            parts = [(a, b, b)]
            if names[i] in ("w_qkv", "b_qkv"):
                (qa, ka, va), (qb, kb, vb) = a.chunk(3), b.chunk(3)
                parts = [(qa, qb, qb), (ka, kb, qb if names[i] == "b_qkv" else kb), (va, vb, vb)]
            rel = max(float((pa - pb).abs().max()) / max(float(ref.abs().max()), 1e-30)
                      for pa, pb, ref in parts)
            good = rel <= GRAD_TOL_BF16
        worst = max(worst, rel)
        ok = ok and good
    return ok, max_abs, worst


def _arg_names(name, n):
    if name == "attention_block":
        base = ["x", "w_qkv", "b_qkv", "wo", "bo", "ln_g", "ln_b"]
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
    _check_dropout_positions(dev)
    for name, label, kw_fn, inputs, lnp in cases:
        kern, plain = fns[name]
        n_in = len(inputs)
        if name == "wav_frontend":
            _check_wav_backward(kern, plain, inputs, gen, label, results)
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
                case_bound = bound(name, args, got[0], backward=True)["bound_ms"]
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
                    f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={case_bound:.4f}{extra}"
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
    ``attention_bwd.cuh``), held against what the case must take: wgmma in
    bf16 at head widths 64 (and 128 for attention_block), the old bodies in
    f32 and elsewhere."""
    import torch

    from simple_multimodal_tpu_torch.ops.hopper import _build

    if name == "ffn_block":
        E, Fd = args[0].shape[-1], args[1].shape[0]
        route = _build.library().smm_ffn_bwd_route(int(dtype == torch.bfloat16), E, Fd)
        want = int(dtype == torch.bfloat16 and E % 64 == 0 and Fd % 128 == 0)
        if route != want:
            raise AssertionError(f"ffn_block backward at [{E}, {Fd}] in {dtype}: route {route}, "
                                 f"expected {want}")
        return route
    if name == "attention_block":
        D, rel = args[0].shape[-1] // kw_fn(None, None, None).get("num_heads", 12), False
    else:
        D, rel = args[0].shape[-1], True
    route = _build.library().smm_attention_wgmma_route(int(dtype == torch.bfloat16), D, int(rel))
    want = int(dtype == torch.bfloat16 and (D == 64 or (D == 128 and not rel)))
    if route != want:
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
            wv[:, :D] = torch.eye(D, device=dev).repeat(H, 1)  # x[:, :, :D] -> every head's values
            zeros = torch.zeros(E, device=dev)
            ws = [torch.cat([rn(2 * E, E, std=E ** -0.5), wv]),
                  torch.cat([rn(2 * E, std=0.1), zeros]), torch.eye(E, device=dev), zeros]
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
            none, eye = torch.zeros(2 * E, E, device=dev), torch.eye(E, device=dev)
            ws = [torch.cat([none, eye]), torch.cat([rn(2 * E, std=0.1), zeros]), eye, zeros]
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
        w1, b1, b2 = rn(Fd, E, std=E ** -0.5), rn(Fd, std=0.1), rn(E, std=0.1)
        got = torch.zeros(rows, S, Fd, dtype=torch.bool, device=dev)
        for c0 in range(0, Fd, E):  # out = the intermediate's columns c0 .. c0 + E
            w2 = torch.zeros(E, Fd, device=dev)
            w2[:, c0:c0 + E] = torch.eye(E, device=dev)
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
        w2 = rn(E, Fd, std=Fd ** -0.5).to(dtype)
        gy = rn(rows, S, E).to(dtype)
        xg = x.to(dtype).requires_grad_()
        for c0 in range(0, Fd, E):
            w1e = torch.zeros(Fd, E, device=dev)
            w1e[c0:c0 + E] = torch.eye(E, device=dev)
            out = ffn_block(xg, w1e.to(dtype), b1.to(dtype), w2,
                            torch.zeros(E, device=dev, dtype=dtype), residual=False,
                            dropout_rate_mid=DROP_RATE, dropout_seed=DROP_SEED)
            (dx,) = torch.autograd.grad(out, [xg], gy)
            sync()
            got[..., c0:c0 + E] = dx != 0
        same(f"ffn_block backward mid [{rows},{S},{Fd}] {name}", got,
             ffn_keep(DROP_SEED, SALT_MID, rows, S, Fd, DROP_RATE, device=dev))
        out = ffn_block(x.to(dtype), w1.to(dtype), b1.to(dtype),
                        rn(E, Fd, std=Fd ** -0.5).to(dtype), b2.to(dtype), residual=False,
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


def _wav_errors(got, want, tol):
    """(ok, max abs error, worst error relative to each tensor's largest
    magnitude) of the output and the four gradients."""
    import torch

    worst, max_abs, ok = 0.0, 0.0, True
    for a, b in zip(got, want):
        err = float((a.float() - b).abs().max())
        rel = err / max(float(b.abs().max()), 1e-30)
        ok = ok and bool(torch.isfinite(a).all()) and rel <= tol
        max_abs, worst = max(max_abs, err), max(worst, rel)
    return ok, max_abs, worst


def _check_wav_backward(kern, plain, inputs, gen, label, results):
    """wav_frontend's forward and backward kernels (dwav, dkernel, dgamma,
    dbeta) against autograd of ``wav_frontend_plain`` on the same inputs in
    the same dtype and against ``wav_frontend_bwd_plain`` (the closed form,
    from the plain statistics), each tensor within 1e-3 (f32) or 5e-2
    (bf16) of its largest magnitude: dkernel sums 8 T1 products a tap, so
    its small entries carry the f32 rounding of that sum; two backward
    runs bit-equal; CUDA-event medians of kernel fwd+bwd and autograd of
    the plain version, interleaved, with dwav (checked here) and without
    (the model's backward: the waveform takes no gradient). The first bf16
    case's model backward gives the wav_frontend_bwd entry of the kernels
    line."""
    import torch
    import torch.nn.functional as F

    from simple_multimodal_tpu_torch.ops.hopper.wav_frontend import wav_frontend_bwd_plain

    names = ["out", "wav", "kernel", "gn_scale", "gn_bias"]
    for dtype in (torch.bfloat16, torch.float32):
        wav, kern_w, gs, gb = inputs[0], inputs[1].to(dtype), inputs[2], inputs[3]
        args = [t.clone().requires_grad_() for t in (wav, kern_w, gs, gb)]
        out = kern(*args, stride=5)
        gy = torch.randn(out.shape, generator=gen, device=out.device).to(dtype)
        got = [out.detach()] + list(torch.autograd.grad(out, args, gy))
        again = torch.autograd.grad(kern(*args, stride=5), args, gy)
        same = all(bool(torch.equal(a, b)) for a, b in zip(got[1:], again))
        ref = [t.detach().clone().requires_grad_() for t in args]
        out_p = plain(*ref, stride=5)
        want = [out_p.detach().float()] + [g.float() for g in torch.autograd.grad(out_p, ref, gy)]
        with torch.no_grad():
            y = F.conv1d(wav.to(dtype)[:, None], kern_w, stride=5).float()
            var, mean = torch.var_mean(y, dim=-1, unbiased=False)
            closed = [want[0]] + [g.float() for g in wav_frontend_bwd_plain(
                gy, wav, kern_w, gs, gb, mean, torch.rsqrt(var + 1e-5), 5)]
        del y, out, out_p, again
        sync()
        tol = GRAD_TOL_BF16 if dtype == torch.bfloat16 else ATOL_F32
        ok_a, err_a, worst_a = _wav_errors(got, want, tol)
        ok_c, err_c, worst_c = _wav_errors(got, closed, tol)
        ok = ok_a and ok_c and same
        per = " ".join(
            f"d{n}={float((a.float() - b).abs().max()) / max(float(b.abs().max()), 1e-30):.2e}"
            for n, a, b in zip(names[1:], got[1:], want[1:]))

        def fwd_bwd(fn, wrt=args):
            torch.autograd.grad(fn(*args, stride=5), wrt, gy)

        def timed(wrt):
            t_p1 = time_ms(lambda: fwd_bwd(plain, wrt), 3)
            t_k1 = time_ms(lambda: fwd_bwd(kern, wrt), 5)
            t_k2 = time_ms(lambda: fwd_bwd(kern, wrt), 5)
            t_p2 = time_ms(lambda: fwd_bwd(plain, wrt), 3)
            return median(t_k1 + t_k2), median(t_p1 + t_p2)

        ms_dx, plain_dx = timed(args)
        args[0].requires_grad_(False)  # the model's backward: no dwav
        ms, plain_ms = timed(args[1:])
        sync()
        log(f"fwd+bwd wav_frontend       {label:56s} {str(dtype)[6:]:8s} "
            f"max_abs_err={err_a:.3e} worst_rel={worst_a:.3e} (closed form: {err_c:.3e}, "
            f"{worst_c:.3e}) ok={ok} bit_equal={same} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"(with dwav: {ms_dx:.4f}, {plain_dx:.4f}); relative to autograd of plain: {per}")
        if not ok:
            raise AssertionError(f"wav_frontend {label} {dtype}: the backward disagrees with "
                                 f"autograd of the plain version ({err_a:.3e}, {worst_a:.3e}) or "
                                 f"its closed form ({err_c:.3e}, {worst_c:.3e}), or two runs "
                                 f"differ (bit_equal={same})")
        r = results.setdefault("wav_frontend_bwd", {"max_abs_err": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], err_a, err_c)
        if "ms" not in r:
            r.update(ms=ms, plain_ms=plain_ms, library_ms=None,
                     **bound("wav_frontend", args, got[0], backward=True, no_grad=(0,)))
            with_dx = bound("wav_frontend", args, got[0], backward=True)["bound_ms"]
            log(f"        wav_frontend_bwd: fwd+bwd bound {r['bound_ms']:.4f} ms by "
                f"{r['bound_by']} ({with_dx:.4f} with dwav), library_ms=None")
            _log_device_times(f"wav_frontend {label} fwd+bwd", lambda: fwd_bwd(kern, args[1:]),
                              top=8)
        del got, want, closed, args, ref
        torch.cuda.empty_cache()


# ------------------------------------------------------------ phases 6, 7

def _train_batch(rng, cfg, dev, n=None, labels=None):
    """``n`` (default B) seeded clips (text, int16 audio, yuv420 video) and
    their labels (drawn, or ``labels``), on ``dev``."""
    import numpy as np
    import torch

    n = B if n is None else n
    from simple_multimodal_tpu_torch.data.tokenizer import HashTokenizer
    from simple_multimodal_tpu_torch.data.video_wire import pack_yuv420

    words = ["great", "sad", "angry", "afraid", "surprised", "disgusted", "fine", "ok"]
    texts = [f"clip {i}: feeling {words[int(rng.integers(0, 8))]} today" for i in range(n)]
    enc = HashTokenizer(model_max_length=cfg.text_max_length)(texts)
    batch = {
        "text": {k: torch.from_numpy(v).to(dev) for k, v in enc.items()},
        "audio": torch.from_numpy((rng.standard_normal((n, cfg.audio_max_length))
                                   * 3000).astype(np.int16)).to(dev),
        "video": torch.from_numpy(pack_yuv420(rng.integers(
            0, 256, (n, cfg.video_max_frames, *cfg.video_frame_size, 3),
            dtype=np.uint8))).to(dev),
    }
    if labels is None:
        labels = rng.integers(0, cfg.num_emotions, n)
    batch["emotion"] = torch.from_numpy(np.asarray(labels)).long().to(dev)
    return batch


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
    if not long:
        _frontend_train_ab(model, step, state, _train_batch(rng, cfg, dev))
    return counts


def _frontend_train_ab(model, step, state, batch):
    """Information: the B=8 train step at 10 s with wav2vec2's fused front
    end off (the default) and on, interleaved off, on, on, off, three steps
    each after one step to warm up, on the same model and batch."""
    fe = model.audio_encoder.model.feature_extractor
    off = fe.cfg
    times = {False: [], True: []}
    for fused in (False, True, True, False):
        fe.cfg = dataclasses.replace(off, fused_frontend=fused)
        state, _ = step(state, batch)  # warm-up
        sync()
        for _ in range(3):
            t0 = time.perf_counter()
            state, _ = step(state, batch)
            sync()
            times[fused].append((time.perf_counter() - t0) * 1e3)
    fe.cfg = off
    log(f"train: B={B} step at 10 s, fused front end off {median(times[False]):.2f} ms "
        f"(min {min(times[False]):.2f}, max {max(times[False]):.2f}), on "
        f"{median(times[True]):.2f} ms (min {min(times[True]):.2f}, max "
        f"{max(times[True]):.2f}); 6 steps each, interleaved; {smi_line()}")


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

# ------------------------------------------------------------ phases 11-16: the model families

def _expect(tag: str, counts: dict, expected: dict):
    if counts != expected:
        raise AssertionError(f"{tag}: launch counts {counts} != {expected}")


def _still(model, before: dict, names) -> list:
    """The parameters among ``names`` whose values equal ``before``'s."""
    import torch

    params = dict(model.named_parameters())
    return [n for n in names if torch.equal(params[n].detach(), before[n])]


def _to(x, dev):
    """A batch (nested dicts of tensors) on ``dev``."""
    return {k: _to(v, dev) for k, v in x.items()} if isinstance(x, dict) else x.to(dev)


def _half_fusion(cfg):
    """The distillation student's config: the teacher's encoders, the fusion
    stack halved (train_advanced.py: hidden 256, 4 heads, half the layers)."""
    student = dataclasses.replace(cfg)
    student.fusion_hidden_size = cfg.fusion_hidden_size // 2
    student.fusion_num_heads = max(cfg.fusion_num_heads // 2, 1)
    student.fusion_num_layers = max(cfg.fusion_num_layers // 2, 1)
    return student


def _train_steps(tag, step, state, batches, expected, extra=None):
    """Run ``step`` on each batch with the counters set to 0 just before it
    and read just after; hold the counts and the metrics' finiteness.
    Returns (state, host ms per step)."""
    import numpy as np
    import torch

    from simple_multimodal_tpu_torch.ops import hopper

    times = []
    for i, batch in enumerate(batches):
        sync()
        hopper.reset_launch_counts()
        t0 = time.perf_counter()
        state, metrics = step(state, *batch)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
        counts = hopper.launch_counts()
        if isinstance(metrics, torch.Tensor):
            metrics = {"loss": metrics}
        vals = {k: float(v) for k, v in metrics.items()}
        log(f"{tag}: step {i} {times[-1]:.1f} ms " + " ".join(
            f"{k}={v:.4f}" for k, v in vals.items()) + f" launches={counts}")
        if not all(np.isfinite(v) for v in vals.values()):
            raise AssertionError(f"{tag} step {i}: non-finite metrics {vals}")
        if extra is not None:
            extra(vals)
        _expect(f"{tag} step {i}", counts, expected)
    return state, times


def phase_distillation(dev, tmp: str):
    """Phase 11: the distillation train step. A base hierarchical teacher
    and a student with its encoders and the fusion stack halved, bf16, B=8,
    dropout and augmentation on, the teacher frozen: one warm-up step, then
    FAMILY_STEPS steps that each launch both models' forwards (46/70/24)
    and the student's backwards (23/35/12); a finite distillation loss > 0;
    every teacher parameter bit-equal with no ``.grad``; every student
    parameter that feeds the loss moves."""
    import numpy as np
    import torch

    from simple_multimodal_tpu_torch.models.multimodal_model import (
        KnowledgeDistillationModel, init_weights)
    from simple_multimodal_tpu_torch.ops.attention import resolve_dtype
    from simple_multimodal_tpu_torch.train.optim import make_optimizer
    from simple_multimodal_tpu_torch.train.state import TrainState
    from simple_multimodal_tpu_torch.train.steps import make_train_step

    teacher = _base_config(tmp)
    student = _half_fusion(teacher)
    t0 = time.perf_counter()
    model = KnowledgeDistillationModel(teacher, student, resolve_dtype(teacher, dev))
    model = init_weights(model, torch.Generator().manual_seed(0)).to(dev)
    opt = make_optimizer(student, model, total_steps=100)
    step = make_train_step(model, opt, student, augment=True, compute_contrastive_loss=True)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    log(f"distillation: teacher base hierarchical (fusion {teacher.fusion_hidden_size}, "
        f"{teacher.fusion_num_heads} heads), student fusion {student.fusion_hidden_size}, "
        f"{student.fusion_num_heads} heads, {student.fusion_num_layers} layers, "
        f"{model.dtype}; built in {time.perf_counter() - t0:.1f} s; {len(opt.names)} "
        f"trainable tensors of {len(before)}")
    rng = np.random.default_rng(5)
    state, _ = step(TrainState.create(0), _train_batch(rng, student, dev))  # warm-up
    sync()
    torch.cuda.reset_peak_memory_stats()

    def positive(vals):
        if not vals["distillation_loss"] > 0:
            raise AssertionError(f"distillation: loss {vals['distillation_loss']} is not > 0")

    batches = [(_train_batch(rng, student, dev),) for _ in range(FAMILY_STEPS)]
    state, times = _train_steps("distillation", step, state, batches, KD_TRAIN_LAUNCHES,
                                positive)
    peak = torch.cuda.max_memory_allocated()
    for n, p in model.teacher.named_parameters():
        if p.grad is not None or not torch.equal(p.detach(), before["teacher." + n]):
            raise AssertionError(f"distillation: teacher parameter {n} moved or has a gradient")
    feeds = [n for n in opt.names if not n[len("student."):].startswith(UNUSED)]
    still = _still(model, before, feeds)
    if still:
        raise AssertionError(f"distillation: {len(still)} student parameters did not move, "
                             f"e.g. {still[:5]}")
    log(f"distillation: B={B} {model.dtype}, dropout and augmentation on: median "
        f"{median(times):.1f} ms/step over {FAMILY_STEPS} steps after one to warm up (host "
        f"clock, batches on the device), peak device memory {peak / 2**30:.2f} GiB; teacher "
        f"bit-equal ({len(before) - len(opt.names)} tensors), {len(feeds)} student tensors "
        f"moved; {smi_line()}")


def phase_fewshot(dev, tmp: str):
    """Phase 12: few-shot episodes. The base hierarchical few-shot model
    (adapters after each backbone, a 10-row prompt: DeBERTa at S = 522),
    the trainable-only optimizer, n_way 7, n_shot 5: a support of 35 clips
    ordered by label and a query of 16. One warm-up episode, then
    FAMILY_STEPS episodes that each launch FEWSHOT_LAUNCHES; finite losses;
    the adapters, the prompt and the prototype network move and every other
    parameter stays bit-equal; the device time by kernel of one episode."""
    import numpy as np
    import torch

    from simple_multimodal_tpu_torch.models.multimodal_model import create_model
    from simple_multimodal_tpu_torch.train.optim import (freeze, is_trainable_name,
                                                         make_trainable_only_optimizer)
    from simple_multimodal_tpu_torch.train.state import TrainState
    from simple_multimodal_tpu_torch.train.steps import make_fewshot_step

    cfg = _base_config(tmp)
    n_way, n_shot, n_query = cfg.num_emotions, 5, 16
    t0 = time.perf_counter()
    model = create_model(cfg, "few_shot", device=dev, generator=torch.Generator().manual_seed(0))
    freeze(model, lambda n: not is_trainable_name(n))
    opt = make_trainable_only_optimizer(cfg, model)
    step = make_fewshot_step(model, opt, n_way, n_shot)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    log(f"few-shot: base hierarchical {model.dtype}, adapters + prompt of "
        f"{cfg.prompt_length} (DeBERTa S = {cfg.text_max_length + cfg.prompt_length}); built in "
        f"{time.perf_counter() - t0:.1f} s; {len(opt.names)} trainable tensors of {len(before)}")
    rng = np.random.default_rng(6)

    def episode():
        support = _train_batch(rng, cfg, dev, n_way * n_shot,
                               labels=np.repeat(np.arange(n_way), n_shot))
        return support, _train_batch(rng, cfg, dev, n_query)

    state, _ = step(TrainState.create(0), *episode())  # warm-up
    sync()
    torch.cuda.reset_peak_memory_stats()
    episodes = [episode() for _ in range(FAMILY_STEPS)]
    state, times = _train_steps("few-shot", step, state, episodes, FEWSHOT_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    frozen = [n for n in before if n not in opt.names]
    moved = sorted(set(frozen) - set(_still(model, before, frozen)))
    still = _still(model, before, opt.names)
    if moved or still:
        raise AssertionError(f"few-shot: frozen parameters moved {moved[:5]} or trainable ones "
                             f"did not {still[:5]}")
    log(f"few-shot: {n_way}-way {n_shot}-shot, query {n_query}: median {median(times):.1f} ms/"
        f"episode over {FAMILY_STEPS} after one to warm up (host clock, batches on the device), "
        f"peak device memory {peak / 2**30:.2f} GiB; {len(opt.names)} tensors moved, "
        f"{len(frozen)} bit-equal; {smi_line()}")
    s, q = episodes[0]
    _log_device_times("few-shot episode (in-model deberta_attention at [35,522,12,64] and "
                      "[16,522,12,64])", lambda: step(state, s, q), reps=1, top=14)


def phase_robust(dev, tmp: str):
    """Phase 13: the robust family. ``make_train_step`` with
    ``logits_key="robust_prediction"``, ``missing_modality_rate=0.3`` and no
    contrastive loss at B=8 bf16, FAMILY_STEPS steps of 23/35/12 forward and
    backward launches, finite metrics; then ``make_eval_step`` over the
    seven missing-modality scenarios: finite logits and probabilities,
    predictions in [0, 7)."""
    import numpy as np
    import torch

    from simple_multimodal_tpu_torch.models.multimodal_model import create_model
    from simple_multimodal_tpu_torch.train.optim import make_optimizer
    from simple_multimodal_tpu_torch.train.state import TrainState
    from simple_multimodal_tpu_torch.train.steps import make_eval_step, make_train_step

    cfg = _base_config(tmp)
    model = create_model(cfg, "robust", device=dev, generator=torch.Generator().manual_seed(0))
    step = make_train_step(model, make_optimizer(cfg, model, total_steps=100), cfg,
                           compute_contrastive_loss=False, logits_key="robust_prediction",
                           missing_modality_rate=0.3)
    rng = np.random.default_rng(7)
    torch.cuda.reset_peak_memory_stats()
    batches = [(_train_batch(rng, cfg, dev),) for _ in range(FAMILY_STEPS)]
    _, times = _train_steps("robust", step, TrainState.create(0), batches, TRAIN_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    log(f"robust: B={B} {model.dtype}, missing_modality_rate 0.3: median "
        f"{median(times[1:]):.1f} ms/step over the {FAMILY_STEPS - 1} steps after the first, "
        f"peak device memory {peak / 2**30:.2f} GiB; {smi_line()}")
    batch = _train_batch(rng, cfg, dev)
    for missing in ((), ("text",), ("audio",), ("video",), ("text", "audio"),
                    ("text", "video"), ("audio", "video")):
        out = make_eval_step(model, compute_loss=False, logits_key="robust_prediction",
                             missing_modalities=missing or None)(batch)
        sync()
        pred = out["predictions"]
        ok = (bool(torch.isfinite(out["logits"].float()).all())
              and bool(torch.isfinite(out["probs"].float()).all())
              and bool(((pred >= 0) & (pred < cfg.num_emotions)).all()))
        log(f"robust eval, missing {missing or 'none'}: predictions {pred.tolist()} finite={ok}")
        if not ok:
            raise AssertionError(f"robust eval with {missing} missing: {out}")
        _check_probs(out["probs"], f"robust eval {missing}")


def phase_late_serve(dev, tmp: str):
    """Phase 14: late fusion served. A base ``late`` bf16 model (no
    classifier) saved and loaded through MultimodalEmotionDemo; one
    ``predict`` returns three ``individual_modalities`` whose distributions
    sum to 1 ± 1e-2; one B=8 forward launches 23/35/12."""
    import numpy as np
    import torch

    from simple_multimodal_tpu_torch.models.multimodal_model import create_model
    from simple_multimodal_tpu_torch.ops import hopper
    from simple_multimodal_tpu_torch.serving.demo import MultimodalEmotionDemo, save_checkpoint

    cfg = _base_config(tmp)
    cfg.fusion_type = "late"
    model = create_model(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    if model.classifier is not None or any(k.startswith("classifier.")
                                           for k in model.state_dict()):
        raise AssertionError("late: the model should have no classifier")
    ckpt = os.path.join(tmp, "model_late_fusion")
    save_checkpoint(ckpt, model, cfg)
    del model
    demo = MultimodalEmotionDemo(checkpoint_path=ckpt, device=dev)
    rng = np.random.default_rng(9)
    text, audio, video = _requests(rng)[2]
    analysis = demo.predict(text, audio, video)
    ind = analysis["individual_modalities"]
    if set(ind) != {"text", "audio", "video"}:
        raise AssertionError(f"late: individual_modalities {sorted(ind)}")
    for m, entry in ind.items():
        _check_probs(torch.tensor(list(entry["distribution"].values()))[None], f"late {m}")
        log(f"late serve: {m} -> {entry['predicted_emotion']} conf={entry['confidence']:.3f}")
    log(f"late serve: fused -> {analysis['predicted_emotion']} conf={analysis['confidence']:.3f}")
    b = _train_batch(rng, cfg, dev)
    batch = (b["text"], b["audio"], b["video"])
    with torch.inference_mode():
        demo.model(*batch)  # warm-up
        sync()
        hopper.reset_launch_counts()
        t0 = time.perf_counter()
        out = demo.model(*batch)
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        counts = hopper.launch_counts()
    _check_probs(out["emotion_probs"], "late B=8 forward")
    log(f"late serve: one B={B} forward {ms:.1f} ms launched {counts}; fusion weights "
        f"{out['fusion_weights'].tolist()}")
    _expect("late serve", counts, EXPECTED_LAUNCHES)


def phase_half(dev, tmp: str):
    """Phase 15: the half preset (E = 384, 6 layers of 6 heads, F = 1536 in
    all three backbones). One B=8 bf16 forward, which must launch 11/17/6,
    then a warm-up and FAMILY_STEPS train steps with dropout and
    augmentation on, each launching 11/17/6 forward and backward; every
    parameter that feeds the loss moves."""
    import numpy as np
    import torch

    from simple_multimodal_tpu_torch.models.multimodal_model import create_model
    from simple_multimodal_tpu_torch.ops import hopper
    from simple_multimodal_tpu_torch.train.optim import make_optimizer
    from simple_multimodal_tpu_torch.train.state import TrainState
    from simple_multimodal_tpu_torch.train.steps import make_train_step

    cfg = _base_config(tmp)
    cfg.encoder_preset = "half"
    model = create_model(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    widths = (model.text_encoder.text_cfg.hidden_size, model.audio_encoder.model.cfg.hidden_size,
              model.video_encoder.vit.cfg.hidden_size)
    if widths != (384, 384, 384) or (dev.type == "cuda" and model.dtype != torch.bfloat16):
        raise AssertionError(f"half: widths {widths}, dtype {model.dtype}")
    rng = np.random.default_rng(10)
    b = _train_batch(rng, cfg, dev)
    with torch.inference_mode():
        model(b["text"], b["audio"], b["video"])  # warm-up
        sync()
        hopper.reset_launch_counts()
        out = model(b["text"], b["audio"], b["video"])
        sync()
        counts = hopper.launch_counts()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            model(b["text"], b["audio"], b["video"])
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
    _check_probs(out["emotion_probs"], "half B=8 forward")
    log(f"half: one B={B} forward launched {counts}; median {median(times):.1f} ms = "
        f"{B / median(times) * 1e3:.2f} clips/s (host clock, inputs on the device; {smi_line()})")
    _expect("half forward", counts, HALF_FORWARD_LAUNCHES)
    opt = make_optimizer(cfg, model, total_steps=100)
    step = make_train_step(model, opt, cfg, augment=True, compute_contrastive_loss=True)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state, _ = step(TrainState.create(0), _train_batch(rng, cfg, dev))  # warm-up
    sync()
    torch.cuda.reset_peak_memory_stats()
    batches = [(_train_batch(rng, cfg, dev),) for _ in range(FAMILY_STEPS)]
    state, times = _train_steps("half train", step, state, batches, HALF_TRAIN_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    still = _still(model, before, [n for n in before if not n.startswith(UNUSED)])
    if still:
        raise AssertionError(f"half train: {len(still)} parameters did not move, e.g. {still[:5]}")
    log(f"half train: B={B} {model.dtype}, dropout and augmentation on: median "
        f"{median(times):.1f} ms/step over {FAMILY_STEPS} steps after one to warm up (host "
        f"clock, batches on the device), peak device memory {peak / 2**30:.2f} GiB; "
        f"{smi_line()}")


def phase_families_f32(dev, tmp: str):
    """Phase 16: f32 in context, card (kernels, TF32 off) against CPU (plain
    versions), same weights: a base-width few-shot episode's loss (n_way 2,
    n_shot 1, a query of 2; dropout off) within 1e-4 relative and the
    gradients of the prompt, the adapters and the prototype network each
    within 1e-3 of its largest magnitude; a half-preset B=1 forward at
    atol=rtol=1e-3."""
    import numpy as np
    import torch

    from simple_multimodal_tpu_torch.models.multimodal_model import create_model
    from simple_multimodal_tpu_torch.train.losses import cross_entropy
    from simple_multimodal_tpu_torch.train.optim import freeze, is_trainable_name

    set_tf32(False)
    f32, cpu = torch.float32, torch.device("cpu")
    cfg = _base_config(tmp)
    rng = np.random.default_rng(11)
    support = _train_batch(rng, cfg, cpu, 2, labels=[0, 1])
    query = _train_batch(rng, cfg, cpu, 2, labels=[1, 0])
    res = {}
    for where in ("card", "cpu"):
        d = dev if where == "card" else cpu
        m = create_model(cfg, "few_shot", device=d, dtype=f32,
                         generator=torch.Generator().manual_seed(1))
        freeze(m, lambda n: not is_trainable_name(n))  # the episode's freeze
        t0 = time.perf_counter()
        out = m(_to(support, d), _to(query, d), 2, 1)
        loss = cross_entropy(out["predictions"], query["emotion"].to(d))
        loss.backward()
        sync()
        res[where] = (float(loss.detach()), {n: p.grad.detach().cpu()
                                             for n, p in m.named_parameters() if p.requires_grad})
        log(f"f32 few-shot episode: {where} forward+backward {time.perf_counter() - t0:.2f} s, "
            f"loss {res[where][0]:.6f}")
        del m, out, loss
    (l_card, g_card), (l_cpu, g_cpu) = res["card"], res["cpu"]
    rows = sorted(((float((g_card[n] - w).abs().max()) / max(float(w.abs().max()), 1e-30), n)
                   for n, w in g_cpu.items()), reverse=True)
    rel = abs(l_card - l_cpu) / abs(l_cpu)
    log(f"f32 few-shot episode: loss rel err {rel:.3e}; worst gradients "
        + ", ".join(f"{n} {r:.3e}" for r, n in rows[:3]) + f" of their max magnitude, "
        f"{len(g_cpu)} tensors")
    if rel > 1e-4 or rows[0][0] > 1e-3 or not any("prompt" in n for n in g_cpu):
        raise AssertionError(f"f32 few-shot episode: loss {l_card} vs {l_cpu}, worst gradient "
                             f"{rows[0]}")

    cfg.encoder_preset = "half"
    b = _train_batch(rng, cfg, cpu, 1)
    outs = {}
    for where in ("card", "cpu"):
        d = dev if where == "card" else cpu
        m = create_model(cfg, device=d, dtype=f32, generator=torch.Generator().manual_seed(2))
        with torch.inference_mode():
            o = m(_to(b["text"], d), b["audio"].to(d), b["video"].to(d))
            outs[where] = {k: v.float().cpu() for k, v in o.items()
                           if isinstance(v, torch.Tensor)}
        sync()
        del m
    for k in ("emotion_logits", "valence", "arousal", "text_features", "audio_features",
              "video_features"):
        a, w = outs["card"][k], outs["cpu"][k]
        err = float((a - w).abs().max())
        log(f"f32 half B=1: {k:16s} max_abs_err={err:.3e} (atol=rtol={ATOL_F32:g})")
        if not torch.allclose(a, w, atol=ATOL_F32, rtol=ATOL_F32):
            raise AssertionError(f"f32 half B=1: {k} card vs CPU differ by {err:.3e}")


FILES_PER_EMOTION = 6  # 42 clips: 29 train, 6 val, 7 test


def _files(tmp: str):
    """(root, sample set, trained model) of phase 17, which the later
    phases read: ``final_model_hierarchical`` after its resume."""
    root = os.path.join(tmp, "files")
    os.makedirs(root, exist_ok=True)
    return (root, os.path.join(root, "data"),
            os.path.join(root, "ck", "final_model_hierarchical"))


@contextlib.contextmanager
def _in_dir(path: str):
    """Run in ``path``: the CLIs' ModelConfig makes ./data, ./checkpoints
    and ./logs where it is built."""
    cwd = os.getcwd()
    os.makedirs(path, exist_ok=True)
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(cwd)
FILES_TEXT = "I am so happy about my new job!"


def _count_steps(module, record: dict, timed: bool = False):
    """Wrap ``module``'s ``make_train_step`` and ``make_eval_step`` (the
    names its trainer or evaluator calls; those it has) so that every
    step's launch counts are read with the counters set to 0 just before it,
    and a train step's loss is kept (on the device, checked after the run).
    ``timed``: each train step also synchronised and timed on the host
    clock (``record["ms"]``). Returns the patch's undo."""
    from simple_multimodal_tpu_torch.ops import hopper

    kinds = {kind: name for kind, name in (("train", "make_train_step"),
                                           ("eval", "make_eval_step")) if hasattr(module, name)}
    made = {kind: getattr(module, name) for kind, name in kinds.items()}

    def counted(kind, step):
        def run(*args):
            if timed and kind == "train":
                sync()
                t0 = time.perf_counter()
            hopper.reset_launch_counts()
            state_or_out = step(*args)
            record[kind].append(hopper.launch_counts())
            if kind == "train":
                record["losses"].append(state_or_out[1]["total_loss"])
                if timed:
                    sync()
                    record["ms"].append((time.perf_counter() - t0) * 1e3)
            return state_or_out
        return run

    for kind, name in kinds.items():
        setattr(module, name, lambda *a, kind=kind, **k: counted(kind, made[kind](*a, **k)))

    def undo():
        for kind, name in kinds.items():
            setattr(module, name, made[kind])
    return undo


def _run_cli(cli, argv, expect_train: int, expect_eval: int, tag: str,
             train_launches=None, eval_launches=None, record=None, **config_kw):
    """``cli.main(argv)`` in-process (``config_kw`` set on its ModelConfig),
    holding every train step to ``train_launches`` (23/35/12 both ways) and
    every validation or test batch to ``eval_launches`` (23/35/12 forwards,
    no backward); every step's loss finite. ``record`` (with an ``ms``
    list) times each train step. Returns (result, wall seconds)."""
    import math

    import torch

    from simple_multimodal_tpu_torch.train import trainer as trainer_module

    train_launches = train_launches or TRAIN_LAUNCHES
    eval_launches = eval_launches or EXPECTED_LAUNCHES
    record = record if record is not None else {}
    record.update(train=[], eval=[], losses=[])
    undo = _count_steps(trainer_module, record, timed="ms" in record)
    make_config = cli.ModelConfig
    cli.ModelConfig = lambda **kw: make_config(**kw, **config_kw)
    try:
        sync()
        t0 = time.perf_counter()
        result = cli.main(argv)
        sync()
        wall = time.perf_counter() - t0
    finally:
        cli.ModelConfig = make_config
        undo()
    if len(record["train"]) != expect_train or len(record["eval"]) != expect_eval:
        raise AssertionError(f"{tag}: {len(record['train'])} train steps and "
                             f"{len(record['eval'])} eval batches, expected {expect_train} "
                             f"and {expect_eval}")
    for i, counts in enumerate(record["train"]):
        _expect(f"{tag} train step {i}", counts, train_launches)
    for i, counts in enumerate(record["eval"]):
        _expect(f"{tag} eval batch {i}", counts, eval_launches)
    losses = torch.stack([v.float() for v in record["losses"]]).cpu().tolist()
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{tag}: non-finite losses {losses}")
    log(f"{tag}: {expect_train} train steps of {_launch_str(train_launches)} launches, "
        f"{expect_eval} eval batches of {_launch_str(eval_launches)}; losses "
        + " ".join(f"{v:.4f}" for v in losses))
    return result, wall


def _launch_str(counts: dict) -> str:
    return ", ".join(f"{k} {v}" for k, v in counts.items() if v)


def _decode_epoch_seconds(ds_module, data, cfg) -> float:
    """Seconds to read every clip of the three splits once (the sidecar
    cache cold on the first call, warm after)."""
    t0 = time.perf_counter()
    for split in ("train", "val", "test"):
        ds = ds_module.get_dataset("sample", data, split, cfg)
        for i in range(len(ds)):
            ds[i]
    return time.perf_counter() - t0


def phase_train_from_files(dev, tmp: str):
    """Phase 17: the standard training CLI from files at full width. The
    port's generator writes 6 clips per emotion (42: 29 train, 6 val, 7
    test); ``train_advanced_torch.main`` runs ``--mode standard --preset
    base --fusion_type hierarchical --batch_size 8 --epochs 2`` in-process:
    8 train steps of 23/35/12 launches both ways, 2 validations and one
    test pass of 23/35/12 forwards a batch, every loss finite,
    ``best_model/`` and ``final_model_hierarchical/`` with their
    ``meta.json``; ``--resume final_model_hierarchical --epochs 3`` goes on
    at epoch 3 from step 8 to step 12; ``load_pretrained_model`` →
    ``MultimodalEmotionDemo.predict`` from the paths of a WAV and its moving
    clip (an empty file beside its sidecars without OpenCV), bit-equal to
    the same request from the decoded WAV and the clip's frames subsampled
    here (decoded, or as drawn without OpenCV), probabilities
    finite and summing to 1 ± 1e-2; one more epoch with
    ``device_data_cache_mb=0`` through the prefetcher. Printed: the clip
    store and audio decoder, the cold and warm decode seconds of an epoch,
    seconds per epoch and clips/s on the cached and the prefetch paths, the
    peak device memory."""
    import importlib
    import json as _json

    import torch

    from simple_multimodal_tpu_torch.config import ModelConfig
    from simple_multimodal_tpu_torch.data import dataset as ds_module
    from simple_multimodal_tpu_torch.data import native
    from simple_multimodal_tpu_torch.data.audio_io import load_audio_fixed
    from simple_multimodal_tpu_torch.data.sample_data import synth_video
    from simple_multimodal_tpu_torch.data.video_io import has_opencv, load_video_frames
    from simple_multimodal_tpu_torch.models.multimodal_model import load_pretrained_model
    from simple_multimodal_tpu_torch.serving.demo import MultimodalEmotionDemo

    gen_cli = importlib.import_module("create_sample_data_torch")
    cli = importlib.import_module("train_advanced_torch")
    root, data, final = _files(tmp)
    with _in_dir(root):  # the CLI's ModelConfig makes ./logs for its plots
        t0 = time.perf_counter()
        gen_cli.main(["--output_dir", data, "--num_samples", str(FILES_PER_EMOTION)])
        with open(os.path.join(data, "generation_meta.json")) as f:
            store = _json.load(f).get("video_store", "mp4")
        log(f"files: {FILES_PER_EMOTION * 7} clips generated in {time.perf_counter() - t0:.1f} "
            f"s; clip store {store} (OpenCV {'present' if has_opencv() else 'absent'}), audio "
            f"decoder {native.decoder()}")
        cfg = ModelConfig(data_path=data, save_path=os.path.join(root, "ck"),
                          log_path=os.path.join(root, "logs"))
        cold = _decode_epoch_seconds(ds_module, data, cfg)
        warm = _decode_epoch_seconds(ds_module, data, cfg)
        log(f"files: decode of the 42 clips (text, int16 audio, yuv420 video) cold {cold:.2f} s "
            f"(sidecars written), warm {warm:.2f} s (sidecars read); {smi_line()}")

        save = os.path.join(root, "ck")
        argv = ["--mode", "standard", "--preset", "base", "--fusion_type", "hierarchical",
                "--batch_size", str(B), "--data_path", data, "--save_path", save]
        torch.cuda.reset_peak_memory_stats()
        out, wall = _run_cli(cli, argv + ["--epochs", "2"], 8, 3, "files standard")
        trainer = out["trainer"]
        if not trainer.device_cached or trainer.state.step != 8:
            raise AssertionError(f"files: cached={trainer.device_cached} "
                                 f"step={trainer.state.step}")
        for d in (os.path.join(save, "best_model"), final):
            if not os.path.exists(os.path.join(d, "meta.json")):
                raise AssertionError(f"files: {d}/meta.json missing")
        n_train = len(trainer.train_loader.dataset)
        cached_times = list(trainer.epoch_times)
        log(f"files standard (device-cached): epochs {' '.join(f'{t:.2f}' for t in cached_times)} "
            f"s (train + validation), {n_train / cached_times[-1]:.1f} train clips/s in the last; "
            f"run {wall:.1f} s; losses {trainer.train_losses}; val F1 {trainer.val_f1_scores}; "
            f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
            f"{smi_line()}")
        del out, trainer
        torch.cuda.empty_cache()

        out, _ = _run_cli(cli, argv + ["--epochs", "3", "--resume", final], 4, 2,
                          "files resume")
        resumed = out["trainer"]
        if (resumed.start_epoch, resumed.current_epoch, resumed.state.step) != (2, 2, 12):
            raise AssertionError(f"files resume: start epoch {resumed.start_epoch}, epoch "
                                 f"{resumed.current_epoch}, step {resumed.state.step}")
        log("files resume: went on at epoch 3 from step 8 to step 12")
        del out, resumed
        torch.cuda.empty_cache()

        model, mcfg = load_pretrained_model(final, device=dev)
        demo = MultimodalEmotionDemo(model=model, config=mcfg, device=dev)
        # happy_000's disc pulses from frame to frame. The arrays side takes
        # every frame the clip holds (decoded, or as drawn where the clip is
        # an empty file beside its sidecars) and subsamples them itself.
        name = "happy_000.wav"
        wav = os.path.join(data, "audio", name)
        clip = os.path.join(data, "video", name[:-4] + ".mp4")
        w, h = tuple(mcfg.video_frame_size)
        T = mcfg.video_max_frames
        with open(os.path.join(data, "generation_meta.json")) as f:
            drawn = int(_json.load(f)["duration"] * 15)  # synth_video's 15 fps
        if has_opencv():
            every_frame = load_video_frames(clip, drawn, (w, h))
        else:
            every_frame = synth_video("happy", drawn / 15, size=(w, h))
        arrays_clip = every_frame[::max(drawn // T, 1)][:T]
        got = demo.predict(FILES_TEXT, wav, clip)
        want = demo.predict(FILES_TEXT, load_audio_fixed(wav, mcfg.audio_sample_rate,
                                                         mcfg.audio_max_length), arrays_clip)
        if got != want:
            raise AssertionError(f"files serve: from paths {got} != from arrays {want}")
        _check_probs(torch.tensor(list(got["emotion_distribution"].values())), "files serve")
        log(f"files serve: {name} + the path of {'its mp4' if has_opencv() else 'its empty clip '
            '(read from its sidecar)'} → {got['predicted_emotion']} ({got['confidence']:.3f}), "
            f"equal to the request from arrays ({T} of its {drawn} frames at stride "
            f"{max(drawn // T, 1)})")
        del model, demo
        torch.cuda.empty_cache()

        out, _ = _run_cli(cli, argv + ["--epochs", "1", "--save_path",
                                       os.path.join(root, "ck_prefetch")],
                          4, 2, "files prefetch", device_data_cache_mb=0)
        pre = out["trainer"]
        if pre.device_cached:
            raise AssertionError("files prefetch: the data set was cached on the device")
        log(f"files standard (prefetch): epoch {pre.epoch_times[0]:.2f} s (train + validation, "
            f"the first of the run), {n_train / pre.epoch_times[0]:.1f} train clips/s; cached "
            f"path's first epoch {cached_times[0]:.2f} s; {smi_line()}")
        del out, pre


KD_EVAL_LAUNCHES = {**NO_LAUNCHES, **{k: 2 * v for k, v in FORWARD_LAUNCHES.items()}}


def phase_distillation_from_files(dev, tmp: str):
    """Phase 18: ``train_advanced_torch.py --mode distillation
    --teacher_model <phase 17's final_model_hierarchical> --epochs 1`` at
    base width, B=8: 4 train steps, each launching the teacher's and the
    student's forwards (46/70/24) and the student's backwards (23/35/12),
    each timed; a validation and a test batch of both forwards (46/70/24);
    the teacher bit-equal to its checkpoint after the run; the saved
    ``distilled_student_model`` loaded strictly into a standard model with
    the student's config, which serves one request from the paths of a WAV
    and its clip."""
    import importlib

    import torch

    from simple_multimodal_tpu_torch.models.multimodal_model import MultimodalEmotionModel
    from simple_multimodal_tpu_torch.serving.demo import MultimodalEmotionDemo
    from simple_multimodal_tpu_torch.train.checkpoint import restore_params

    cli = importlib.import_module("train_advanced_torch")
    root, data, teacher = _files(tmp)
    with _in_dir(root):
        torch.cuda.reset_peak_memory_stats()
        record = {"ms": []}
        out, wall = _run_cli(cli, ["--mode", "distillation", "--teacher_model", teacher,
                                   "--preset", "base", "--batch_size", str(B), "--epochs", "1",
                                   "--data_path", data, "--save_path", os.path.join(root, "kd")],
                             4, 2, "files distillation", KD_TRAIN_LAUNCHES, KD_EVAL_LAUNCHES,
                             record)
        peak = torch.cuda.max_memory_allocated()
        trainer = out["trainer"]
        saved = restore_params(teacher)
        live = trainer.model.teacher.state_dict()
        moved = [k for k in saved if not torch.equal(live[k].cpu(), saved[k])]
        if set(live) != set(saved) or moved:
            raise AssertionError(f"files distillation: teacher moved or differs: {moved[:5]}")
        student_cfg = trainer.config
        log(f"files distillation: student fusion {student_cfg.fusion_hidden_size}, "
            f"{student_cfg.fusion_num_heads} heads, {student_cfg.fusion_num_layers} layers; "
            f"steps {' '.join(f'{t:.1f}' for t in record['ms'])} ms (synchronised, median "
            f"{median(record['ms'][1:]):.1f} after the first); epoch "
            f"{trainer.epoch_times[0]:.2f} s; run {wall:.1f} s; peak device memory "
            f"{peak / 2**30:.2f} GiB; teacher bit-equal ({len(saved)} tensors); {smi_line()}")
        del out, trainer, live
        torch.cuda.empty_cache()

        student = MultimodalEmotionModel(student_cfg)
        student.load_state_dict(restore_params(os.path.join(root, "kd",
                                                            "distilled_student_model")))
        demo = MultimodalEmotionDemo(model=student, config=student_cfg, device=dev)
        wav, clip = _files_request(data)
        got = demo.predict(FILES_TEXT, wav, clip)
        _check_probs(torch.tensor(list(got["emotion_distribution"].values())),
                     "files distillation serve")
        log(f"files distillation: distilled_student_model loaded strictly into a standard "
            f"model ({sum(p.numel() for p in student.parameters()):,} parameters), serves "
            f"{os.path.basename(wav)} → {got['predicted_emotion']} ({got['confidence']:.3f})")


def _files_request(data: str):
    """The WAV and the moving clip of ``happy_000`` in phase 17's set."""
    return (os.path.join(data, "audio", "happy_000.wav"),
            os.path.join(data, "video", "happy_000.mp4"))


ABLATION_FUSIONS = ("early", "late", "mult", "graph", "contrastive")


def phase_ablation_from_files(dev, tmp: str):
    """Phase 19: ``train_advanced_torch.py --mode ablation --epochs 1`` at
    base width, B=8: five fusions, each 4 train steps of 23/35/12 launches
    both ways and a validation and a test batch of 23/35/12 forwards; a
    finite validation accuracy and F1 for each."""
    import importlib
    import math

    cli = importlib.import_module("train_advanced_torch")
    root, data, _ = _files(tmp)
    with _in_dir(root):
        out, wall = _run_cli(cli, ["--mode", "ablation", "--preset", "base", "--batch_size",
                                   str(B), "--epochs", "1", "--data_path", data,
                                   "--save_path", os.path.join(root, "ablation")],
                             4 * len(ABLATION_FUSIONS), 2 * len(ABLATION_FUSIONS),
                             "files ablation")
    results = out["results"]
    if tuple(results) != ABLATION_FUSIONS or not all(
            math.isfinite(v) for r in results.values() for v in r.values()):
        raise AssertionError(f"files ablation: {results}")
    log(f"files ablation: {len(results)} fusions in {wall:.1f} s: " + "; ".join(
        f"{k} acc {r['val_accuracy']:.3f} F1 {r['val_f1']:.3f}" for k, r in results.items())
        + f"; {smi_line()}")


def phase_all_from_files(dev, tmp: str):
    """Phase 20: ``train_advanced_torch.py --mode all`` at the half preset,
    B=8, ``--epochs 1 --episodes 1 --few_shot_samples 1``: six standard
    fusions (4 train steps and 2 eval batches each), a 7-way 1-shot
    episode, a robust epoch (4 steps) and its seven scenarios (a
    validation batch each), and the ablation (five fusions, 4 + 2 each):
    every train step 11/17/6 both ways and every eval batch 11/17/6
    forwards; ``errors`` empty; every output directory written."""
    import importlib

    cli = importlib.import_module("train_advanced_torch")
    root, data, _ = _files(tmp)
    save = os.path.join(root, "all")
    n_train = 4 * len(cli.ALL_STANDARD_FUSIONS) + 4 + 4 * len(ABLATION_FUSIONS)
    n_eval = 2 * len(cli.ALL_STANDARD_FUSIONS) + 7 + 2 * len(ABLATION_FUSIONS)
    with _in_dir(root):
        out, wall = _run_cli(cli, ["--mode", "all", "--preset", "half", "--batch_size", str(B),
                                   "--epochs", "1", "--episodes", "1", "--few_shot_samples", "1",
                                   "--data_path", data, "--save_path", save],
                             n_train, n_eval, "files all (half)", HALF_TRAIN_LAUNCHES,
                             HALF_FORWARD_LAUNCHES)
    if out["errors"] != {}:
        raise AssertionError(f"files all: errors {out['errors']}")
    expected = [f"final_model_{f}" for f in cli.ALL_STANDARD_FUSIONS] + [
        "robust_model", "best_model"]
    missing = [d for d in expected if not os.path.exists(os.path.join(save, d, "checkpoint.pt"))]
    if missing or not os.path.exists(os.path.join(save, "final_config.json")):
        raise AssertionError(f"files all: missing {missing} or final_config.json")
    log(f"files all (half): errors {{}}, {len(out['results'])} parts "
        f"({', '.join(out['results'])}) in {wall:.1f} s; few-shot {out['results']['few_shot']}; "
        f"{smi_line()}")


def phase_evaluate_from_files(dev, tmp: str):
    """Phase 21: ``evaluate_model_torch.py`` on phase 17's model over the
    test split (7 clips, one batch of 8 launching 23/35/12 forwards and no
    backward): its predictions equal those of the trainer's test pass on
    the same model and split, its accuracy the trainer's
    ``evaluate_test_set``; ``evaluation_report.html`` and
    ``detailed_results.json`` written; the line each plot family printed
    when it was skipped. Printed: the seconds and clips/s of
    ``evaluate_dataset``."""
    import contextlib as _contextlib
    import importlib
    import io

    import numpy as np

    from simple_multimodal_tpu_torch.data.dataset import create_dataloader, get_dataset
    from simple_multimodal_tpu_torch.eval import evaluator as evaluator_module
    from simple_multimodal_tpu_torch.train.trainer import AdvancedTrainer, dedupe_by_sample_id

    cli = importlib.import_module("evaluate_model_torch")
    root, data, final = _files(tmp)
    out_dir = os.path.join(root, "evaluation")
    record = {"train": [], "eval": [], "losses": []}
    timing = {}
    evaluate = evaluator_module.ModelEvaluator.evaluate_dataset

    def timed(self, loader):
        sync()
        t0 = time.perf_counter()
        res = evaluate(self, loader)
        sync()
        timing["s"] = time.perf_counter() - t0
        timing["evaluator"] = self
        return res

    undo = _count_steps(evaluator_module, record)
    evaluator_module.ModelEvaluator.evaluate_dataset = timed
    printed = io.StringIO()
    try:
        with _in_dir(root), _contextlib.redirect_stdout(printed):
            results = cli.main(["--model_path", final, "--data_path", data, "--dataset",
                                "sample", "--split", "test", "--batch_size", str(B),
                                "--output_dir", out_dir])
    finally:
        evaluator_module.ModelEvaluator.evaluate_dataset = evaluate
        undo()
    for line in printed.getvalue().splitlines():
        if "skipped" in line or line.startswith(("Accuracy", "F1-Score (Macro)")):
            log(f"evaluate: {line}")
    if len(record["eval"]) != 1:
        raise AssertionError(f"evaluate: {len(record['eval'])} eval batches, expected 1")
    _expect("evaluate batch 0", record["eval"][0], EXPECTED_LAUNCHES)
    for name in ("evaluation_report.html", "detailed_results.json"):
        if not os.path.exists(os.path.join(out_dir, name)):
            raise AssertionError(f"evaluate: {name} missing")

    ev = timing["evaluator"]
    ds = get_dataset("sample", data, "test", ev.config)
    loader = create_dataloader(ds, batch_size=B, shuffle=False)
    trainer = AdvancedTrainer(ev.model, ev.config, loader, loader, loader)
    preds, _, _, ids, _ = trainer._predict(create_dataloader(ds, batch_size=B, shuffle=False),
                                           trainer.eval_step)
    (preds,) = dedupe_by_sample_id(ids, preds)
    test = trainer.evaluate_test_set()
    if not np.array_equal(preds, results["predictions"]):
        raise AssertionError(f"evaluate: predictions {results['predictions']} != the "
                             f"trainer's {preds}")
    if test["test_accuracy"] != results["metrics"]["accuracy"]:
        raise AssertionError(f"evaluate: accuracy {results['metrics']['accuracy']} != the "
                             f"trainer's {test['test_accuracy']}")
    n = len(results["predictions"])
    log(f"evaluate: {n} test clips, predictions equal to the trainer's test pass, accuracy "
        f"{test['test_accuracy']:.4f} equal to evaluate_test_set; evaluate_dataset "
        f"{timing['s']:.3f} s = {n / timing['s']:.1f} clips/s (one batch of {B}, model "
        f"loaded); report and detailed_results.json written; {smi_line()}")


def phase_web_server(dev, tmp: str):
    """Phase 22: ``demo/serve_torch.py``'s handler over phase 17's model on
    port 0 in a thread; ``POST /api/analyze`` with the paths of ``happy_000``
    (its moving clip) answers the distribution ``predict`` gives on the same
    inputs, bit for bit, each request launching 23/35/12 forwards; then 5
    requests timed on the host clock."""
    import importlib
    import json as _json
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    from simple_multimodal_tpu_torch.ops import hopper

    serve = importlib.import_module("demo.serve_torch")
    root, data, final = _files(tmp)
    demo = serve.load_demo(final, device=dev)
    server = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(demo, media_dir=data))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    body = _json.dumps({"text": FILES_TEXT, "audio_path": "audio/happy_000.wav",
                        "video_path": "video/happy_000.mp4"}).encode()

    def post():
        req = urllib.request.Request(f"http://127.0.0.1:{server.server_address[1]}/api/analyze",
                                     data=body, headers={"Content-Type": "application/json"})
        return _json.loads(urllib.request.urlopen(req, timeout=120).read())

    try:
        post()  # warm-up
        times = []
        for i in range(6):
            hopper.reset_launch_counts()
            t0 = time.perf_counter()
            answer = post()
            times.append((time.perf_counter() - t0) * 1e3)
            _expect(f"web request {i}", hopper.launch_counts(), EXPECTED_LAUNCHES)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    want = demo.predict(FILES_TEXT, *_files_request(data))
    got = answer["emotion_analysis"]
    if got["emotion_distribution"] != want["emotion_distribution"]:
        raise AssertionError(f"web: {got['emotion_distribution']} != predict's "
                             f"{want['emotion_distribution']}")
    log(f"web: POST /api/analyze (happy_000 by path) → {got['predicted_emotion']} "
        f"({got['confidence']:.3f}), equal to predict bit for bit; 23/35/12 a request; "
        f"latency {' '.join(f'{t:.1f}' for t in times[1:])} ms (median "
        f"{median(times[1:]):.1f}; host clock, decode included); {smi_line()}")


def _hf_backbones():
    """DeBERTa-v3-base, wav2vec2-base and ViT-B/16 as ``transformers``
    builds them from a local config (random weights, no download), or None
    where ``transformers`` is missing."""
    try:
        import transformers
    except ImportError:
        return None
    text = transformers.DebertaV2Model(transformers.DebertaV2Config(
        vocab_size=128100, hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
        intermediate_size=3072, max_position_embeddings=512, relative_attention=True,
        position_buckets=256, norm_rel_ebd="layer_norm", share_att_key=True,
        pos_att_type=["p2c", "c2p"], layer_norm_eps=1e-7, position_biased_input=False))
    audio = transformers.Wav2Vec2Model(transformers.Wav2Vec2Config(
        hidden_size=768, num_hidden_layers=12, num_attention_heads=12, intermediate_size=3072,
        conv_dim=(512,) * 7, conv_kernel=(10, 3, 3, 3, 3, 2, 2), conv_stride=(5, 2, 2, 2, 2, 2, 2),
        num_feat_extract_layers=7, num_conv_pos_embeddings=128,
        num_conv_pos_embedding_groups=16, do_stable_layer_norm=False,
        feat_extract_norm="group", apply_spec_augment=False))
    video = transformers.ViTModel(transformers.ViTConfig(
        image_size=224, patch_size=16, hidden_size=768, num_hidden_layers=12,
        num_attention_heads=12, intermediate_size=3072), add_pooling_layer=False)
    return transformers.__version__, text, audio, video


def phase_weights_io(dev, tmp: str):
    """Phase 23: phase 17's three backbones written as HF-named safetensors
    (``deberta.``, ``wav2vec2.``, ``vit.`` prefixes) by the port's writer,
    imported into a fresh model by ``tools/import_hf_backbones_torch.py``:
    its state dict bit-equal to the same fresh model given those backbones
    directly, and one request served from each bit-equal. Where
    ``transformers`` imports, DeBERTa-v3-base, wav2vec2-base and ViT-B/16
    built by it (random weights) are saved, imported, and their f32 hidden
    states on the card held against the port's f32 encoders at
    atol=rtol=1e-3 (TF32 off)."""
    import importlib

    import torch

    from simple_multimodal_tpu_torch.models.multimodal_model import (create_model,
                                                                     load_pretrained_model)
    from simple_multimodal_tpu_torch.models.safetensors_io import (load_pretrained_backbones,
                                                                   save_safetensors)
    from simple_multimodal_tpu_torch.serving.demo import MultimodalEmotionDemo
    from simple_multimodal_tpu_torch.train.checkpoint import restore_params

    tool = importlib.import_module("tools.import_hf_backbones_torch")
    root, data, final = _files(tmp)
    wdir = os.path.join(root, "weights")
    os.makedirs(wdir, exist_ok=True)
    served, cfg = load_pretrained_model(final, device=dev)
    parts = {"text": ("deberta.", served.text_encoder.model),
             "audio": ("wav2vec2.", served.audio_encoder.model),
             "video": ("vit.", served.video_encoder.vit)}
    t0 = time.perf_counter()
    files = {}
    for name, (prefix, module) in parts.items():
        files[name] = os.path.join(wdir, f"{name}.safetensors")
        save_safetensors({prefix + k: v for k, v in module.state_dict().items()}, files[name])
    written = time.perf_counter() - t0
    with _in_dir(root):
        t0 = time.perf_counter()
        out = tool.main(["--text", files["text"], "--audio", files["audio"], "--video",
                         files["video"], "--output", os.path.join(wdir, "imported"), "--preset",
                         "base", "--fusion_type", "hierarchical", "--seed", "7"])
        imported_s = time.perf_counter() - t0
        expected = create_model(cfg, device=dev, generator=torch.Generator().manual_seed(7))
    for name, (_, module) in parts.items():
        target = {"text": expected.text_encoder.model, "audio": expected.audio_encoder.model,
                  "video": expected.video_encoder.vit}[name]
        target.load_state_dict(module.state_dict())
    got = restore_params(out)
    want = expected.state_dict()
    differ = [k for k in want if not torch.equal(got[k], want[k].cpu())]
    if set(got) != set(want) or differ:
        raise AssertionError(f"weights: imported state differs: {differ[:5]}")
    wav, clip = _files_request(data)
    a = MultimodalEmotionDemo(checkpoint_path=out, device=dev).predict(FILES_TEXT, wav, clip)
    b = MultimodalEmotionDemo(model=expected, config=cfg, device=dev).predict(FILES_TEXT, wav,
                                                                             clip)
    if a != b:
        raise AssertionError(f"weights: served {a} != {b}")
    sizes = sum(os.path.getsize(f) for f in files.values())
    log(f"weights: three backbones written as safetensors ({sizes / 1e6:.0f} MB) in "
        f"{written:.1f} s, imported by tools/import_hf_backbones_torch.py in {imported_s:.1f} s; "
        f"{len(got)} tensors and one served request bit-equal")
    del served, expected
    torch.cuda.empty_cache()

    hf = _hf_backbones()
    if hf is None:
        log("weights: transformers is not installed: the transformers comparison is skipped")
        return
    version, text, audio, video = hf
    hf_files = {}
    for name, module in (("text", text), ("audio", audio), ("video", video)):
        hf_files[name] = os.path.join(wdir, f"hf_{name}.safetensors")
        save_safetensors(module.state_dict(), hf_files[name])
    port = create_model(cfg, device=dev, dtype=torch.float32)
    load_pretrained_backbones(port, **hf_files)
    g = torch.Generator().manual_seed(11)
    S, valid = cfg.text_max_length, cfg.text_max_length * 3 // 5
    ids = torch.randint(1, 128000, (2, S), generator=g).to(dev)
    mask = torch.ones(2, S, dtype=torch.long, device=dev)
    mask[1, valid:] = 0
    wave = (torch.randn(2, cfg.audio_max_length, generator=g) * 0.1).to(dev)
    frames = torch.rand(4, *cfg.video_frame_size, 3, generator=g).to(dev)
    with torch.no_grad():
        text, audio, video = text.to(dev).eval(), audio.to(dev).eval(), video.to(dev).eval()
        pairs = {
            "DeBERTa": (port.text_encoder.model(ids, mask, torch.float32),
                        text(input_ids=ids, attention_mask=mask).last_hidden_state),
            "wav2vec2": (port.audio_encoder.model(wave, torch.float32),
                         audio(wave).last_hidden_state),
            "ViT": (port.video_encoder.vit(frames, torch.float32),
                    video(pixel_values=frames.permute(0, 3, 1, 2)).last_hidden_state),
        }
    for name, (mine, theirs) in pairs.items():
        if name == "DeBERTa":  # the padded row's masked positions are not compared
            mine = torch.cat([mine[0], mine[1, :valid]])
            theirs = torch.cat([theirs[0], theirs[1, :valid]])
        err = float((mine - theirs).abs().max())
        log(f"weights: transformers {version} {name} {tuple(theirs.shape)} f32 hidden states: "
            f"max_abs_err={err:.3e} (atol=rtol={ATOL_F32:g}, max |want| "
            f"{float(theirs.abs().max()):.3f})")
        if not torch.allclose(mine, theirs, atol=ATOL_F32, rtol=ATOL_F32):
            raise AssertionError(f"weights: {name} differs from transformers by {err:.3e}")
    del port, text, audio, video, pairs
    torch.cuda.empty_cache()


# --------------------------------------------------------------- data parallel

DP_STEPS = 2
DP_TIMEOUT_S = 600  # each world's ranks, start to exit
DP_WORLD_MAX = 4
# f32: the CPU test's bounds (tests/test_torch_parallel.py), loss and gradient
# norm 1e-5 relative and every element within 1e-4 of its tensor's largest
# magnitude, but for DP_F32_STRAYS_PER_TENSOR elements a tensor and
# DP_F32_STRAYS in all: Adam divides each gradient element by its own
# magnitude, so an element whose gradient is rounding noise moves by the
# noise's sign (7 and 11 of 411M elements on an H100 at world 2 and 4).
# bf16: each rank's products round partial sums over its own rows, and
# cuBLAS and cuDNN pick their algorithms by the row count, so the runs part
# by bf16 rounding (on an H100 at world 2, the first step: loss 3e-5 apart,
# gradient norm 2e-3); Adam then moves every element whose gradient is
# rounding noise by the noise's sign, and the second step parts further
# (loss 2e-4, gradient norm 4e-3 to 1.3e-2, ~1M elements beyond the f32
# bound, each tensor's change |Δ - Δ₁| / |Δ₁| 0.19 at the median and up to
# 1.03 against world 1's Δ₁). So bf16 holds the loss and the gradient norm
# of the first step ("steps": 1), where both runs start from the same
# parameters, and the probabilities after both steps; the parameters'
# distances are printed, not bounded.
DP_BOUNDS = {
    "f32": {"loss": 1e-5, "grad_norm": 1e-5, "steps": DP_STEPS, "strays": True,
            "probs": 1e-5, "predictions": True},
    # probabilities softmaxed in bf16 (an ulp is 2^-8 near 1) after two steps
    # of slightly different updates
    "bf16": {"loss": 2.0 ** -8, "grad_norm": 2.0 ** -6, "steps": 1, "strays": False,
             "probs": 2.0 ** -5, "predictions": False},
}
DP_F32_STRAYS_PER_TENSOR = 8
DP_F32_STRAYS = 32
DP_FILES_STEPS, DP_FILES_EVALS = 4, 2  # phase 17's files, --epochs 1: 29 train clips at B=8


def _dp_model(cfg, dev):
    """The base hierarchical model from seed 0 (bf16 compute), kept in eval
    mode under the train step's ``model.train()`` (dropout off, gradients
    on), so that world d and world 1 compute the same function."""
    import torch

    from simple_multimodal_tpu_torch.models.multimodal_model import create_model

    model = create_model(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    if model.dtype != torch.bfloat16:
        raise AssertionError(f"base model on cuda should compute in bf16, got {model.dtype}")
    model.eval()
    model.train = lambda mode=True: model
    return model


def _dp_batch(cfg, dev):
    """The phase's global batch of B clips (the same on every rank)."""
    import numpy as np

    return _train_batch(np.random.default_rng(13), cfg, dev)


def _dp_run(model, cfg, batch, mesh, tag, steps=DP_STEPS, validate=True):
    """``steps`` train steps (augmentation and dropout off, the contrastive
    loss on) on this rank's rows of ``batch`` and (``validate``) one
    validation batch through the mesh's path under ``mesh`` (None: one
    process, no mesh), in the model's compute dtype: the eval step's
    predictions, probabilities and loss gathered or averaged over the data
    shards as the trainer's ``_predict`` does. Under a model axis the model
    comes sharded (``shard_module``, every rank from the same seed); else it
    is broadcast from rank 0 here. Every step and the validation batch with
    the counters set to 0 just before and read just after. Returns a dict:
    per-step metrics, the whole parameters after the steps (host), the
    digest of this rank's replicated parameters after each step (model axis
    only), the validation outputs, host ms per step, peak device GiB."""
    import torch

    from simple_multimodal_tpu_torch.ops import hopper
    from simple_multimodal_tpu_torch.parallel.mesh import replicated
    from simple_multimodal_tpu_torch.parallel.tensor import gather_state_dict, placement
    from simple_multimodal_tpu_torch.train.optim import make_optimizer
    from simple_multimodal_tpu_torch.train.state import TrainState
    from simple_multimodal_tpu_torch.train.steps import make_eval_step, make_train_step

    sharded = mesh is not None and mesh.model > 1
    if mesh is not None:
        if not sharded:
            replicated(model, mesh)
        rows = mesh.rows(B)
        batch = {k: ({kk: vv[rows] for kk, vv in v.items()} if isinstance(v, dict)
                     else v[rows]) for k, v in batch.items()}
    opt = make_optimizer(cfg, model, total_steps=100)
    step = make_train_step(model, opt, cfg, augment=False, compute_contrastive_loss=True,
                           mesh=mesh)
    state = TrainState.create(0)
    metrics, times, digests = [], [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(steps):
        sync()
        hopper.reset_launch_counts()
        t0 = time.perf_counter()
        state, parts = step(state, batch)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
        _expect(f"{tag} step {i}", hopper.launch_counts(), TRAIN_LAUNCHES)
        metrics.append({k: float(v) for k, v in parts.items()})
        if sharded:
            digests.append(_param_digest({n: p.detach().cpu() for n, p in model.named_parameters()
                                          if placement(p) is None}))
    run = {"metrics": metrics, "ms": times, "digests": digests,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "params": {n: p.detach().cpu() for n, p in gather_state_dict(
               dict(model.named_parameters()), mesh).items()}}
    if not validate:
        return run
    hopper.reset_launch_counts()
    out = make_eval_step(model)(batch)
    gather = (lambda t: t) if mesh is None else mesh.gather
    loss = out["loss"].float().reshape(1)
    if mesh is not None:
        mesh.all_reduce_mean_([loss])
        mesh.barrier()  # where the trainer's rank-0 writes wait
    run["val"] = {"predictions": gather(out["predictions"]).cpu(),
                  "probs": gather(out["probs"].float()).cpu(), "loss": loss.cpu()}
    sync()
    _expect(f"{tag} validation batch", hopper.launch_counts(), EXPECTED_LAUNCHES)
    return run


def _dp_faults(run, ref, init, bounds, travel):
    """(faults, information) of a data-parallel run against the
    one-process run ``ref``, both from the parameters ``init``, under
    ``bounds`` (a DP_BOUNDS entry): the loss and gradient norm of the first
    ``steps`` steps within their relative bounds; with ``strays`` every element within 1e-4
    of its tensor's largest magnitude, or of twice the summed learning rate
    ``travel`` where that is larger (a zero-initialised tensor's only
    scale), attention key biases (a zero gradient in exact arithmetic,
    which Adam steps by the sign of its rounding noise) within twice the
    travel, but for DP_F32_STRAYS_PER_TENSOR elements a tensor and
    DP_F32_STRAYS in all; the validation probabilities within their bound
    and, where the bounds ask, equal predictions. Printed besides: each
    tensor's change over the steps, its distance from the reference's
    change relative to the latter (key biases left out)."""
    import math

    import torch

    faults, worst = [], {}
    for i, (m, r) in enumerate(zip(run["metrics"], ref["metrics"])):
        for k, key in (("total_loss", "loss"), ("grad_norm", "grad_norm")):
            rel = abs(m[k] - r[k]) / abs(r[k])
            worst[key] = max(worst.get(key, 0.0), rel)
            if rel > bounds[key] and i < bounds["steps"]:
                faults.append(f"step {i} {k} {m[k]!r} vs {r[k]!r}")
    strays, updates, total = {}, {}, 0
    for name, want in ref["params"].items():
        got, start = run["params"][name], init[name].cpu()
        pieces = [(name, got, want, start, name.endswith(("key.bias", "k_proj.bias")))]
        if name.endswith("in_proj_bias"):
            E = want.shape[0] // 3
            pieces = [(f"{name}[{p}]", got[i * E:(i + 1) * E], want[i * E:(i + 1) * E],
                       start[i * E:(i + 1) * E], p == "k") for i, p in enumerate("qkv")]
        for label, x, y, z, key_bias in pieces:
            diff = (x - y).abs()
            tol = (2 * travel if key_bias
                   else min(1e-4 * max(float(y.abs().max()), 2 * travel), 1e-4))
            n = int((diff > tol).sum())
            total += diff.numel()
            if n:
                strays[label] = n
            if not key_bias:
                moved, off = float((y - z).norm()), float(diff.norm())
                updates[label] = off / moved if moved else (0.0 if off == 0 else math.inf)
    if bounds["strays"]:
        many = {k: v for k, v in strays.items() if v > DP_F32_STRAYS_PER_TENSOR}
        if many:
            faults.append(f"more than {DP_F32_STRAYS_PER_TENSOR} elements beyond the f32 "
                          f"bound in {dict(list(many.items())[:5])} ({len(many)} tensors)")
        if sum(strays.values()) > DP_F32_STRAYS:
            faults.append(f"{sum(strays.values())} elements beyond the f32 bound, "
                          f"more than {DP_F32_STRAYS}")
    order = sorted(updates.items(), key=lambda kv: -kv[1])
    probs_err, same_predictions = None, None
    if "val" in run:
        probs_err = float((run["val"]["probs"] - ref["val"]["probs"]).abs().max())
        same_predictions = torch.equal(run["val"]["predictions"], ref["val"]["predictions"])
        if probs_err > bounds["probs"]:
            faults.append(f"validation probabilities {probs_err:.3e} apart")
        if bounds["predictions"] and not same_predictions:
            faults.append("validation predictions differ")
    info = {"loss_rel": worst["loss"], "grad_norm_rel": worst["grad_norm"],
            "first_step": {k: abs(run["metrics"][0][k] - ref["metrics"][0][k])
                           / abs(ref["metrics"][0][k]) for k in ("total_loss", "grad_norm")},
            "elements_beyond_f32_bound": f"{sum(strays.values())} of {total} in "
                                         f"{len(strays)} tensors, at most "
                                         f"{max(strays.values(), default=0)} in one",
            "update_rel": {"median": median([v for _, v in order]), "largest": order[:3]},
            "probs_err": probs_err, "predictions_equal": same_predictions}
    return faults, info


def _param_digest(params) -> str:
    import hashlib

    h = hashlib.sha256()
    for name in sorted(params):
        h.update(params[name].numpy().tobytes())
    return h.hexdigest()


def _dp_files(tmp: str) -> str:
    """Phase 17's sample set (generated and decoded once here when this
    phase runs alone), so that the ranks only read its sidecars."""
    import importlib

    from simple_multimodal_tpu_torch.config import ModelConfig
    from simple_multimodal_tpu_torch.data import dataset as ds_module

    root, data, _ = _files(tmp)
    if not os.path.exists(os.path.join(data, "generation_meta.json")):
        with _in_dir(root):
            importlib.import_module("create_sample_data_torch").main(
                ["--output_dir", data, "--num_samples", str(FILES_PER_EMOTION)])
            _decode_epoch_seconds(ds_module, data, ModelConfig(
                data_path=data, save_path=os.path.join(root, "ck"),
                log_path=os.path.join(root, "logs")))
    return data


def _dp_cli(spec: dict, rank: int) -> dict:
    """The user's entry point on this rank: ``train_advanced_torch.main``
    with ``--mode standard --preset base --fusion_type hierarchical
    --batch_size 8 --epochs 1 --mesh D,M`` on phase 17's files, every train
    step and eval batch held to its launches (``_run_cli``), the set cached
    on the card under the mesh (``DeviceCachedLoader(mesh=)``), the
    checkpoint writes recorded. Under a model axis also the trained model's
    logits of the phase's batch (the global batch's, gathered over the data
    shards), which the parent holds against the saved model in one process."""
    import importlib

    import torch

    from simple_multimodal_tpu_torch.parallel.tensor import gather_state_dict
    from simple_multimodal_tpu_torch.train import checkpoint
    from simple_multimodal_tpu_torch.train import trainer as trainer_module
    from simple_multimodal_tpu_torch.train.steps import make_eval_step

    cli = importlib.import_module("train_advanced_torch")
    world, m, writes = spec["world"], spec.get("model", 1), []
    d = world // m
    saved = checkpoint.save_checkpoint

    def recorded(path, *a, **kw):
        writes.append(os.path.basename(str(path)))
        return saved(path, *a, **kw)

    checkpoint.save_checkpoint = trainer_module.save_checkpoint = recorded
    argv = ["--mode", "standard", "--preset", "base", "--fusion_type", "hierarchical",
            "--batch_size", str(B), "--epochs", "1", "--mesh", f"{d},{m}",
            "--data_path", spec["data"], "--save_path", os.path.join(spec["out"], "ck")]
    record = {"ms": []}
    torch.cuda.reset_peak_memory_stats()
    try:
        with _in_dir(os.path.join(spec["out"], "cwd")):
            out, wall = _run_cli(cli, argv, DP_FILES_STEPS, DP_FILES_EVALS,
                                 f"mesh ({d}, {m}) CLI rank {rank}", record=record)
    finally:
        checkpoint.save_checkpoint = trainer_module.save_checkpoint = saved
    t = out["trainer"]
    if not t.device_cached or t.mesh.shape != {"data": d, "model": m} \
            or t.state.step != DP_FILES_STEPS:
        raise AssertionError(f"mesh ({d}, {m}) CLI rank {rank}: cached={t.device_cached} mesh="
                             f"{t.mesh.shape} step={t.state.step}")
    launches = {}
    for counts in record["train"] + record["eval"]:
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    whole = gather_state_dict(dict(t.model.named_parameters()), t.mesh)
    result = {"writes": writes, "launches": launches, "ms": record["ms"], "wall_s": wall,
              "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
              "train_losses": t.train_losses, "val_losses": t.val_losses,
              "val_f1": t.val_f1_scores, "val_accuracy": t.val_accuracies,
              "digest": _param_digest({n: p.detach().cpu() for n, p in whole.items()}),
              "path": out["path"]}
    if m > 1:
        batch = _dp_batch(t.config, t.device)
        batch = {k: ({kk: vv[t.mesh.rows(B)] for kk, vv in v.items()} if isinstance(v, dict)
                     else v[t.mesh.rows(B)]) for k, v in batch.items()}
        result["logits"] = t.mesh.gather(make_eval_step(t.model)(batch)["logits"]).float() \
            .cpu().tolist()
    return result


def _dp_rank(spec: dict) -> None:
    """One rank of the phase's world ``spec["world"]``, started as torchrun
    starts a rank (RANK, WORLD_SIZE, LOCAL_RANK and the rendezvous address
    in the environment): by torchrun over NCCL, a card a rank, or (backend
    "gloo") by the phase as two one-card nodes that share cuda:0, which
    NCCL refuses. Joins the group through ``initialize_distributed``; runs
    ``_dp_run`` on its rows in bf16, in bf16 with the contrastive term
    rank-local (the planted fault: the bounds must see it) and in f32, each
    from the seed-0 parameters and held to the parent's one-process runs
    (``ref``); then ``_dp_cli``. Writes a JSON summary. A spec with a model
    axis (phase 25) runs ``_tp_rank`` instead."""
    import torch

    from simple_multimodal_tpu_torch.models import fusion
    from simple_multimodal_tpu_torch.parallel.mesh import (initialize_distributed,
                                                           local_device, make_mesh,
                                                           shutdown_distributed)

    if spec.get("model", 1) > 1:
        return _tp_rank(spec)
    rank = int(os.environ["RANK"])
    out_path = os.path.join(spec["out"], f"rank{rank}.json")
    try:
        dev = local_device("cuda")
        torch.cuda.set_device(dev)
        set_tf32(False)
        initialize_distributed(backend=spec["backend"])
        try:
            cfg = _base_config(spec["tmp"])
            model = _dp_model(cfg, dev)
            init = {k: v.detach().clone() for k, v in model.state_dict().items()}
            batch = _dp_batch(cfg, dev)
            mesh = make_mesh((spec["world"], 1), dev)
            ref = torch.load(spec["ref"], weights_only=False, mmap=True)
            summary = {"rank": rank, "device": str(dev)}
            gather = fusion.gather_rows
            torch.backends.cudnn.deterministic = True  # as the references ran
            for run_name, dtype in (("bf16", "bf16"), ("bf16 rank-local InfoNCE", "bf16"),
                                    ("f32", "f32")):
                model.load_state_dict(init)
                model.dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[dtype]
                tag = f"data parallel world {spec['world']} rank {rank} {run_name}"
                if "InfoNCE" in run_name:
                    fusion.gather_rows = lambda x: x  # each rank's own negatives only
                try:
                    run = _dp_run(model, cfg, batch, mesh, tag)
                finally:
                    fusion.gather_rows = gather
                faults, info = _dp_faults(run, ref[dtype], init, DP_BOUNDS[dtype], ref["travel"])
                summary[run_name] = {"metrics": run["metrics"], "ms": run["ms"],
                                     "peak_gib": run["peak_gib"], "faults": faults,
                                     "info": info, "digest": _param_digest(run["params"])}
                del run
            del model, init, batch, ref
            torch.cuda.empty_cache()
            torch.backends.cudnn.deterministic = False  # the CLI as users run it
            summary["cli"] = _dp_cli(spec, rank)
        finally:
            shutdown_distributed()
        with open(out_path, "w") as f:
            json.dump(summary, f)
    except BaseException:
        with open(out_path + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise


def _dp_spawned(rank: int, env: dict, spec: dict) -> None:
    os.environ.update(env, RANK=str(rank))
    _dp_rank(spec)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


SCRATCH_FREE_BYTES = 64 * 2 ** 30  # RAM the mesh phases' transient files may take


@contextlib.contextmanager
def _scratch(tmp: str):
    """A directory for a mesh phase's large transient files (the references
    its ranks read, the checkpoints of their CLI runs: ~10 GB a phase that
    no later phase reads), removed when the phase ends: in RAM (/dev/shm)
    where it has SCRATCH_FREE_BYTES free, which keeps them off the disk, else
    under ``tmp``."""
    shm = "/dev/shm"
    ram = os.path.isdir(shm) and shutil.disk_usage(shm).free >= SCRATCH_FREE_BYTES
    path = tempfile.mkdtemp(prefix="chip_smoke_mesh_", dir=shm if ram else tmp)
    try:
        yield path
    finally:
        shutil.rmtree(path, ignore_errors=True)


def _run_dp_world(world: int, backend, tmp: str, ref_path: str, data: str,
                  model: int = 1) -> list:
    """``_dp_rank`` on ``world`` processes at mesh (world / model, model),
    their summaries in rank order: with ``backend`` "gloo" two spawned
    processes on cuda:0 (LOCAL_RANK 0 each, a local rendezvous), else
    ``torchrun --standalone --nproc_per_node=world chip_smoke.py --dp-rank``
    over NCCL, a card a rank. Their outputs (the CLI's checkpoints included)
    go beside ``ref_path``. Every process is joined, or killed at
    DP_TIMEOUT_S."""
    import multiprocessing
    import signal

    out = os.path.join(os.path.dirname(ref_path), f"dp_{backend or 'nccl'}_{world}_{model}")
    os.makedirs(out, exist_ok=True)
    spec = {"world": world, "model": model, "backend": backend, "tmp": tmp, "ref": ref_path,
            "data": data, "out": out}
    outs = [os.path.join(out, f"rank{r}.json") for r in range(world)]
    if backend == "gloo":
        env = {"WORLD_SIZE": str(world), "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1",
               "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port())}
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=_dp_spawned, args=(r, env, spec)) for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + DP_TIMEOUT_S
        try:
            for p in procs:
                p.join(max(deadline - time.monotonic(), 0.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        codes = [p.exitcode for p in procs]
    else:
        launch = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             f"--nproc_per_node={world}", os.path.abspath(__file__), "--dp-rank",
             json.dumps(spec)], cwd=os.path.dirname(os.path.abspath(__file__)),
            start_new_session=True)
        try:
            codes = [launch.wait(timeout=DP_TIMEOUT_S)]
        except subprocess.TimeoutExpired:
            codes = ["timed out"]
        finally:
            if launch.poll() is None:
                os.killpg(launch.pid, signal.SIGKILL)
                launch.wait(10)
    errors = [open(o + ".err").read() for o in outs if os.path.exists(o + ".err")]
    if errors or any(c != 0 for c in codes):
        raise AssertionError(f"mesh ({world // model}, {model}) ({backend or 'nccl'}): exit codes "
                             f"{codes}\n" + "\n".join(errors))
    return [json.load(open(o)) for o in outs]


def _report_dp(results, label):
    """Every rank's runs printed; each faithful run within its bounds of
    world 1 with every rank's parameters bit-identical, the planted fault
    beyond them; the CLI's epoch: launches, losses, validation and
    parameters equal on every rank, rank 0 alone writing. Raises, after
    printing everything, on any failure."""
    errors = []
    for run_name, dtype in (("bf16", "bf16"), ("bf16 rank-local InfoNCE", "bf16"),
                            ("f32", "f32")):
        for r in results:
            run = r[run_name]
            log(f"{label} {run_name} rank {r['rank']} on {r['device']}: "
                + " ".join(f"step {i} {ms:.1f} ms loss={m['total_loss']!r} "
                           f"grad_norm={m['grad_norm']!r}"
                           for i, (ms, m) in enumerate(zip(run["ms"], run["metrics"])))
                + f"; peak {run['peak_gib']:.2f} GiB; against world 1: {run['info']}")
        faults = [f for r in results for f in r[run_name]["faults"]]
        if "InfoNCE" in run_name:
            if all(r[run_name]["faults"] for r in results):
                log(f"{label} {run_name} (planted fault): beyond the bounds "
                    f"{DP_BOUNDS[dtype]} as it must be: {faults[:3]}")
            else:
                errors.append(f"{run_name}: the planted fault is within the bounds "
                              f"{DP_BOUNDS[dtype]}")
        elif faults:
            errors.append(f"{run_name}: {len(faults)} beyond the bounds {DP_BOUNDS[dtype]}, "
                          f"e.g. {faults[:10]}")
        elif len({r[run_name]["digest"] for r in results}) != 1:
            errors.append(f"{run_name}: the ranks' parameters differ")
        else:
            log(f"{label} {run_name}: within the bounds {DP_BOUNDS[dtype]} of world 1; every "
                f"rank's parameters bit-identical (sha256 "
                f"{results[0][run_name]['digest'][:16]})")
    for r in results:
        c = r["cli"]
        log(f"{label} train_advanced_torch --mesh {len(results)},1 rank {r['rank']}: launches "
            f"{_launch_str(c['launches'])}; steps " + " ".join(f"{ms:.1f}" for ms in c["ms"])
            + f" ms; run {c['wall_s']:.1f} s; peak {c['peak_gib']:.2f} GiB; train losses "
            f"{c['train_losses']}; val loss {c['val_losses']} F1 {c['val_f1']}; writes "
            f"{c['writes']}")
    keys = ("launches", "train_losses", "val_losses", "val_f1", "val_accuracy", "digest")
    first = results[0]["cli"]
    differ = sorted({k for r in results[1:] for k in keys if r["cli"][k] != first[k]})
    if differ:
        errors.append(f"CLI: the ranks differ in {differ}")
    elif not {"best_model", "final_model_hierarchical"} <= set(first["writes"]) \
            or any(r["cli"]["writes"] for r in results[1:]):
        errors.append(f"CLI: writes by rank {[r['cli']['writes'] for r in results]}")
    else:
        log(f"{label} CLI: launches, losses, validation and parameters equal on every rank; "
            f"rank 0 alone wrote {first['writes']}")
    if errors:
        raise AssertionError(f"{label}: " + "; ".join(errors))


@contextlib.contextmanager
def _counted_collectives(counts: dict):
    """Count the torch.distributed collectives called inside the block."""
    import torch.distributed as dist

    names = ("all_reduce", "broadcast", "all_gather", "barrier")
    saved = {n: getattr(dist, n) for n in names}

    def counted(name):
        def call(*a, **kw):
            counts[name] = counts.get(name, 0) + 1
            return saved[name](*a, **kw)
        return call

    for n in names:
        setattr(dist, n, counted(n))
    try:
        yield counts
    finally:
        for n, fn in saved.items():
            setattr(dist, n, fn)


def _log_run(label, run):
    log(f"{label}: " + " ".join(
        f"step {i} {ms:.1f} ms loss={m['total_loss']!r} grad_norm={m['grad_norm']!r}"
        for i, (ms, m) in enumerate(zip(run["ms"], run["metrics"])))
        + f"; peak {run['peak_gib']:.2f} GiB")


def phase_data_parallel(dev, tmp: str):
    """Phase 24, data parallelism at base width (hierarchical, B=8, dropout
    and augmentation off, the contrastive loss on): DP_STEPS train steps and
    a validation batch (1) in one process without a process group, in bf16
    and in f32 (TF32 off): the references; (2) in bf16 through the
    data-parallel path over NCCL at world 1 in this process, every
    collective called, bit-equal to (1) (cuDNN deterministic for both);
    (3) at world 2 on this one card (``_dp_rank``: gloo, as NCCL refuses
    two ranks on one device; the kernels run on the card), 4 rows a rank,
    held to (1) within DP_BOUNDS, a planted fault beyond them, then
    ``train_advanced_torch.main --mesh 2,1`` for an epoch on phase 17's
    files; (4) where the machine has two cards or more, the same at world
    min(cards, 4) under torchrun over NCCL, a card a rank."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    from simple_multimodal_tpu_torch.parallel.mesh import make_mesh, set_current_mesh
    from simple_multimodal_tpu_torch.train.optim import make_schedule

    t_phase = time.perf_counter()
    data = _dp_files(tmp)
    cfg = _base_config(tmp)
    model = _dp_model(cfg, dev)
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    batch = _dp_batch(cfg, dev)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # bit-equal runs: no cuDNN algorithm races
    try:
        ref = {"bf16": _dp_run(model, cfg, batch, None, "data parallel: one process bf16")}
        _log_run("data parallel: one process bf16, no process group", ref["bf16"])
        model.load_state_dict(init)
        counts = {}
        dist.init_process_group("nccl", init_method=f"file://{tmp}/nccl_world1",
                                world_size=1, rank=0, timeout=timedelta(seconds=300),
                                device_id=dev)
        try:
            mesh = make_mesh((1, 1), dev)
            with _counted_collectives(counts):
                nccl = _dp_run(model, cfg, batch, mesh, "data parallel: NCCL world 1")
        finally:
            dist.destroy_process_group()
            set_current_mesh(None)
        model.load_state_dict(init)
        model.dtype = torch.float32
        ref["f32"] = _dp_run(model, cfg, batch, None, "data parallel: one process f32")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    _log_run("data parallel: one process f32, no process group", ref["f32"])
    want = ref["bf16"]
    missing = [n for n in ("all_reduce", "broadcast", "all_gather", "barrier")
               if not counts.get(n)]
    differ = [n for n, v in want["params"].items() if not torch.equal(v, nccl["params"][n])]
    differ += [k for k, v in want["val"].items() if not torch.equal(v, nccl["val"][k])]
    same = nccl["metrics"] == want["metrics"] and not differ
    log(f"data parallel: NCCL world 1 in-process bf16, collectives called {counts}: bit-equal "
        f"to the one-process run (metrics, parameters, validation): {same}; "
        + " ".join(f"step {i} {ms:.1f} ms" for i, ms in enumerate(nccl["ms"]))
        + f"; peak {nccl['peak_gib']:.2f} GiB")
    if missing or not same:
        raise AssertionError(f"data parallel NCCL world 1: collectives not called {missing}; "
                             f"differ: {differ[:5]}, metrics {nccl['metrics']} vs "
                             f"{want['metrics']}")
    del model, init, batch, nccl
    torch.cuda.empty_cache()

    schedule = make_schedule(cfg.learning_rate, 100)
    travel = sum(schedule(c) for c in range(DP_STEPS))
    with _scratch(tmp) as scratch:
        ref_path = os.path.join(scratch, "dp_reference.pt")
        torch.save({**{d: {k: r[k] for k in ("metrics", "params", "val")}
                       for d, r in ref.items()}, "travel": travel}, ref_path)
        del ref
        _report_dp(_run_dp_world(2, "gloo", tmp, ref_path, data),
                   "data parallel: world 2 on one card over gloo")
        cards = torch.cuda.device_count()
        if cards >= 2:
            world = min(cards, DP_WORLD_MAX)
            _report_dp(_run_dp_world(world, None, tmp, ref_path, data),
                       f"data parallel: torchrun world {world} over NCCL, one card a rank")
        else:
            log(f"data parallel across cards: not run: {cards} card")
    log(f"data parallel phase in {time.perf_counter() - t_phase:.1f} s; {smi_line()}")


# ------------------------------------------------------------- tensor parallel

TP_MODEL = 2  # the model axis of phase 25: 12 DeBERTa heads, 6 a rank
TP_LOGITS_F32 = 1e-4  # tests/test_multidevice.py::test_tp_matches_replicated
TP_FAULTS = {
    # each gathered weight's gradient summed over the model group: m times the whole
    "bf16 gathered gradients summed": "gather_param_sums",
    # the clip's global norm over this rank's shards alone
    "bf16 clip norm over local shards": "clip_norm_local",
}


@contextlib.contextmanager
def _planted(fault):
    """One of TP_FAULTS planted in the package for the block (None: none)."""
    from simple_multimodal_tpu_torch.parallel import tensor
    from simple_multimodal_tpu_torch.train import optim

    if fault is None:
        yield
        return
    if fault == "gather_param_sums":
        owner, attr = tensor._GatherParam, "backward"

        def bad(ctx, g):
            mesh = ctx.mesh
            whole = tensor.model_sum(g, mesh)
            return tensor.split(whole, ctx.spec, mesh.model, mesh.model_index), None, None

        bad = staticmethod(bad)
    else:
        owner, attr = optim, "global_norm"
        local = optim.global_norm

        def bad(grads, params=None, norms=None):
            return local(grads, norms=norms)

    saved = owner.__dict__[attr]
    setattr(owner, attr, bad)
    try:
        yield
    finally:
        setattr(owner, attr, saved)


def _logits_err(got, want, dtype: str):
    """(error, bound, within) of eval logits against a reference's: in f32
    the logits within TP_LOGITS_F32; in bf16 their probabilities (softmaxed
    in f32) within phase 24's bf16 bound on its validation probabilities,
    DP_BOUNDS["bf16"]["probs"] (the logits' own distance is printed)."""
    import torch

    got, want = torch.as_tensor(got).float(), torch.as_tensor(want).float()
    if dtype == "f32":
        err, bound = float((got - want).abs().max()), TP_LOGITS_F32
    else:
        err = float((got.softmax(-1) - want.softmax(-1)).abs().max())
        bound = DP_BOUNDS["bf16"]["probs"]
    return err, bound, err <= bound, float((got - want).abs().max())


def _tp_rank(spec: dict) -> None:
    """One rank of phase 25's mesh (world / m, m), started as ``_dp_rank``
    is and joined through ``initialize_distributed``: the seed-0 base model
    (the same on every rank) sharded over the model axis; in bf16 and f32
    its eval logits on the phase's batch and ``_dp_run`` on its rows (the
    replicated parameters' digest after each step), then one bf16 step
    under each planted fault (TP_FAULTS), each from the seed-0 parameters
    and held to the parent's one-process runs (``ref``); the collectives
    called; then ``_dp_cli`` at ``--mesh D,M``. Writes a JSON summary."""
    import torch

    from simple_multimodal_tpu_torch.ops import hopper
    from simple_multimodal_tpu_torch.parallel.mesh import (initialize_distributed,
                                                           local_device, make_mesh,
                                                           shutdown_distributed)
    from simple_multimodal_tpu_torch.parallel.tensor import shard_module, shard_state_dict
    from simple_multimodal_tpu_torch.train.steps import make_eval_step

    rank = int(os.environ["RANK"])
    out_path = os.path.join(spec["out"], f"rank{rank}.json")
    world, m = spec["world"], spec["model"]
    try:
        dev = local_device("cuda")
        torch.cuda.set_device(dev)
        set_tf32(False)
        initialize_distributed(backend=spec["backend"])
        try:
            cfg = _base_config(spec["tmp"])
            model = _dp_model(cfg, dev)
            init = {k: v.detach().cpu() for k, v in model.state_dict().items()}
            batch = _dp_batch(cfg, dev)
            mesh = make_mesh((world // m, m), dev)
            shard_module(model, mesh)
            rows = mesh.rows(B)
            local = {k: ({kk: vv[rows] for kk, vv in v.items()} if isinstance(v, dict)
                         else v[rows]) for k, v in batch.items()}
            ref = torch.load(spec["ref"], weights_only=False, mmap=True)
            summary = {"rank": rank, "device": str(dev), "mesh": [world // m, m]}
            counts = {}
            torch.backends.cudnn.deterministic = True  # as the references ran
            runs = [("bf16", "bf16", None, DP_STEPS)]
            runs += [(name, "bf16", fault, 1) for name, fault in TP_FAULTS.items()]
            runs += [("f32", "f32", None, DP_STEPS)]
            with _counted_collectives(counts):
                for run_name, dtype, fault, steps in runs:
                    model.load_state_dict(shard_state_dict(init, mesh))
                    model.dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[dtype]
                    tag = f"mesh ({world // m}, {m}) rank {rank} {run_name}"
                    entry = {}
                    if fault is None:  # eval first, on the seed-0 parameters
                        hopper.reset_launch_counts()
                        logits = mesh.gather(make_eval_step(model)(local)["logits"])
                        sync()
                        _expect(f"{tag} eval", hopper.launch_counts(), EXPECTED_LAUNCHES)
                        entry["logits"] = _logits_err(logits.cpu(), ref[dtype]["logits"], dtype)
                    with _planted(fault):
                        run = _dp_run(model, cfg, batch, mesh, tag, steps=steps,
                                      validate=fault is None)
                    faults, info = _dp_faults(run, ref[dtype], init, DP_BOUNDS[dtype],
                                              ref["travel"])
                    summary[run_name] = dict(entry, metrics=run["metrics"], ms=run["ms"],
                                             peak_gib=run["peak_gib"], faults=faults,
                                             info=info, digests=run["digests"],
                                             digest=_param_digest(run["params"]))
                    del run
            summary["collectives"] = counts
            del model, init, batch, local, ref
            torch.cuda.empty_cache()
            torch.backends.cudnn.deterministic = False  # the CLI as users run it
            summary["cli"] = _dp_cli(spec, rank)
        finally:
            shutdown_distributed()
        with open(out_path, "w") as f:
            json.dump(summary, f)
    except BaseException:
        with open(out_path + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise


def _report_tp(results, label, dev) -> dict:
    """Every rank's runs printed; the eval logits within their bounds of one
    process; each faithful run within DP_BOUNDS of one process, its
    replicated parameters bit-identical on every rank after each step and
    its whole parameters equal on every rank; each planted fault beyond the
    bounds; the CLI's epoch: launches, losses, validation and parameters
    equal on every rank, rank 0 alone writing, and the saved model loaded
    into this process giving the ranks' logits. Raises, after printing
    everything, on any failure. Returns rank 0's faithful bf16 run."""
    import torch

    from simple_multimodal_tpu_torch.models.multimodal_model import load_pretrained_model
    from simple_multimodal_tpu_torch.train.steps import make_eval_step

    errors = []
    for run_name in ("bf16", *TP_FAULTS, "f32"):
        dtype = "f32" if run_name == "f32" else "bf16"
        for r in results:
            run = r[run_name]
            log(f"{label} {run_name} rank {r['rank']} on {r['device']}: "
                + (f"eval logits {run['logits'][3]:.3e} from one process, "
                   f"{'logits' if dtype == 'f32' else 'probabilities'} {run['logits'][0]:.3e} "
                   f"(bound {run['logits'][1]:.3e}); " if "logits" in run else "")
                + " ".join(f"step {i} {ms:.1f} ms loss={m['total_loss']!r} "
                           f"grad_norm={m['grad_norm']!r}"
                           for i, (ms, m) in enumerate(zip(run["ms"], run["metrics"])))
                + f"; peak {run['peak_gib']:.2f} GiB"
                + ("" if run_name in TP_FAULTS else f"; against one process: {run['info']}"))
            if "logits" in run and not run["logits"][2]:
                errors.append(f"{run_name} rank {r['rank']}: eval logits {run['logits'][0]:.3e} "
                              f"beyond {run['logits'][1]:.3e}")
        faults = [f for r in results for f in r[run_name]["faults"]]
        if run_name in TP_FAULTS:
            if all(r[run_name]["faults"] for r in results):
                log(f"{label} {run_name} (planted fault): beyond the bounds "
                    f"{DP_BOUNDS[dtype]} as it must be: {faults[:3]}")
            else:
                errors.append(f"{run_name}: the planted fault is within the bounds "
                              f"{DP_BOUNDS[dtype]}")
        elif faults:
            errors.append(f"{run_name}: {len(faults)} beyond the bounds {DP_BOUNDS[dtype]}, "
                          f"e.g. {faults[:10]}")
        elif len({json.dumps(r[run_name]["digests"]) for r in results}) != 1 \
                or len({r[run_name]["digest"] for r in results}) != 1:
            errors.append(f"{run_name}: the ranks' parameters differ")
        else:
            log(f"{label} {run_name}: within the bounds {DP_BOUNDS[dtype]} of one process; the "
                f"replicated parameters bit-identical on every rank after each step, the whole "
                f"parameters equal (sha256 {results[0][run_name]['digest'][:16]})")
    log(f"{label} collectives called a rank over the runs: "
        + "; ".join(f"rank {r['rank']} {r['collectives']}" for r in results))
    mesh = results[0]["mesh"]
    for r in results:
        c = r["cli"]
        log(f"{label} train_advanced_torch --mesh {mesh[0]},{mesh[1]} rank {r['rank']}: "
            f"launches {_launch_str(c['launches'])}; steps "
            + " ".join(f"{ms:.1f}" for ms in c["ms"])
            + f" ms; run {c['wall_s']:.1f} s; peak {c['peak_gib']:.2f} GiB; train losses "
            f"{c['train_losses']}; val loss {c['val_losses']} F1 {c['val_f1']}; writes "
            f"{c['writes']}")
    keys = ("launches", "train_losses", "val_losses", "val_f1", "val_accuracy", "digest",
            "logits")
    first = results[0]["cli"]
    differ = sorted({k for r in results[1:] for k in keys if r["cli"][k] != first[k]})
    if differ:
        errors.append(f"CLI: the ranks differ in {differ}")
    elif not {"best_model", "final_model_hierarchical"} <= set(first["writes"]) \
            or any(r["cli"]["writes"] for r in results[1:]):
        errors.append(f"CLI: writes by rank {[r['cli']['writes'] for r in results]}")
    else:
        model, cfg = load_pretrained_model(first["path"], device=dev)
        logits = make_eval_step(model)(_dp_batch(cfg, dev))["logits"].float().cpu()
        err, bound, ok, dist_logits = _logits_err(first["logits"], logits, "bf16")
        log(f"{label} CLI: launches, losses, validation and parameters equal on every rank; "
            f"rank 0 alone wrote {first['writes']}; {first['path']} loaded into one process: "
            f"logits {dist_logits:.3e}, probabilities {err:.3e} from the ranks' (bound "
            f"{bound:.3e})")
        if not ok:
            errors.append(f"CLI: the saved model's probabilities {err:.3e} from the ranks' "
                          f"(bound {bound:.3e})")
        del model
        torch.cuda.empty_cache()
    if errors:
        raise AssertionError(f"{label}: " + "; ".join(errors))
    return results[0]["bf16"]


def _check_head_split_kernel(dev) -> dict:
    """deberta_attention at the per-rank shape of a model axis of 2 and 4
    ([8, 512, 12/m, 64], bf16, tables [512, 64·12/m]), hash dropout 0.1
    with the seed that ``kernel_seed(model_axis=True)`` gives shard (1, 1)
    of a (2, 2) mesh: forward and forward+backward against the plain version
    on the same inputs and seed (bf16 bounds of phases 2 and 3), with
    CUDA-event medians of both and the bound of the forward. Returns
    {heads: line}."""
    import torch

    from simple_multimodal_tpu_torch.ops import hopper
    from simple_multimodal_tpu_torch.ops.attention import kernel_seed
    from simple_multimodal_tpu_torch.ops.hopper import deberta_attention as da
    from simple_multimodal_tpu_torch.parallel.mesh import Mesh, use_mesh

    g = torch.Generator(device=dev).manual_seed(25)
    with use_mesh(Mesh(data=2, model=2, rank=3)):
        rate, seed = kernel_seed(g, DROP_RATE, True, dev, model_axis=True)
    span, lines = 256, {}
    for m in (2, 4):
        H = 12 // m
        q, k, v = (torch.randn(B, 512, H, 64, generator=g, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        pk, pq = (torch.randn(2 * span, H * 64, generator=g, device=dev).to(torch.bfloat16)
                  for _ in range(2))
        mask = torch.ones(B, 512, dtype=torch.int32, device=dev)
        mask[1, 300:] = 0
        kw = dict(span=span, max_position=512, dropout_rate=rate, dropout_seed=seed)
        ins = [q, k, v, pk, pq]
        gy = torch.randn(q.shape, generator=g, device=dev).to(torch.bfloat16)

        def both(fn, ts):
            ts = [t.detach().clone().requires_grad_() for t in ts]
            out = fn(*ts, mask, **kw)
            return [out] + list(torch.autograd.grad(out, ts, gy.to(out.dtype)))

        hopper.reset_launch_counts()
        got = both(da.deberta_attention, ins)
        want = both(da.deberta_attention_plain, [t.float() for t in ins])
        sync()
        _expect(f"head split m={m}", hopper.launch_counts(),
                dict(NO_LAUNCHES, deberta_attention=1, deberta_attention_bwd=1))
        errs = []
        for i, (a, b) in enumerate(zip(got, want)):
            err = float((a.float() - b).abs().max())
            errs.append(err)
            tol = ATOL_BF16 * (1 + float(b.abs().max())) if i == 0 \
                else GRAD_TOL_BF16 * float(b.abs().max())
            if not err <= tol:
                raise AssertionError(f"head split m={m} [{B},512,{H},64] output {i}: {err:.3e} "
                                     f"beyond {tol:.3e}")
        with torch.no_grad():
            fwd = lambda fn, ts: fn(*ts, mask, **kw)  # noqa: E731
            t_kern = time_ms(lambda: fwd(da.deberta_attention, ins), 20)
            t_plain = time_ms(lambda: fwd(da.deberta_attention_plain, ins), 5)
        t_both = time_ms(lambda: both(da.deberta_attention, ins), 10)
        t_both_plain = time_ms(lambda: both(da.deberta_attention_plain, ins), 3)
        b_fwd = bound("deberta_attention", ins + [mask], got[0])
        b_both = bound("deberta_attention", ins, got[0], backward=True)
        lines[H] = {"max_abs_err": errs[0], "grad_errs": errs[1:],
                    "ms": median(t_kern), "plain_ms": median(t_plain),
                    "fwd_bwd_ms": median(t_both), "plain_fwd_bwd_ms": median(t_both_plain),
                    "fwd_bwd_bound_ms": b_both["bound_ms"], **b_fwd}
        log(f"tensor parallel: deberta_attention head split m={m} [{B},512,{H},64] bf16, "
            f"seed of shard (1, 1) {int(seed)}: forward {errs[0]:.3e}, gradients "
            + ", ".join(f"{e:.3e}" for e in errs[1:])
            + f" from plain (f32 on the same inputs); forward {median(t_kern):.3f} ms "
            f"(plain {median(t_plain):.3f}), fwd+bwd {median(t_both):.3f} ms (plain "
            f"{median(t_both_plain):.3f}); bounds: forward {b_fwd['bound_ms']:.4f} ms "
            f"({b_fwd['bound_by']}), fwd+bwd {b_both['bound_ms']:.4f} ms ({b_both['bound_by']}); "
            f"{smi_line()}")
    return lines


def phase_tensor_parallel(dev, tmp: str):
    """Phase 25, tensor parallelism at base width (hierarchical, B=8,
    dropout and augmentation off, the contrastive loss on): the head-split
    ``deberta_attention`` at its per-rank shapes (``_check_head_split_kernel``);
    the references in one process without a process group, in bf16 and in
    f32 (TF32 off, cuDNN deterministic): eval logits, then ``_dp_run``; the
    mesh (1, 2) on this one card (two ranks over gloo, as phase 24's world
    2, each taking the whole batch), held to them (``_tp_rank``,
    ``_report_tp``); where the machine has four cards or more, the mesh
    (2, 2) under torchrun over NCCL, a card a rank."""
    import torch

    from simple_multimodal_tpu_torch.train.optim import make_schedule
    from simple_multimodal_tpu_torch.train.steps import make_eval_step

    t_phase = time.perf_counter()
    data = _dp_files(tmp)
    t_files = time.perf_counter() - t_phase
    _check_head_split_kernel(dev)
    cfg = _base_config(tmp)
    model = _dp_model(cfg, dev)
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    batch = _dp_batch(cfg, dev)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    ref = {}
    try:
        for dtype in ("bf16", "f32"):
            model.load_state_dict(init)
            model.dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[dtype]
            logits = make_eval_step(model)(batch)["logits"].float().cpu()
            ref[dtype] = _dp_run(model, cfg, batch, None, f"tensor parallel: one process {dtype}")
            ref[dtype]["logits"] = logits
            _log_run(f"tensor parallel: one process {dtype}, no process group", ref[dtype])
    finally:
        torch.backends.cudnn.deterministic = deterministic
    del model, init, batch
    torch.cuda.empty_cache()
    travel = sum(make_schedule(cfg.learning_rate, 100)(c) for c in range(DP_STEPS))
    with _scratch(tmp) as scratch:
        ref_path = os.path.join(scratch, "tp_reference.pt")
        torch.save({**{d: {k: r[k] for k in ("metrics", "params", "val", "logits")}
                       for d, r in ref.items()}, "travel": travel}, ref_path)
        del ref
        t_ranks = time.perf_counter()
        results = _run_dp_world(2, "gloo", tmp, ref_path, data, model=TP_MODEL)
        t_ranks = time.perf_counter() - t_ranks
        _report_tp(results, f"tensor parallel: mesh (1, {TP_MODEL}) on one card over gloo", dev)
        cards = torch.cuda.device_count()
        if cards >= 4:
            _report_tp(_run_dp_world(4, None, tmp, ref_path, data, model=TP_MODEL),
                       f"tensor parallel: mesh (2, {TP_MODEL}) under torchrun over NCCL, one "
                       "card a rank", dev)
        else:
            log(f"tensor parallel across cards: not run: {cards} card")
    log(f"tensor parallel phase in {time.perf_counter() - t_phase:.1f} s (the sample set "
        f"{t_files:.1f} s, the mesh (1, {TP_MODEL}) ranks {t_ranks:.1f} s); {smi_line()}")


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
    B=8 train step, at 10 s of audio and at 20 s with the fused front end,
    through ``utils/profiling.py``: ``trace`` (``torch.profiler``, CPU and
    CUDA, a Chrome trace written under the run's temporary directory) over
    two repetitions, each inside an ``annotate`` region."""
    import numpy as np
    import torch

    from simple_multimodal_tpu_torch.models.multimodal_model import create_model
    from simple_multimodal_tpu_torch.train.optim import make_optimizer
    from simple_multimodal_tpu_torch.train.state import TrainState
    from simple_multimodal_tpu_torch.train.steps import make_train_step
    from simple_multimodal_tpu_torch.utils.profiling import annotate, trace

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
            with trace(os.path.join(tmp, "traces", f"{tag} forward")) as prof:
                t0 = time.perf_counter()
                for _ in range(reps):
                    with annotate(f"{tag} B={B} forward"):
                        model(*inputs)
                sync()
                wall = (time.perf_counter() - t0) * 1e3
        _report_profile(prof, f"{tag} B={B} forward", wall, reps)
        step = make_train_step(model, make_optimizer(cfg, model, total_steps=100), cfg,
                               augment=True, compute_contrastive_loss=True)
        state, _ = step(TrainState.create(0), batch)  # warm-up
        sync()
        with trace(os.path.join(tmp, "traces", f"{tag} train")) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                with annotate(f"{tag} B={B} train step"):
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
    forward alone (bf16, dropout 0.1, CUDA events, 10 calls), wav_frontend's
    forward and forward+backward at [8,160000] and [8,320000] (bf16, CUDA
    events, 10 calls), the B=8 forward (host clock, 10 calls), the B=8
    train step (``steps`` steps, the first left out) and the 20 s B=8 train
    step with the fused front end and its peak device memory. With ``--tree DIR``
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
        if name == "wav_frontend" and "16013" not in label:  # 10 s and 20 s, bf16
            wav, kw = inputs[0], inputs[1].to(torch.bfloat16).requires_grad_()
            gs, gb = (t.clone().requires_grad_() for t in inputs[2:])
            gy = torch.randn(wav.shape[0], (wav.shape[1] - 10) // 5 + 1, 512, generator=gen,
                             device=dev).to(torch.bfloat16)
            with torch.no_grad():
                out[f"{name} {label} fwd ms"] = median(time_ms(
                    lambda: fns[name][0](wav, kw, gs, gb, stride=5), 10))
            out[f"{name} {label} fwd+bwd ms"] = median(time_ms(
                lambda: torch.autograd.grad(fns[name][0](wav, kw, gs, gb, stride=5), [kw, gs, gb],
                                            gy), 10))
            del kw, gs, gb, gy
            torch.cuda.empty_cache()
            continue
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
    del model, step, state
    torch.cuda.empty_cache()
    # the long clip with the fused front end (SMM_WAV_FRONTEND=1): 20 s train step, peak memory
    with fused_frontend():
        cfg = _long_config(tmp)
        model = create_model(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    batch = _train_batch(np.random.default_rng(4), cfg, dev)
    step = make_train_step(model, make_optimizer(cfg, model, total_steps=100), cfg,
                           augment=True, compute_contrastive_loss=True)
    state, times = TrainState.create(0), []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(steps):
        sync()
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    out["20 s B=8 train step ms (front end fused)"] = median(times[1:])
    out["20 s peak GiB"] = torch.cuda.max_memory_allocated() / 2**30
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
    # <group width P, 64-row tiles a warpgroup>: wav2vec2's positional conv, P = 16 ... 128
    "pos_conv_wgmma_kernel": (6, lambda lib, n, flags: lib.smm_pos_conv_smem(n)),
    # <mode>: the MoE layer's six grouped products (moe_experts_wgmma.cu)
    "moe_gemm_kernel": (6, lambda lib, n, flags: lib.smm_moe_gemm_smem()),
}


# the FFN and LayerNorm backwards' row kernels (csrc/gemm.cuh) and the MoE layer's
# (moe_experts_wgmma.cu), checked for spills like the above
ROW_KERNELS = ("ln_bwd_rows_kernel", "drop_cast_sum_kernel", "fold_columns_kernel",
               "moe_cast_kernel", "moe_gather_kernel", "moe_combine_kernel",
               "moe_token_grad_kernel")
# wav_frontend's kernels (csrc/wav_frontend.cu): name -> (instantiations, the pass whose dynamic
# shared memory smm_wav_frontend_smem reports, or None for a fold with static shared memory)
WAV_KERNELS = {"wav_stats_kernel": (2, 0), "wav_apply_kernel": (2, 1),
               "wav_bwd_sums_kernel": (2, 2), "wav_bwd_grads_kernel": (4, 3),
               "wav_fold_stats_kernel": (1, None), "wav_fold_dz_kernel": (1, None),
               "wav_fold_rows_kernel": (1, None), "wav_fold_dx_kernel": (1, None)}


def _report_wav_kernels(lib, lines):
    """ptxas' registers and spill bytes and the shared memory of every
    instantiation of wav_frontend's kernels (dynamic: at stride 5 and
    C = 512); a spill fails the run."""
    import re

    found, spilled = dict.fromkeys(WAV_KERNELS, 0), []
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '\S*?(" + "|".join(WAV_KERNELS)
                      + r")(I\S*?EEv)?", line)
        if not m:
            continue
        kernel, targs = m.group(1), m.group(2) or ""
        block = " ".join(x.strip() for x in lines[i + 1:i + 4])
        regs = re.search(r"Used (\d+) registers", block)
        spill = [int(x) for x in re.findall(r"(\d+) bytes spill", block)]
        bf16 = "bfloat16" in targs
        dwav = "Lb1E" in targs
        which = WAV_KERNELS[kernel][1]
        if which is None:
            smem = re.search(r"(\d+) bytes smem", block)
            shared = f"static shared memory {smem.group(1) if smem else 0} bytes"
        else:
            shared = (f"dynamic shared memory "
                      f"{lib.smm_wav_frontend_smem(int(bf16), which, int(dwav), 5, 512)} bytes")
        variant = ("" if which is None
                   else f"<{'bf16' if bf16 else 'f32'}{', dwav' if dwav else ''}>")
        log(f"wav kernel {kernel}{variant}: {regs.group(1) if regs else '?'} registers, spill "
            f"bytes {spill}, {shared}")
        found[kernel] += 1
        if not regs or len(spill) != 2 or any(spill):
            spilled.append(f"{kernel}{variant}: {block}")
    if spilled:
        raise AssertionError("ptxas reports spills: " + "; ".join(spilled))
    expected = {k: v[0] for k, v in WAV_KERNELS.items()}
    if found != expected:
        raise AssertionError(f"wav kernels in the compiler log: {found}, expected {expected}")


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
    _report_wav_kernels(lib, lines)
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


# -------------------------------------------------- the positional conv phase

# (B, L, E, G, K): the main path's positional conv at 10 s and 20 s, and the half width
POS_CONV_SHAPES = ((B, 499, 768, 16, 128), (B, 999, 768, 16, 128), (B, 499, 384, 16, 128))


def _with_grads(fn, inputs, gy):
    """fn(*inputs) and the gradient of sum(out * gy) for every input."""
    import torch

    ins = [t.detach().clone().requires_grad_(True) for t in inputs]
    out = fn(*ins)
    return [out.detach()] + list(torch.autograd.grad(out, ins, gy))


def phase_pos_conv(dev) -> dict:
    """wav2vec2's positional conv (``grouped_conv_same``, ``csrc/pos_conv.cu``)
    at the main path's shapes: the forward in bf16 against the plain version
    (f32 on the same rounded inputs, 3e-2), the input gradient (the kernel
    on the mirrored taps), the weight gradient (cuDNN) and the bias
    gradient against autograd of the plain version (5e-2 of the largest
    magnitude), dx bit-equal between two runs, and f32 at 1e-3; then the
    times (``pos_conv`` lines): the kernel's forward and input gradient
    alone, the weight gradient alone, the layer's forward and backward
    through the wrapper, the plain version, cuDNN's ``F.conv1d`` forward and
    backward (a yardstick the port never calls) and the bound; and the
    device time by kernel of one forward and backward through the wrapper."""
    import torch

    from simple_multimodal_tpu_torch.ops.hopper import pos_conv as pc

    gen = torch.Generator(device=dev).manual_seed(18)
    out = {}
    for Bn, L, E, G, K in POS_CONV_SHAPES:
        cg = E // G
        tag = f"pos_conv [{Bn},{L},{E}] G={G} K={K}"
        for dtype, tol, gtol in ((torch.float32, ATOL_F32, ATOL_F32),
                                 (torch.bfloat16, ATOL_BF16, GRAD_TOL_BF16)):
            x = torch.randn(Bn, L, E, generator=gen, device=dev).to(dtype)
            w = (torch.randn(E, cg, K, generator=gen, device=dev) * (cg * K) ** -0.5).to(dtype)
            bias = (torch.randn(E, generator=gen, device=dev) * 0.1).to(dtype)
            gy = torch.randn(Bn, L, E, generator=gen, device=dev).to(dtype)
            f32 = [t.float() for t in (x, w, bias)]
            runs = [_with_grads(lambda *a: pc.grouped_conv_same(*a, G), [x, w, bias], gy)
                    for _ in range(2)]
            want = _with_grads(lambda *a: pc.grouped_conv_same_plain(*a, G), f32, gy.float())
            sync()
            errs = [float((a.float() - b).abs().max()) for a, b in zip(runs[0], want)]
            scales = [float(b.abs().max()) for b in want]
            bit = torch.equal(runs[0][1], runs[1][1])
            log(f"{tag} {str(dtype)[6:]}: errors y/dx/dW/db "
                + " ".join(f"{e:.2e}" for e in errs) + " of max "
                + " ".join(f"{m:.3f}" for m in scales) + f", dx bit_equal={bit}")
            if not torch.allclose(runs[0][0].float(), want[0], atol=tol, rtol=tol):
                raise AssertionError(f"{tag} {dtype}: the forward disagrees with the plain version")
            if not bit or any(e > gtol * m for e, m in zip(errs[1:], scales[1:])):
                raise AssertionError(f"{tag} {dtype}: gradients {errs[1:]} beyond {gtol} of "
                                     f"{scales[1:]}, or dx not bit-equal ({bit})")
        taps, back = pc.tap_layout(w, G), pc.tap_layout(w, G, backward=True)
        flop = 2.0 * Bn * L * E * cg * K
        fwd = _back_to_back_ms(lambda: pc._launch(x, taps, bias, G, K // 2))
        dx = _back_to_back_ms(lambda: pc._launch(gy, back, None, G, K - 1 - K // 2))
        dw = _back_to_back_ms(lambda: pc.weight_grad(x, gy, w.shape, G))
        xr, wr, br = (t.detach().clone().requires_grad_(True) for t in (x, w, bias))

        def layer(fn):
            def run():
                y = fn(xr, wr, br, G)
                y.backward(gy)
            return run
        both = median(time_ms(layer(pc.grouped_conv_same), 10))
        plain = median(time_ms(lambda: pc.grouped_conv_same_plain(x, w, bias, G), 5))
        library = median(time_ms(layer(pc.grouped_conv_same_plain), 3))
        log(f"{tag} bf16 ms: kernel forward {fwd:.4f} ({flop / fwd / 1e9:.0f} TFLOP/s), input "
            f"gradient {dx:.4f} ({flop / dx / 1e9:.0f} TFLOP/s), weight gradient (cuDNN) {dw:.4f}; "
            f"forward+backward through the wrapper {both:.4f}; plain forward {plain:.4f}; "
            f"library (cuDNN F.conv1d forward+backward) {library:.3f}; bound one product "
            f"{flop / PEAK_FLOPS * 1e3:.4f}, forward+input gradient {2 * flop / PEAK_FLOPS * 1e3:.4f}")
        if (Bn, L, E) == POS_CONV_SHAPES[0][:3]:
            names = _log_device_times(f"{tag} forward+backward", layer(pc.grouped_conv_same),
                                      top=8)
            if not any("pos_conv_wgmma_kernel" in n for n in names) or any(
                    "dgrad" in n for n in names):
                raise AssertionError(f"{tag}: the wrapper's fwd+bwd ran {sorted(names)}")
            out["grouped_conv_same"] = {
                "max_abs_err": errs[0], "ms": fwd, "plain_ms": plain,
                "bound_ms": flop / PEAK_FLOPS * 1e3, "bound_by": "operations",
                "library_ms": library}
        del x, w, gy, runs, want
        torch.cuda.empty_cache()
    log(f"pos_conv times: device time per call in a run of 10 back-to-back calls (kernel, weight "
        f"gradient), CUDA-event medians of a call (the rest), on {smi_line()}")
    return out


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


# The DeepSeek text tower's linear layers at the moonlight.train cell's
# shapes (8192 tokens), and a ragged M tail (771 rows, not a multiple of the
# 128-row tile): (rows, the stacked weights' rows, K)
GEMM_LINEAR_SHAPES = (
    ("q_proj", 8192, (3072,), 2048), ("kv_a_proj_with_mqa", 8192, (576,), 2048),
    ("kv_b_proj", 8192, (4096,), 512), ("o_proj", 8192, (2048,), 2048),
    ("dense gate+up", 8192, (11264, 11264), 2048), ("dense down", 8192, (2048,), 11264),
    ("shared gate+up", 8192, (2816, 2816), 2048), ("shared down", 8192, (2048,), 2816),
    ("ragged tail gate+up", 771, (1408, 1408), 2048), ("ragged tail down", 771, (2048,), 1408),
)


def gemm_linear_errors(dev, rows, outs, K, gen):
    """``gemm_linear`` forward, dx and each weight's dW on bf16 ``x`` [rows,
    K] and f32 weights [n, K] (n in ``outs``, stacked), against autograd of
    the plain f32 expression on the same bf16-rounded operands: (the forward's
    largest abs error and whether it is within ATOL_BF16 (atol=rtol), the
    gradients' largest error as a share of each tensor's largest magnitude,
    a callable that runs forward and backward once)."""
    import torch

    from simple_multimodal_tpu_torch.ops.hopper.gemm import gemm_linear

    bf16 = torch.bfloat16
    x = torch.randn(rows, K, generator=gen, device=dev).to(bf16).requires_grad_()
    ws = [(torch.randn(n, K, generator=gen, device=dev) * K ** -0.5).requires_grad_()
          for n in outs]
    gy = torch.randn(rows, sum(outs), generator=gen, device=dev).to(bf16)
    y = gemm_linear(x, *ws)
    y.backward(gy)
    xf = x.detach().float().requires_grad_()
    wf = [w.detach().to(bf16).float().requires_grad_() for w in ws]
    yf = xf @ torch.cat(wf).t()
    yf.backward(gy.float())
    sync()
    y, yf = y.detach(), yf.detach()
    err = float((y.float() - yf).abs().max())
    ok = bool(torch.allclose(y.float(), yf, atol=ATOL_BF16, rtol=ATOL_BF16))
    grad = max(float((g.float() - want).abs().max() / want.abs().max())
               for g, want in [(x.grad, xf.grad)] + [(w.grad, v.grad) for w, v in zip(ws, wf)])

    def once():
        for t in [x] + ws:
            t.grad = None
        gemm_linear(x, *ws).backward(gy)

    return err, ok, grad, once


def phase_gemm_linear(dev):
    """``gemm_linear`` (the DeepSeek tower's projections, dense layer and
    shared experts, and a ragged M tail) at the tower's shapes: forward (bf16, atol=rtol=ATOL_BF16), dx and every dW
    (within GRAD_TOL_BF16 of each tensor's largest magnitude) against the
    plain f32 version, and the device time of a forward and backward."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(11)
    for name, rows, outs, K in GEMM_LINEAR_SHAPES:
        err, ok, grad, once = gemm_linear_errors(dev, rows, outs, K, gen)
        ms = _back_to_back_ms(once, reps=5)
        log(f"gemm_linear {name} [{rows}, {'+'.join(map(str, outs))}, {K}]: err={err:.2e} "
            f"grad err/max={grad:.2e} fwd+bwd ms={ms:.4f}")
        if not ok or not grad <= GRAD_TOL_BF16:
            raise AssertionError(f"gemm_linear {name}: disagrees with the plain version (forward "
                                 f"err {err:.3e}, tol {ATOL_BF16}; gradients {grad:.3e} of "
                                 f"their largest magnitude, tol {GRAD_TOL_BF16})")
        del once
        torch.cuda.empty_cache()
    log(f"gemm_linear times above: device time a forward and backward, on {smi_line()}")


# one MoE layer's routed experts at the moonlight.train cell's shapes: T tokens, k choices
# of EXPERTS, the first HELD held (as mer_moonlight holds them), widths E and F
MOE_T, MOE_K, MOE_E, MOE_F, MOE_HELD, MOE_EXPERTS = 8192, 6, 2048, 1408, 8, 64


def moe_case(dev, gen, skewed: bool):
    """bf16 h [T, E], f32 routing weights [T, k], the choice [T, k] of k of
    the 64 experts, the held experts' f32 gate, up and down weights.
    ``skewed``: no token takes expert 0 and the first 3186 take expert 1
    (the most rows a held expert took in a traced moonlight.train step);
    else every choice at random."""
    import torch

    T, k, E, Fd, n = MOE_T, MOE_K, MOE_E, MOE_F, MOE_HELD
    scores = torch.rand(T, MOE_EXPERTS, generator=gen, device=dev)
    if skewed:
        scores[:, 0] = -1.0
        scores[:3186, 1] = 2.0
        scores[3186:, 1] = -1.0
    choice = scores.topk(k, dim=-1).indices
    weights = torch.rand(T, k, generator=gen, device=dev) + 0.05
    h = torch.randn(T, E, generator=gen, device=dev).to(torch.bfloat16)
    params = [torch.randn(*shape, generator=gen, device=dev) * shape[1] ** -0.5
              for shape in [(Fd, E)] * (2 * n) + [(E, Fd)] * n]
    return h, weights, choice, params


def moe_loop(h, weights, choice, gates, ups, downs):
    """The held experts as models/deepseek.py ran them before
    ``moe_experts``: one host read of the row counts, then for each held
    expert its rows' gather, gate|up and down on ``gemm_linear``, the SiLU
    product in f32 and an f32 ``index_add_``."""
    import torch
    import torch.nn.functional as F

    from simple_multimodal_tpu_torch.ops.hopper.gemm import gemm_linear

    k, n = choice.shape[1], len(gates)
    slot = torch.where(choice < n, choice, n).reshape(-1)
    order = torch.argsort(slot, stable=True)
    sizes = torch.bincount(slot, minlength=n + 1)[:n].tolist()
    out = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
    weights = weights.reshape(-1)
    start = 0
    for j, rows in enumerate(sizes):
        if rows:
            idx = order[start:start + rows]
            tokens = idx // k
            g, u = gemm_linear(h[tokens], gates[j], ups[j]).chunk(2, dim=-1)
            y = gemm_linear((F.silu(g.float()) * u.float()).to(h.dtype), downs[j])
            out.index_add_(0, tokens, y.float() * weights[idx, None])
        start += rows
    return out


def _moe_errors(got, want):
    """(the forward's largest abs error, whether it is within ATOL_BF16
    (atol=rtol), the gradients' largest error as a share of each tensor's
    largest magnitude) of [output, *gradients] against the same of another
    path; a gradient that is zero in ``want`` (an idle expert's) is held
    apart."""
    import torch

    err = float((got[0] - want[0]).abs().max())
    ok = bool(torch.allclose(got[0], want[0], atol=ATOL_BF16, rtol=ATOL_BF16))
    grad = max(float((a.float() - b.float()).abs().max() / b.float().abs().max())
               for a, b in zip(got[1:], want[1:]) if b.abs().max() > 0)
    return err, ok, grad


def phase_moe_experts(dev):
    """The routed experts of one MoE layer at the moonlight.train shapes
    (``moe_experts``, ``csrc/moe_experts_wgmma.cu``) against the plain f32
    version (``moe_experts_plain`` on the same bf16-rounded operands) and
    the per-expert loop they replace (``moe_loop``), for a skewed routing
    (an idle expert, one with 3186 rows) and a drawn one: the forward within
    ATOL_BF16, dh, the routing weights' gradient and every dW within
    GRAD_TOL_BF16 of the tensor's largest magnitude, the idle expert's
    gradients zero; the same device kernels, as many, under both routings;
    the time of a forward and backward, the kernels and the loop (CUDA
    events over back-to-back calls, and the host's wall time a call ended
    by a synchronise), beside the bound: the products' FLOP (3 products of
    2 E F a row forward, twice that backward) over 989 TFLOP/s. Then a
    whole MoE layer (``models/deepseek.py::MoE``, 8 of 64 experts held) at
    the tower's widths, forward and backward on T tokens, with
    ``moe_experts.launches`` set to 0 just before: it reads 1."""
    import torch

    from simple_multimodal_tpu_torch.ops.hopper.moe_experts import (
        dispatch,
        moe_experts,
        moe_experts_plain,
    )

    gen = torch.Generator(device=dev).manual_seed(23)
    n = MOE_HELD
    kernels = {}
    for skewed in (True, False):
        h, weights, choice, params = moe_case(dev, gen, skewed)
        gy = torch.randn(MOE_T, MOE_E, generator=gen, device=dev).to(torch.bfloat16).float()
        leaves = [h, weights] + params

        def grouped(ts):
            plan = dispatch(choice, 0, n)
            return moe_experts(ts[0], ts[1], plan, ts[2:2 + n], ts[2 + n:2 + 2 * n], ts[2 + 2 * n:])

        def loop(ts):
            return moe_loop(ts[0], ts[1], choice, ts[2:2 + n], ts[2 + n:2 + 2 * n], ts[2 + 2 * n:])

        results = {}
        for name, fn in (("grouped", grouped), ("loop", loop)):
            ts = [t.clone().requires_grad_() for t in leaves]
            out = fn(ts)
            out.backward(gy)
            # the loop gives an idle expert no gradient: zeros
            results[name] = [out.detach()] + [torch.zeros_like(t) if t.grad is None else t.grad
                                              for t in ts]
            del out

            def once(fn=fn, ts=ts):
                for t in ts:
                    t.grad = None
                fn(ts).backward(gy)

            results[name + " ms"] = _back_to_back_ms(once, reps=5)
            sync()
            t0 = time.perf_counter()
            for _ in range(5):
                once()
            sync()
            results[name + " host ms"] = (time.perf_counter() - t0) / 5 * 1e3
            if name == "grouped":
                kernels[skewed] = _log_device_times(
                    f"moe_experts fwd+bwd ({'skewed' if skewed else 'drawn'} routing)", once,
                    reps=3, top=12)
        # the plain version in f32 on the same bf16-rounded operands, as the GPU test holds it
        ts = [h.float().requires_grad_(), weights.clone().requires_grad_()] + [
            p.to(torch.bfloat16).float().requires_grad_() for p in params]
        out = moe_experts_plain(ts[0], ts[1], dispatch(choice, 0, n).slot, ts[2:2 + n],
                                ts[2 + n:2 + 2 * n], ts[2 + 2 * n:])
        out.backward(gy)
        results["plain"] = [out.detach()] + [t.grad for t in ts]
        del out, ts
        got = results["grouped"]
        idle = [bool(t.any()) for t in (got[3], got[3 + n], got[3 + 2 * n])] if skewed else []
        rows = int((choice < n).sum())
        bound_ms = rows * 3 * 2 * MOE_E * MOE_F * 3 / 989e12 * 1e3
        routing = "skewed" if skewed else "drawn"
        for against in ("plain", "loop"):
            err, ok, grad = _moe_errors(got, results[against])
            log(f"moe_experts {routing} routing ({rows} rows to {n} held experts) against the "
                f"{against}: err={err:.2e} grad err/max={grad:.2e}")
            if not ok or not grad <= GRAD_TOL_BF16 or any(idle):
                raise AssertionError(f"moe_experts: disagrees with the {against} version ("
                                     f"forward err {err:.3e}, gradients {grad:.3e} of their "
                                     f"largest magnitude, the idle expert's gradients nonzero: "
                                     f"{idle})")
        log(f"moe_experts {routing} routing: fwd+bwd ms={results['grouped ms']:.3f} (host "
            f"{results['grouped host ms']:.3f}), per-expert loop {results['loop ms']:.3f} (host "
            f"{results['loop host ms']:.3f}), bound {bound_ms:.4f}")
        del results, got
        torch.cuda.empty_cache()
    if kernels[True] != kernels[False]:
        raise AssertionError(f"moe_experts launches other kernels under another routing: "
                             f"{kernels[True]} against {kernels[False]}")
    log(f"moe_experts: the same {sum(kernels[True].values()):.0f} device kernels a forward and "
        f"backward under both routings, on {smi_line()}")

    from simple_multimodal_tpu_torch.models.deepseek import DeepseekConfig, MoE

    layer = MoE(DeepseekConfig(expert_share=(0, MOE_EXPERTS // MOE_HELD))).to(dev)
    with torch.no_grad():
        for p in layer.parameters():
            p.normal_(0.0, 0.02, generator=gen)
    x = torch.randn(8, MOE_T // 8, MOE_E, generator=gen, device=dev).to(torch.bfloat16)
    x.requires_grad_()
    moe_experts.launches = 0
    layer(x, torch.bfloat16).float().square().mean().backward()
    sync()
    launches = moe_experts.launches
    log(f"moe_experts main path: a MoE layer's forward and backward on {MOE_T} tokens counted "
        f"{launches} launch(es) of moe_experts")
    if launches != 1 or x.grad is None:
        raise AssertionError(f"moe_experts: a MoE layer's forward and backward counted {launches} "
                             f"launches, not 1")
    del layer, x
    torch.cuda.empty_cache()


# the benchmark configurations whose parameter lists the AdamW phase updates
ADAMW_CONFIGS = ("mer_base", "mer_moonlight")
ADAMW_BYTES = 32  # an element: g read twice (norm, update), p, m and v read and written once


def _adamw_leaves(name: str) -> list:
    """(name, shape) of every trainable parameter of ``portbench/configs/
    <name>.json``'s model, built on the meta device (no memory, no
    initialisation)."""
    import torch

    from simple_multimodal_tpu_torch.config import ModelConfig
    from simple_multimodal_tpu_torch.models.multimodal_model import MultimodalEmotionModel

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "portbench", "configs",
                        f"{name}.json")
    with open(path) as f:
        program = dict(json.load(f)["program"])
    fusion = program.pop("fusion_type")
    config = ModelConfig(**program)
    config.fusion_type = fusion
    with torch.device("meta"):
        model = MultimodalEmotionModel(config, dtype=torch.bfloat16)
    return [(n, tuple(p.shape)) for n, p in model.named_parameters() if p.requires_grad]


def _adamw_rel(a, b) -> float:
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _adamw_subset(leaves: list) -> list:
    """Indices of the leaves (``_adamw_leaves``) whose whole update
    ``phase_adamw`` holds to the chain where a second state of every leaf
    does not fit: the largest leaf (the token embedding, 5120 chunks), every
    leaf of the last layer with routed experts (its router, held experts and
    shared experts) and the table's last 64 leaves (the heads, down to one
    element), so the chunks at both ends of the table."""
    import math

    sizes = [math.prod(s) for _, s in leaves]
    names = [n for n, _ in leaves]
    picked = {max(range(len(sizes)), key=sizes.__getitem__)}
    experts = [n for n in names if ".mlp.experts." in n]
    if experts:
        layer = experts[-1].split(".mlp.")[0] + ".mlp."
        picked.update(i for i, n in enumerate(names) if n.startswith(layer))
    picked.update(range(max(len(names) - 64, 0), len(names)))
    return sorted(picked)


def _host_ms(fn, reps: int) -> list:
    """The host's enqueue time (ms) of ``reps`` calls, each from an idle device."""
    out = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    sync()
    return out


def phase_adamw(dev):
    """The optimizer update at ``ADAMW_CONFIGS``' parameter lists (f32
    parameters ~N(0, 0.02), gradients ~N(0, 1e-3), the clip engaged, lr
    1e-3, so that a change is not lost in the rounding of p): one update of
    the two kernels (``ops/hopper/adamw.py``) over every leaf against the
    chain (``AdamWChain._chain``) from the same state: the norm within 1e-6,
    and each compared leaf's m and v within 2e-6 and its change within 1e-5,
    relative in norm. mer_base compares every leaf, its chain clipping by
    its own norm; mer_moonlight, whose second state does not fit beside the
    timings, the leaves of ``_adamw_subset``, its chain given the gradients
    clipped by the kernels' norm (``clip = inf``). Then one launch of each
    kernel and every element through them; the update's device time (CUDA
    events, medians of 5: chain, kernels, kernels, chain) beside the byte
    bound, the host's enqueue time and the device memory one update adds to
    the state (parameters, gradients, moments); and the global norm from
    ``torch._foreach_norm`` (the chain's) against the one from
    ``foreach_sumsq``, device and host times."""
    import math

    import torch

    from simple_multimodal_tpu_torch.ops.hopper import adamw
    from simple_multimodal_tpu_torch.train.optim import AdamWChain, global_norm

    for cfg_name in ADAMW_CONFIGS:
        leaves = _adamw_leaves(cfg_name)
        names = [n for n, _ in leaves]
        gen = torch.Generator(device=dev).manual_seed(20)
        init = [torch.randn(s, generator=gen, device=dev) * 0.02 for _, s in leaves]
        grads = [torch.randn(s, generator=gen, device=dev) * 1e-3 for _, s in leaves]
        opt = AdamWChain(zip(names, [torch.nn.Parameter(x) for x in init]),
                         lambda count: 1e-3, 1.0, weight_decay=0.01)
        del init
        elements = sum(p.numel() for p in opt.params)
        launches = (adamw.foreach_sumsq.launches, adamw.foreach_adamw.launches)
        want_norm = global_norm(grads, opt.params)  # the chain's norm
        whole = cfg_name == "mer_base"
        picked = list(range(len(names))) if whole else _adamw_subset(leaves)
        before = [opt.params[i].detach().clone() for i in picked]
        want = AdamWChain(zip([names[i] for i in picked],
                              [torch.nn.Parameter(p.clone()) for p in before]),
                          lambda count: 1e-3, 1.0 if whole else math.inf, weight_decay=0.01)
        norm = opt.update(grads)
        # the chain's clip coefficient, of the kernels' norm where the chain sees a subset
        coef = 1.0 if whole else torch.where(norm < 1.0, torch.ones_like(norm), 1.0 / norm)
        want._chain([grads[i] * coef for i in picked])
        errs = {"norm": abs(float(norm) / float(want_norm) - 1),
                "m": max(_adamw_rel(opt.mu[i], b) for i, b in zip(picked, want.mu)),
                "v": max(_adamw_rel(opt.nu[i], b) for i, b in zip(picked, want.nu)),
                "change": max(_adamw_rel(opt.params[i].detach() - c, b.detach() - c)
                              for i, b, c in zip(picked, want.params, before))}
        compared = sum(b.numel() for b in before)
        del want, before
        sync()
        got = (adamw.foreach_sumsq.launches - launches[0], adamw.foreach_adamw.launches -
               launches[1])
        log(f"adamw {cfg_name}: {len(names)} leaves, {elements} elements; norm {float(norm):.6g} "
            f"(chain {float(want_norm):.6g}); update compared at {len(picked)} leaves, "
            f"{compared} elements (leaves {picked[0]}..{picked[-1]}); relative errors " +
            " ".join(f"{k}={v:.2e}" for k, v in errs.items()) + f"; launches {got}")
        bounds = {"norm": 1e-6, "m": 2e-6, "v": 2e-6, "change": 1e-5}
        if got != (1, 1) or any(not v <= bounds[k] for k, v in errs.items()):
            raise AssertionError(f"adamw {cfg_name}: kernels disagree with the chain {errs} "
                                 f"(bounds {bounds}) or launched {got} times")
        if opt.fused_elements != elements:
            raise AssertionError(f"adamw {cfg_name}: {opt.fused_elements} elements through the "
                                 f"kernels of {elements}")
        bound = ADAMW_BYTES * elements / 3.35e12 * 1e3
        fns = {"chain": lambda: opt._chain(grads), "kernels": lambda: opt.update(grads)}
        ms, host = {}, {}
        for which in ("chain", "kernels", "kernels", "chain"):
            ms.setdefault(which, []).append(median(time_ms(fns[which], 5)))
            host.setdefault(which, []).append(median(_host_ms(fns[which], 3)))
        mem = {}
        for which in ("chain", "kernels"):
            sync()
            torch.cuda.reset_peak_memory_stats(dev)
            state = torch.cuda.memory_allocated(dev)
            fns[which]()
            sync()
            mem[which] = (torch.cuda.max_memory_allocated(dev) - state, state)
        for which in ("chain", "kernels"):
            log(f"adamw {cfg_name} {which}: device ms " +
                ", ".join(f"{x:.3f}" for x in ms[which]) +
                f" (bound {bound:.3f} at {ADAMW_BYTES} B an element over 3.35 TB/s; "
                f"{ADAMW_BYTES * elements / (median(ms[which]) * 1e-3) / 1e12:.2f} TB/s "
                f"at that count); host enqueue ms " + ", ".join(f"{x:.2f}" for x in host[which])
                + f"; one update adds {mem[which][0] / 1e9:.2f} GB to the state's "
                f"{mem[which][1] / 1e9:.2f} GB")
        table = opt.fused.grad_table(grads)
        norm_fns = {
            "foreach_norm": lambda: global_norm(grads, opt.params),
            "foreach_sumsq": lambda: global_norm(grads, opt.params,
                                                 norms=adamw.foreach_sumsq(opt.fused, table))}
        ms, host = {}, {}
        for which in ("foreach_norm", "foreach_sumsq", "foreach_sumsq", "foreach_norm"):
            ms.setdefault(which, []).append(median(time_ms(norm_fns[which], 5)))
            host.setdefault(which, []).append(median(_host_ms(norm_fns[which], 5)))
        diff = abs(float(norm_fns["foreach_norm"]()) / float(norm_fns["foreach_sumsq"]()) - 1)
        for which in ("foreach_norm", "foreach_sumsq"):
            log(f"adamw {cfg_name} global norm from {which}: device ms " +
                ", ".join(f"{x:.3f}" for x in ms[which]) + "; host enqueue ms " +
                ", ".join(f"{x:.3f}" for x in host[which]) + f"; the two norms differ by "
                f"{diff:.2e} relative")
        del opt, grads, fns, norm_fns, table
        torch.cuda.empty_cache()
    log(f"adamw times above: on {smi_line()}")


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
    if "--dp-rank" in argv:  # one rank of phase 24's torchrun launch
        _dp_rank(json.loads(argv[argv.index("--dp-rank") + 1]))
        return 0
    try:
        dev = torch.device("cuda", 0)
        t_start = time.perf_counter()
        phase_device_and_build(report="--tree" not in argv)
        if "--profile" in argv or "--timings" in argv:
            with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
                (phase_profile if "--profile" in argv else phase_timings)(dev, tmp)
            return 0
        if "--pos-conv" in argv:
            phase_pos_conv(dev)
            return 0
        if "--gemm-linear" in argv:
            phase_gemm_linear(dev)
            return 0
        if "--moe-experts" in argv:
            phase_moe_experts(dev)
            return 0
        if "--adamw" in argv:
            phase_adamw(dev)
            return 0
        if "--data-parallel" in argv or "--tensor-parallel" in argv:
            with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
                (phase_data_parallel if "--data-parallel" in argv
                 else phase_tensor_parallel)(dev, tmp)
            return 0
        phase_gemm(dev)
        phase_gemm_linear(dev)
        phase_moe_experts(dev)
        phase_adamw(dev)
        phase_ffn_bwd_kernels(dev)
        kern = phase_kernels(dev)
        kern.update(phase_backward(dev))
        kern.update(phase_pos_conv(dev))
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
            for phase in (phase_distillation, phase_fewshot, phase_robust, phase_late_serve,
                          phase_half, phase_families_f32, phase_train_from_files,
                          phase_distillation_from_files, phase_ablation_from_files,
                          phase_all_from_files, phase_evaluate_from_files, phase_web_server,
                          phase_weights_io, phase_data_parallel, phase_tensor_parallel):
                t0 = time.perf_counter()
                phase(dev, tmp)
                torch.cuda.empty_cache()
                log(f"{phase.__name__} in {time.perf_counter() - t0:.1f} s")
        log(f"all phases in {time.perf_counter() - t_start:.1f} s")
    except Exception:
        traceback.print_exc()
        return 1
    kernels = [{
        "name": name, "route": "cuda", "source": SOURCES[name],
        "replaces": replaces, "launches": counts[name],
        "max_abs_err": kern[name]["max_abs_err"], "ms": kern[name]["ms"],
        "plain_ms": kern[name]["plain_ms"], "bound_ms": kern[name]["bound_ms"],
        "bound_by": kern[name]["bound_by"], "library_ms": kern[name]["library_ms"],
    } for name, replaces in {**REPLACES, **NEW_KERNELS}.items()]
    log(json.dumps({"kernels": kernels}))
    log(smi_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
