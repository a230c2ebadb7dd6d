#!/usr/bin/env python3
"""Smoke run of the PyTorch port (simple_multimodal_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one NVIDIA H100 (sm_90a) and nvcc. Phases, each ending in
``torch.cuda.synchronize()``:

1. device and build: the card's name and power limit, the torch/CUDA
   versions, the kernels built from ``csrc/`` (seconds printed);
2. each Hopper kernel's forward against its plain PyTorch version at the
   main path's shapes (base preset, B=8), in bf16 (atol=rtol=3e-2: bf16
   rounding of q/k/v, probabilities, the FFN intermediate and the output)
   and in f32 (atol=rtol=1e-3: only the summation order differs), with
   CUDA-event medians of kernel and plain, interleaved plain, kernel,
   kernel, plain;
3. the same six sites with hash dropout at rate 0.1 (fixed seed), forward
   and backward: the output and every input gradient of each kernel's
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
   with dropout and augmentation on, 3 steps on seeded batches (int16
   audio, yuv420 video, labels): finite losses and gradient norms, every
   parameter moved, and each step launching the three backward kernels
   23/35/12 times; ms/step on the host clock and peak device memory;
7. full width train step: one B=1 step's loss and gradients in f32 with
   dropout and augmentation off (eval mode), TF32 off, card (kernels)
   against CPU (plain versions): loss within 1e-4 relative, each gradient
   within 1e-3 of its largest magnitude above a noise floor of 1e-6 of the
   step's largest gradient.

Prints a JSON line with every kernel's launches, error and times, the
``nvidia-smi`` name/power-limit line, and, last, the ok line. Any failure
prints a traceback and exits non-zero without the ok line.
"""
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
TRAIN_STEPS = 3
REPLACES = {
    "attention_block": "simple_multimodal_tpu/ops/pallas/attention_block.py:165",
    "ffn_block": "simple_multimodal_tpu/ops/pallas/ffn_block.py:136",
    "deberta_attention": "simple_multimodal_tpu/ops/pallas/deberta_attention.py:282",
    "attention_block_bwd": "simple_multimodal_tpu/ops/pallas/attention_block.py:385",
    "ffn_block_bwd": "simple_multimodal_tpu/ops/pallas/ffn_block.py:391",
    "deberta_attention_bwd": "simple_multimodal_tpu/ops/pallas/deberta_attention.py:446",
}
SOURCES = {name: f"simple_multimodal_tpu_torch/csrc/{name}.cu" for name in REPLACES}
# one B=8 forward (serve) and one B=8 train step
FORWARD_LAUNCHES = {"attention_block": 23, "ffn_block": 35, "deberta_attention": 12}
EXPECTED_LAUNCHES = dict(FORWARD_LAUNCHES, attention_block_bwd=0, ffn_block_bwd=0,
                         deberta_attention_bwd=0)
TRAIN_LAUNCHES = dict(FORWARD_LAUNCHES, attention_block_bwd=23, ffn_block_bwd=35,
                      deberta_attention_bwd=12)


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


def median(xs):
    xs = sorted(xs)
    n = len(xs)
    return xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])


# ------------------------------------------------------------ phase 2 cases

def _kernel_cases(dev, gen):
    """(kernel name, case label, kernel fn, plain fn, inputs) at the main
    path's shapes. Inputs are f32; each case runs in bf16 and in f32."""
    import torch

    from simple_multimodal_tpu_torch.ops.hopper import (
        attention_block as ab, deberta_attention as da, ffn_block as fb)

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
    x, lnp = attn_inputs(B, 499)
    cases.append(("attention_block", "wav2vec2 [8,499,768]",
                  lambda t, g, b: dict(ln=None, residual=False), x, lnp))

    def ffn_inputs(rows, S):
        return ([rn(rows, S, E), rn(E, Fd, std=E ** -0.5), rn(Fd, std=0.1),
                 rn(Fd, E, std=Fd ** -0.5), rn(E, std=0.1)],
                [1.0 + rn(E, std=0.1), rn(E, std=0.1)])

    x, lnp = ffn_inputs(B * 30, 197)
    cases.append(("ffn_block", "ViT [240,197,768] pre-LN",
                  lambda t, g, b: dict(ln=(g, b, 1e-12), ln_post=False), x, lnp))
    x, lnp = ffn_inputs(B, 512)
    cases.append(("ffn_block", "DeBERTa [8,512,768] post-LN",
                  lambda t, g, b: dict(ln=(g, b, 1e-7), ln_post=True), x, lnp))
    x, lnp = ffn_inputs(B, 499)
    cases.append(("ffn_block", "wav2vec2 [8,499,768] post-LN",
                  lambda t, g, b: dict(ln=(g, b, 1e-5), ln_post=True), x, lnp))

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
    fns = {
        "attention_block": (lambda *a, **k: ab.attention_block(*a, num_heads=H, **k),
                            lambda *a, **k: ab.attention_block_plain(*a, num_heads=H, **k)),
        "ffn_block": (fb.ffn_block, fb.ffn_block_plain),
        "deberta_attention": (da.deberta_attention, da.deberta_attention_plain),
    }
    return cases, fns


def phase_kernels(dev) -> dict:
    """Phase 2: every kernel against its plain version. Returns per-kernel
    {max_abs_err, ms, plain_ms} (times from each kernel's first case, bf16)."""
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
            log(f"kernel {name:18s} {label:56s} {str(dtype)[6:]:8s} "
                f"max_abs_err={max_err:.3e} tol={tol:g} ok={ok} "
                f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}")
            if not (ok and finite):
                raise AssertionError(f"{name} {label} {dtype}: kernel disagrees "
                                     f"with its plain version (max abs err "
                                     f"{max_err:.3e}, tol {tol}, finite={finite})")
            r = results.setdefault(name, {"max_abs_err": 0.0})
            r["max_abs_err"] = max(r["max_abs_err"], max_err)
            if "ms" not in r:  # the first case of each kernel, bf16
                r["ms"], r["plain_ms"] = ms, plain_ms
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


def _requests(rng):
    """Three requests with text, int16 audio and yuv420 / RGB video."""
    from simple_multimodal_tpu_torch.data.video_wire import pack_yuv420

    def wav():
        return (rng.standard_normal(160000) * 3000).astype("int16")

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


def phase_serve_and_count(dev, tmp: str):
    """Phases 3 and 4: serve requests through the demo, then one B=8
    forward with the launch counters reset just before it. ``tmp`` holds the
    config's directories and the checkpoint."""
    import numpy as np
    import torch

    from simple_multimodal_tpu_torch.data.tokenizer import HashTokenizer
    from simple_multimodal_tpu_torch.data.video_wire import pack_yuv420
    from simple_multimodal_tpu_torch.models.multimodal_model import create_model
    from simple_multimodal_tpu_torch.ops import hopper
    from simple_multimodal_tpu_torch.serving.demo import MultimodalEmotionDemo, save_checkpoint

    cfg = _base_config(tmp)
    t0 = time.perf_counter()
    model = create_model(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    if dev.type == "cuda" and model.dtype != torch.bfloat16:
        raise AssertionError(f"base model on cuda should compute in bf16, got {model.dtype}")
    ckpt = os.path.join(tmp, "model.pt")
    save_checkpoint(ckpt, model, cfg)
    del model
    demo = MultimodalEmotionDemo(checkpoint_path=ckpt, device=dev)
    sync()
    log(f"serve: base hierarchical bf16 model built, saved and loaded in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    for i, (text, audio, video) in enumerate(_requests(rng)):
        t0 = time.perf_counter()
        analysis = demo.predict(text, audio, video)
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        dist = analysis["emotion_distribution"]
        _check_probs(torch.tensor(list(dist.values()))[None], f"request {i}")
        given = "+".join(m for m, x in (("text", text), ("audio", audio), ("video", video))
                         if x is not None)
        log(f"serve: request {i} ({given}) -> {analysis['predicted_emotion']} "
            f"conf={analysis['confidence']:.3f} "
            f"valence={analysis['valence']:.3f} latency_ms={ms:.1f}")

    words = ["great", "sad", "angry", "afraid", "surprised", "disgusted", "fine", "ok"]
    texts = [f"request number {i}: feeling {words[i % len(words)]} today" for i in range(B)]
    enc = HashTokenizer(model_max_length=cfg.text_max_length)(texts)
    batch = (
        {k: torch.from_numpy(v).to(dev) for k, v in enc.items()},
        torch.from_numpy((rng.standard_normal((B, 160000)) * 3000).astype("int16")).to(dev),
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
    log(f"counts: one B={B} forward launched {counts} (expected {EXPECTED_LAUNCHES})")
    if counts != EXPECTED_LAUNCHES:
        raise AssertionError(f"launch counts {counts} != {EXPECTED_LAUNCHES}")
    log(f"serve: B={B} forward median {median(times) * 1e3:.1f} ms = "
        f"{B / median(times):.2f} clips/s (host clock, inputs on the device; "
        f"{smi_line()})")
    return counts, demo


def phase_full_width_f32(demo):
    """Phase 5: one base-width request in f32 on the card (kernels, TF32
    off) against the CPU (plain versions), same weights."""
    import numpy as np
    import torch

    from simple_multimodal_tpu_torch.models.multimodal_model import MultimodalEmotionModel

    cfg, rng = demo.config, np.random.default_rng(1)
    set_tf32(False)
    text, audio, video = _requests(rng)[3]
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
        log(f"f32 full width: {where} forward {time.perf_counter() - t0:.2f} s")
        del m
    keys = ("emotion_logits", "valence", "arousal", "text_features",
            "audio_features", "video_features")
    for k in keys:
        a, b = outs["card"][k], outs["cpu"][k]
        err = float((a - b).abs().max())
        log(f"f32 full width: {k:16s} max_abs_err={err:.3e} (atol=rtol={ATOL_F32:g})")
        if not torch.allclose(a, b, atol=ATOL_F32, rtol=ATOL_F32):
            raise AssertionError(f"f32 full width: {k} GPU kernels vs CPU plain "
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
            "deberta_attention": dict(dropout_rate=DROP_RATE, dropout_seed=DROP_SEED)}
    results = {}
    for name, label, kw_fn, inputs, lnp in cases:
        kern, plain = fns[name]
        n_in = len(inputs)

        def call(fn, args, n_in=n_in, kw_fn=kw_fn, name=name):
            lnargs = list(args[n_in:]) + [None] * (2 - len(args[n_in:]))
            return fn(*args[:n_in], **kw_fn(None, *lnargs), **drop[name])

        if kw_fn(None, 1, 1).get("ln") is None:
            lnp = []  # the site has no LayerNorm: its params take no gradient
        names = _arg_names(name, n_in + len(lnp))
        for dtype in (torch.bfloat16, torch.float32):
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
            log(f"fwd+bwd {name:18s} {label:56s} {str(dtype)[6:]:8s} rate={DROP_RATE} "
                f"max_abs_err={max_err:.3e} worst_rel={worst:.3e} ok={ok} "
                f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}")
            if not ok:
                raise AssertionError(f"{name} {label} {dtype}: the backward disagrees with "
                                     f"autograd of the plain version (max abs err "
                                     f"{max_err:.3e}, worst relative {worst:.3e})")
            r = results.setdefault(name + "_bwd", {"max_abs_err": 0.0})
            r["max_abs_err"] = max(r["max_abs_err"], max_err)
            if "ms" not in r:
                r["ms"], r["plain_ms"] = ms, plain_ms
            del args, args32
            torch.cuda.empty_cache()
    log(f"fwd+bwd times above: CUDA-event medians on {smi_line()}")
    return results


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


def phase_train(dev, tmp: str) -> dict:
    """Phase 6: TRAIN_STEPS base-preset B=8 bf16 train steps with dropout
    and augmentation on. Returns the backward launch counts of one step."""
    import numpy as np
    import torch

    from simple_multimodal_tpu_torch.models.multimodal_model import create_model
    from simple_multimodal_tpu_torch.ops import hopper
    from simple_multimodal_tpu_torch.train.optim import make_optimizer
    from simple_multimodal_tpu_torch.train.state import TrainState
    from simple_multimodal_tpu_torch.train.steps import make_train_step

    cfg = _base_config(tmp)
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
        log(f"train: step {i} {times[-1] * 1e3:.1f} ms loss={vals['total_loss']:.4f} "
            f"emotion={vals['emotion_loss']:.4f} contrastive={vals['contrastive_loss']:.4f} "
            f"grad_norm={vals['grad_norm']:.4f} launches={c}")
        if not all(np.isfinite(v) for v in vals.values()):
            raise AssertionError(f"train step {i}: non-finite metrics {vals}")
        if c != TRAIN_LAUNCHES:
            raise AssertionError(f"train step {i}: launch counts {c} != {TRAIN_LAUNCHES}")
        counts = c
    peak = torch.cuda.max_memory_allocated()
    still = [n for n, p in model.named_parameters()
             if not n.startswith(UNUSED) and torch.equal(p.detach(), before[n])]
    if still:
        raise AssertionError(f"train: {len(still)} parameters did not move, e.g. {still[:5]}")
    log(f"train: B={B} base hierarchical bf16, dropout and augmentation on: median "
        f"{median(times) * 1e3:.1f} ms/step over {TRAIN_STEPS} steps (host clock, "
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

def phase_device_and_build():
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
    sync()


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
        phase_device_and_build()
        kern = phase_kernels(dev)
        kern.update(phase_backward(dev))
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            counts, demo = phase_serve_and_count(dev, tmp)
            phase_full_width_f32(demo)
            counts.update({k: v for k, v in phase_train(dev, tmp).items() if k.endswith("_bwd")})
            phase_full_width_train_f32(demo)
        log(f"all phases in {time.perf_counter() - t_start:.1f} s")
    except Exception:
        traceback.print_exc()
        return 1
    kernels = [{
        "name": name, "route": "cuda", "source": SOURCES[name],
        "replaces": REPLACES[name], "launches": counts[name],
        "max_abs_err": kern[name]["max_abs_err"], "ms": kern[name]["ms"],
        "plain_ms": kern[name]["plain_ms"],
    } for name in REPLACES]
    log(json.dumps({"kernels": kernels}))
    log(smi_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
