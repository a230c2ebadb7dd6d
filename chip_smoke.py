#!/usr/bin/env python3
"""Smoke run of the PyTorch port (simple_multimodal_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one NVIDIA H100 (sm_90a) and nvcc. Phases, each ending in
``torch.cuda.synchronize()``:

1. device and build: the card's name and power limit, the torch/CUDA
   versions, the kernels built from ``csrc/`` (seconds printed);
2. each Hopper kernel against its plain PyTorch version at the main path's
   shapes (base preset, B=8), in bf16 (atol=rtol=3e-2: bf16 rounding of
   q/k/v, probabilities, the FFN intermediate and the output) and in f32
   (atol=rtol=1e-3: only the summation order differs), with CUDA-event
   medians of kernel and plain, interleaved plain, kernel, kernel, plain;
3. serve: the base-preset hierarchical bf16 model built from a seeded
   generator, saved, loaded through MultimodalEmotionDemo, three requests
   through ``predict`` and one B=8 forward;
4. counts: one B=8 forward must launch attention_block 23 times,
   ffn_block 35 times and deberta_attention 12 times;
5. full width in context: one request in f32 on the card (kernels, TF32
   off) against the CPU (plain versions) with the same weights, at
   atol=rtol=1e-3.

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
REPLACES = {
    "attention_block": "simple_multimodal_tpu/ops/pallas/attention_block.py:165",
    "ffn_block": "simple_multimodal_tpu/ops/pallas/ffn_block.py:136",
    "deberta_attention": "simple_multimodal_tpu/ops/pallas/deberta_attention.py:282",
}
EXPECTED_LAUNCHES = {"attention_block": 23, "ffn_block": 35, "deberta_attention": 12}


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
        phase_device_and_build()
        kern = phase_kernels(dev)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            counts, demo = phase_serve_and_count(dev, tmp)
            phase_full_width_f32(demo)
    except Exception:
        traceback.print_exc()
        return 1
    kernels = [{
        "name": name, "route": "cuda",
        "source": f"simple_multimodal_tpu_torch/csrc/{name}.cu",
        "replaces": REPLACES[name], "launches": counts[name],
        "max_abs_err": kern[name]["max_abs_err"], "ms": kern[name]["ms"],
        "plain_ms": kern[name]["plain_ms"],
    } for name in EXPECTED_LAUNCHES]
    log(json.dumps({"kernels": kernels}))
    log(smi_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
