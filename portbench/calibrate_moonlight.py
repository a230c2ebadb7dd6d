"""Readings that ``moonlight.train``'s limits are set from, on the card: the
program's checked steps against the f32 reference on many seeds (the
loop's own set-up without its window: one model, fresh seeded weights and
optimizer a seed), and on the first seeds the reference with a fault in
the program's place: the float8 control, half of the batch left out, the
routing without its correction bias, and the routing weights without
``routed_scaling_factor``. One line of JSON a seed, the numbers of
``compare.py`` and the routing mismatch of the loop.

    python3 portbench/calibrate_moonlight.py --seeds 11,12,13 --faults 2

The benchmark's own runs never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "portbench"))

from portbench import clips, compare, harness, weights  # noqa: E402
from portbench.reference import moonlight as ml  # noqa: E402

import run  # noqa: E402


def reference(cfg, tr, seed, dev, first, record=None, bias=True, **kw):
    """The reference's checked steps from the seed's weights; ``bias``
    False zeroes the routers' correction biases."""
    P = weights.make(ml.spec(cfg), seed, dev)
    if not bias:
        for n in P:
            if n.endswith("e_score_correction_bias"):
                P[n].zero_()
    start = {n: t.clone() for n, t in P.items()}
    pool = clips.train_pool(dict(cfg, text={"vocab_size": cfg["vocab_size"]}), tr, seed, dev)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        torch.backends.cuda.matmul.allow_tf32 = False
        r = ml.train(cfg, P, [clips.take(pool, rows) for rows in first],
                     torch.Generator().manual_seed(seed), record=record, **kw)
    r["delta"] = {n: float((P[n] - start[n]).double().norm()) for n in P}
    return r


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--config", help="a configuration file in the cell's place (a rehearsal)")
    ap.add_argument("--faults", type=int, default=3, help="seeds (the first) to read faults on")
    args = ap.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell, cfg, tr, limits = run.cell_files(bench, "moonlight.train")
    if args.config:
        cfg = json.loads(Path(args.config).read_text())
    dev = torch.device(args.device)
    loop = run.load_file(ROOT / "portbench/loops/train_moonlight.py", "loop_moonlight")
    from simple_multimodal_tpu_torch.models.multimodal_model import create_model
    from simple_multimodal_tpu_torch.train.optim import make_optimizer
    from simple_multimodal_tpu_torch.train.state import TrainState
    from simple_multimodal_tpu_torch.train.steps import make_train_step

    ctx = harness.Context(args=None, cell=cell, cfg=cfg, traffic=tr, limits=limits,
                          start=time.perf_counter(), device=dev, root=ROOT)
    config = ctx.program_config()
    model = create_model(config, "standard", device=dev)
    tower = model.text_encoder.model
    loop.check_tower(tower, cfg)
    for k, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        P0 = weights.make(ml.spec(cfg), seed, dev)
        model.load_state_dict(P0)
        opt = make_optimizer(config, model, cfg["total_steps"])
        step = make_train_step(model, opt, config, augment=True, compute_contrastive_loss=True)
        state = TrainState(step=0, generator=torch.Generator().manual_seed(seed))
        pool = clips.train_pool(dict(cfg, text={"vocab_size": cfg["vocab_size"]}), tr, seed, dev)
        first, _ = clips.train_rows(tr, seed)
        prog, choices = {"loss": []}, {}
        for i, rows in enumerate(first):
            hooks = loop.choice_hooks(tower, choices) if i == 0 else []
            state, parts = step(state, clips.take(pool, rows))
            for h in hooks:
                h.remove()
            prog["loss"].append(float(parts["total_loss"]))
            if i == 0:
                prog["grad"] = {n: float(m.double().norm()) / (1.0 - opt.b1)
                                for n, m in zip(opt.names, opt.mu)}
        prog["delta"] = {n: float((p.detach() - P0[n]).double().norm())
                         for n, p in zip(opt.names, opt.params)}
        mask = clips.take(pool, first[0])["text"]["attention_mask"]
        del P0, opt, step, state, parts, pool
        ctx.free()
        ref_choices = {}
        f32 = reference(cfg, tr, seed, dev, first, record=ref_choices)
        out = {"seed": seed, "limits": limits}
        out["program"], _ = compare.train(prog, f32)
        out["routing"] = loop.routing_mismatch(choices, ref_choices, mask)
        if k < args.faults:
            faults = {"control": dict(precision="fp8"),
                      "half_batch": dict(rows=slice(0, tr["batch"] // 2)),
                      "no_bias": dict(bias=False),
                      "no_scale": dict(cfg=dict(cfg, routed_scaling_factor=1.0))}
            for label, kw in faults.items():
                c = kw.pop("cfg", cfg)
                out[label], _ = compare.train(reference(c, tr, seed, dev, first, **kw), f32)
                ctx.free()
        out["seconds"] = time.perf_counter() - t0
        out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        print(json.dumps(out), flush=True)
        ctx.free()


if __name__ == "__main__":
    main()
