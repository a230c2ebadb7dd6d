"""Readings that the cells' limits are set from, other than the program's
own (which every run prints): the control, the plain reference computed
with float8 products (per-tensor scales) put in the program's place, and
for the train cells the planted faults, the reference in the program's
place again: "half of the batch left out, the mean taken over the rest",
"every LayerNorm bias left unchanged" and "the emotion head's update
doubled" (faults confined to small leaves).
Each is compared with the float32 reference by the numbers of
``compare.py``, at the cell's own size, one line of JSON per seed.

    python3 portbench/calibrate.py --workload base.train --seeds 11,12,13 [--only half_batch]

The benchmark's own runs never run this.
"""
import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench import clips, compare, weights  # noqa: E402
from portbench.reference import frozen  # noqa: E402
from portbench.reference import model as ref  # noqa: E402
from portbench.reference import step as ref_step  # noqa: E402


def small_leaf_faults(cfg):
    """{label: gains} of the faults confined to small leaves."""
    init = {n: i for n, _, i in ref.spec(cfg)}
    norm_bias = [n for n in init if n.endswith(".bias")
                 and init.get(n[:-len("bias")] + "weight") == ("ones",)]
    head = [n for n in init if n.startswith("classifier.")]
    return {"norm_bias_frozen": dict.fromkeys(norm_bias, 0.0), "head_gain": dict.fromkeys(head, 2.0)}


def train_readings(cfg, traffic, seed, device, only=None):
    first, _ = clips.train_rows(traffic, seed)
    pool = clips.train_pool(cfg, traffic, seed, device)
    batches = [clips.take(pool, rows) for rows in first]
    faults = [("control", {"precision": "fp8"}),
              ("half_batch", {"rows": slice(0, traffic["batch"] // 2)})]
    faults += [(label, {"gains": g}) for label, g in small_leaf_faults(cfg).items()]
    faults = [(label, kw) for label, kw in faults if only is None or label in only]
    runs = {}
    for label, kw in [("f32", {})] + faults:
        P = weights.make(ref.spec(cfg), seed, device)
        start = {n: t.clone() for n, t in P.items()}
        r = ref_step.train(cfg, P, batches, torch.Generator().manual_seed(seed), **kw)
        r["delta"] = {n: float((P[n] - start[n]).double().norm()) for n in P}
        runs[label] = r
        del P, start
    out = {}
    for label, _ in faults:
        numbers, info = compare.train(runs[label], runs["f32"])
        out[label] = numbers
        out[label + "_info"] = info
    return out


def serve_readings(cfg, traffic, seed, device, only=None):
    reqs = clips.requests(cfg, traffic, seed)
    rng = np.random.default_rng([seed, 5])
    picks = list(rng.choice(len(reqs), min(traffic["checked"], len(reqs)), replace=False))
    picks.append(max(range(len(reqs)), key=lambda i: len(reqs[i][1])))
    P = weights.make(ref.spec(cfg), seed, device)
    answers = {"f32": [], "fp8": []}
    with torch.no_grad():
        for i in picks:
            text, audio, video = reqs[i]
            ids, mask = (torch.from_numpy(x)[None].to(device)
                         for x in frozen.tokenize(text, cfg["program"]["text_max_length"]))
            wav = torch.from_numpy(audio.astype(np.float32) / 32768.0)[None].to(device)
            frames = torch.from_numpy(video)[None].to(device).float() / 255.0
            for precision in answers:
                o = ref.forward(ref.Run(precision=precision), P, cfg, ids, mask, wav, frames)
                answers[precision].append({"probs": o["probs"][0].tolist(),
                                           "valence": float(o["valence"][0]),
                                           "arousal": float(o["arousal"][0])})
    numbers, info = compare.serve(answers["fp8"], answers["f32"])
    return {"control": numbers, "control_info": info}


def main(argv=None, device="cuda"):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--only", help="comma-separated faults to read (default: all)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "portbench"))
    import run

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    _, cfg, traffic, limits = run.cell_files(bench, args.workload)
    readings = train_readings if traffic["loop"] == "train_step" else serve_readings
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = []
    for seed in (int(s) for s in args.seeds.split(",")):
        r = readings(cfg, traffic, seed, torch.device(device),
                     only=args.only.split(",") if args.only else None)
        r.update(workload=args.workload, seed=seed, limits=limits)
        print(json.dumps(r), flush=True)
        out.append(r)
    return out


if __name__ == "__main__":
    main()
