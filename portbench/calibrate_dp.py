"""Readings that ``base.train_dp4``'s limits are set from, on the cards.

Without ``--program``: the f32 reference of the checked global steps, as
the cell's judge runs it on one card (each rank's block hashed under its
kernel seed, DeBERTa and wav2vec2 recomputed in the backward), against the
same with a fault in the program's place: the float8 control and half of
the global batch left out. One line of JSON a seed, with the reference's
time and peak memory.

    python3 portbench/calibrate_dp.py --seeds 11,12,13

With ``--program``: the program's checked global steps, as
``loops/train_dp.py`` runs them (one process a card over NCCL, the loop's
set-up without its window: one model a rank, fresh seeded weights,
optimizer and step a seed), against that reference, on every seed; and on
the first ``--faults`` seeds the program with its backward's exchange
between the cards left out (each rank steps on its own block's gradient).
The seeds' references then run one a card, side by side. One line of JSON
a seed from the rank that judged it.

    python3 portbench/calibrate_dp.py --program --seeds 11,12,13,14 --faults 2

The benchmark's own runs never run this.
"""
import argparse
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "portbench"))

from portbench import clips, compare, weights  # noqa: E402
from portbench.reference import mesh as ref_mesh  # noqa: E402
from portbench.reference import model as ref  # noqa: E402
from portbench.reference import moonlight as ml  # noqa: E402

import run  # noqa: E402


def reference(cfg, tr, seed, dev, world, first, **kw):
    P = weights.make(ref.spec(cfg), seed, dev)
    start = {n: t.clone() for n, t in P.items()}
    pool = clips.train_pool(cfg, tr, seed, dev)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False), ref_mesh.ranks(world):
        torch.backends.cuda.matmul.allow_tf32 = False
        r = ml.train(cfg, P, [clips.take(pool, rows) for rows in first],
                     torch.Generator().manual_seed(seed), text=ml.deberta_text, replay=True, **kw)
    r["delta"] = {n: float((P[n] - start[n]).double().norm()) for n in P}
    return r


def program_steps(ctx, model, config, mesh, seed, fault=False):
    """The program's checked global steps from the seed's weights, as
    ``loops/train_dp.py`` runs them: rank 0's check numbers. ``fault``:
    the backward's gradients are not reduced over the data group."""
    from portbench.reference import model as ref
    from simple_multimodal_tpu_torch.train import steps as program
    from simple_multimodal_tpu_torch.train.optim import make_optimizer
    from simple_multimodal_tpu_torch.train.state import TrainState

    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    mine = mesh.rows(tr["batch"])
    P0 = weights.make(ref.spec(cfg), seed, dev)
    model.load_state_dict(P0)
    opt = make_optimizer(config, model, cfg["total_steps"])
    step = program.make_train_step(model, opt, config, augment=True,
                                   compute_contrastive_loss=True, mesh=mesh)
    state = TrainState(step=0, generator=torch.Generator().manual_seed(seed))
    pool = clips.train_pool(cfg, tr, seed, dev)
    first, _ = clips.train_rows(tr, seed)
    backward = program._backward
    if fault:
        program._backward = lambda loss, optimizer, mesh=None: backward(loss, optimizer, None)
    try:
        prog = {"loss": []}
        for i, rows in enumerate(first):
            state, parts = step(state, clips.take(pool, rows[mine]))
            prog["loss"].append(float(parts["total_loss"]))
            if i == 0:
                prog["grad"] = {n: float(m.double().norm()) / (1.0 - opt.b1)
                                for n, m in zip(opt.names, opt.mu)}
        prog["delta"] = {n: float((p.detach() - P0[n]).double().norm())
                         for n, p in zip(opt.names, opt.params)}
    finally:
        program._backward = backward
    del P0, opt, step, state, parts, pool
    ctx.free()
    return prog


def program_rank(args, rank, world, port):
    """One rank: the program's steps on every seed (and the faults), then
    the references of its share of the seeds on its own card."""
    import torch.distributed as dist

    from portbench import harness
    from simple_multimodal_tpu_torch.models.multimodal_model import create_model
    from simple_multimodal_tpu_torch.parallel.mesh import (initialize_distributed, make_mesh,
                                                           shutdown_distributed)

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell, cfg, tr, limits = run.cell_files(bench, "base.train_dp4")
    if args.config:
        cfg = json.loads(Path(args.config).read_text())
    dev = torch.device(f"cuda:{rank}" if args.device == "cuda" else args.device)
    ctx = harness.Context(args=None, cell=cell, cfg=cfg, traffic=tr, limits=limits,
                          start=time.perf_counter(), device=dev, root=ROOT)
    seeds = [int(s) for s in args.seeds.split(",")]
    initialize_distributed(f"localhost:{port}", world, rank, device=str(dev))
    host = dist.new_group(backend="gloo")
    mesh = make_mesh((world, 1), device=str(dev))
    config = ctx.program_config()
    model = create_model(config, "standard", device=dev)
    progs = {}
    for k, seed in enumerate(seeds):
        t0 = time.perf_counter()
        progs[seed] = {"program": program_steps(ctx, model, config, mesh, seed)}
        if k < args.faults:
            progs[seed]["no_allreduce"] = program_steps(ctx, model, config, mesh, seed, True)
        progs[seed]["program_seconds"] = time.perf_counter() - t0
    del model
    ctx.free()
    box = [progs]
    dist.broadcast_object_list(box, 0, group=host)  # rank 0's numbers to every rank
    progs = box[0]
    dist.barrier(group=host)
    dist.destroy_process_group(host)
    shutdown_distributed()
    for seed in seeds[rank::world]:
        first, _ = clips.train_rows(tr, seed)
        t0 = time.perf_counter()
        f32 = reference(cfg, tr, seed, dev, world, first)
        out = {"seed": seed, "limits": limits, "rank": rank,
               "program_seconds": progs[seed].pop("program_seconds"),
               "f32_seconds": time.perf_counter() - t0}
        for label, prog in progs[seed].items():
            out[label], _ = compare.train(prog, f32)
        del f32
        ctx.free()
        print(json.dumps(out), flush=True)


def program(args, argv):
    """Rank 0: start ranks 1…world−1 as processes of this file, run, wait."""
    world = args.world
    if args.rank is not None:
        program_rank(args, args.rank, world, args.port)
        return
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    children = [subprocess.Popen([sys.executable, __file__, *argv, "--rank", str(r),
                                  "--port", str(port)], cwd=ROOT)
                for r in range(1, world)]
    try:
        program_rank(args, 0, world, port)
    finally:
        codes = [c.wait(timeout=1800) for c in children]
    if any(codes):
        raise SystemExit(f"calibrate_dp: ranks exited with {codes}")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--config", help="a configuration file in the cell's place (a rehearsal)")
    ap.add_argument("--program", action="store_true",
                    help="the program's steps on every seed, its faults on the first")
    ap.add_argument("--faults", type=int, default=3,
                    help="with --program: seeds (the first) to read the no-exchange fault on")
    ap.add_argument("--world", type=int, default=4, help="with --program: ranks (cards)")
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell, cfg, tr, limits = run.cell_files(bench, "base.train_dp4")
    if args.config:
        cfg = json.loads(Path(args.config).read_text())
    os.environ.update({k: str(v) for k, v in cfg.get("env", {}).items()})
    os.environ["USE_FLAX"] = "0"
    if cfg.get("torch_threads"):
        torch.set_num_threads(int(cfg["torch_threads"]))
    if args.program:
        program(args, argv)
        return
    dev = torch.device(args.device)
    for seed in (int(s) for s in args.seeds.split(",")):
        first, _ = clips.train_rows(tr, seed)
        t0 = time.perf_counter()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        f32 = reference(cfg, tr, seed, dev, cell["chips"], first)
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        out = {"seed": seed, "limits": limits, "f32_seconds": time.perf_counter() - t0,
               "memory_peak_bytes": peak}
        for label, kw in {"control": dict(precision="fp8"),
                          "half_batch": dict(rows=slice(0, tr["batch"] // 2))}.items():
            out[label], _ = compare.train(reference(cfg, tr, seed, dev, cell["chips"], first,
                                                    **kw), f32)
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
