"""Data-parallel train steps on the cell's cards: one process a card, the
port's (d, 1) mesh over NCCL (``parallel/mesh.py``), each rank running
``make_train_step`` under the mesh on its rows of the global batch.

The run's own process is rank 0; it starts ranks 1…d−1 as processes of
this file (``python3 portbench/loops/train_dp.py --rank r ...``, the
cell's files handed over in ``build/portbench/dp_cell_<port>.json``), which
join it at a free local port, run the same steps and print nothing on
stdout. Every rank makes the same model, seeded weights, optimizer and
clip pool; a global batch's rows are drawn as ``train_step.py`` draws a
batch's, and rank r keeps block r of them (``Mesh.rows``). The window ends
on rank 0's clock: after every step rank 0 says over a host (gloo) group
whether the window is over, so that every rank stops at the same step.
With ``--trace 1`` every rank runs the traced steps and rank 0 traces its
own (``layer_spans.profile_segment``). Throughput counts the global batch;
the model FLOP (for ``mfu.train``) and the rooflines are rank 0's own
rows', a share of one card.

After the steps every rank frees its state and leaves the group, and rank
0 runs the reference on its card: the same checked global steps at the
global batch, in f32, with InfoNCE over all its rows and each rank's block
hashed under that rank's kernel seed (``reference/mesh.py``); DeBERTa and
wav2vec2 are recomputed in the backward so that it fits.
"""
import argparse
import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

HERE = Path(__file__).resolve()
ROOT = HERE.parents[2]


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run(ctx):
    """Rank 0: start the other ranks, run, then judge."""
    world = ctx.cell["chips"]
    port = _free_port()
    cell = ctx.root / "build" / "portbench" / f"dp_cell_{port}.json"
    cell.parent.mkdir(parents=True, exist_ok=True)
    cell.write_text(json.dumps({"cell": ctx.cell, "cfg": ctx.cfg, "traffic": ctx.traffic,
                                "limits": ctx.limits}))
    args = ["--cell", str(cell), "--seed", str(ctx.seed), "--seconds",
            str(ctx.seconds), "--trace", str(int(ctx.tracing)), "--world", str(world),
            "--port", str(port), "--device", ctx.device.type]
    children = [subprocess.Popen([sys.executable, str(HERE), "--rank", str(r)] + args,
                                 cwd=ROOT, stdout=sys.stderr) for r in range(1, world)]
    done = threading.Event()

    def watch():  # a rank that fails would leave the others waiting in a collective
        while not done.wait(1.0):
            if any(c.poll() not in (None, 0) for c in children):
                print("portbench: a rank failed; stopping the run", file=sys.stderr, flush=True)
                for c in children:
                    c.kill()
                os._exit(1)

    threading.Thread(target=watch, daemon=True).start()
    try:
        prog, first = rank_loop(ctx, 0, world, port)
    finally:
        done.set()
    for c in children:
        if c.wait(timeout=300) != 0:
            raise SystemExit(f"portbench: rank exited with {c.returncode}")
    cell.unlink()
    judge(ctx, prog, first, world)


def rank_loop(ctx, rank, world, port):
    """One rank's set-up, checked steps, window and traced steps. → (the
    program's check numbers, the checked steps' global rows) on rank 0."""
    import torch
    import torch.distributed as dist
    from torch.profiler import record_function

    from portbench import clips, flops, layer_spans, weights
    from portbench.reference import model as ref
    from simple_multimodal_tpu_torch.models.multimodal_model import create_model
    from simple_multimodal_tpu_torch.parallel.mesh import (initialize_distributed, make_mesh,
                                                           shutdown_distributed)
    from simple_multimodal_tpu_torch.train.optim import make_optimizer
    from simple_multimodal_tpu_torch.train.state import TrainState
    from simple_multimodal_tpu_torch.train.steps import make_train_step

    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    B = tr["batch"]
    initialize_distributed(f"localhost:{port}", world, rank, device=str(dev))
    host = dist.new_group(backend="gloo")
    mesh = make_mesh((world, 1), device=str(dev))
    mine = mesh.rows(B)
    config = ctx.program_config()
    model = create_model(config, "standard", device=dev)
    P0 = weights.make(ref.spec(cfg), ctx.seed, dev)
    model.load_state_dict(P0)
    opt = make_optimizer(config, model, cfg["total_steps"])
    step = make_train_step(model, opt, config, augment=True, compute_contrastive_loss=True,
                           mesh=mesh)
    state = TrainState(step=0, generator=torch.Generator().manual_seed(ctx.seed))
    pool = clips.train_pool(cfg, tr, ctx.seed, dev)
    first, rest = clips.train_rows(tr, ctx.seed)

    def take(rows):
        return clips.take(pool, rows[mine])

    prog = {"loss": []}
    for i, rows in enumerate(first):
        state, parts = step(state, take(rows))
        prog["loss"].append(float(parts["total_loss"]))
        if i == 0:
            prog["grad"] = {n: float(m.double().norm()) / (1.0 - opt.b1)
                            for n, m in zip(opt.names, opt.mu)}
    prog["delta"] = {n: float((p.detach() - P0[n]).double().norm())
                     for n, p in zip(opt.names, opt.params)}
    del P0
    for _ in range(tr["warmup_steps"]):
        state, parts = step(state, take(next(rest)))
    ctx.reset_peak()
    ctx.setup_done()

    losses, n = [], 0
    stop = torch.zeros(1, dtype=torch.int32)
    t0 = time.perf_counter()
    while True:
        with record_function("portbench.step"):
            state, parts = step(state, take(next(rest)))
        losses.append(parts["total_loss"])
        n += 1
        stop[0] = int(rank == 0 and time.perf_counter() - t0 >= ctx.seconds)
        dist.broadcast(stop, 0, group=host)
        if stop[0]:
            break
    ctx.sync()
    ctx.window_s = time.perf_counter() - t0
    finite = torch.isfinite(torch.stack(losses)).cpu().numpy()
    ctx.attempted, ctx.failed = n, int((~finite).sum())
    done = int(finite.sum())
    ctx.clips = done * B
    work = flops.train_step(cfg, B // world)
    ctx.flops_done = done * work["total"]
    ctx.work = work

    if ctx.tracing:
        holder = {"state": state}

        def one():
            with record_function("portbench.step"):
                holder["state"], _ = step(holder["state"], take(next(rest)))

        if rank == 0:
            before = getattr(mesh, "reduced_bytes", None)  # a program may lack the counter
            layer_spans.profile_segment(ctx, one, tr["traced_steps"])
            if before is not None:
                per_step = (mesh.reduced_bytes - before) / (tr["traced_steps"] + 1)
                ctx.info.append(f"all-reduce: {per_step!r} bytes a traced step (the program's "
                                f"counter)")
        else:
            for _ in range(tr["traced_steps"] + 1):
                one()
            ctx.sync()
    ctx.read_peak()
    del model, opt, step, state, parts, losses, pool
    ctx.free()
    dist.barrier(group=host)
    dist.destroy_process_group(host)
    shutdown_distributed()
    return prog, first


def judge(ctx, prog, first, world):
    """The reference's checked global steps on rank 0's card."""
    import torch

    from portbench import clips, compare, weights
    from portbench.reference import mesh as ref_mesh
    from portbench.reference import model as ref
    from portbench.reference import moonlight as ml

    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    ctx.card_line()
    P = weights.make(ref.spec(cfg), ctx.seed, dev)
    start = {n: t.clone() for n, t in P.items()}
    pool = clips.train_pool(cfg, tr, ctx.seed, dev)
    batches = [clips.take(pool, rows) for rows in first]
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False), ref_mesh.ranks(world):
        matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            r = ml.train(cfg, P, batches, torch.Generator().manual_seed(ctx.seed),
                         text=ml.deberta_text, replay=True)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
    r["delta"] = {n: float((P[n] - start[n]).double().norm()) for n in P}
    numbers, info = compare.train(prog, r)
    ctx.info += info
    for name, value in numbers.items():
        ctx.check(name, value)
    ctx.decide()
    ctx.info.append(f"train window: {ctx.attempted} global steps of {tr['batch']} clips on "
                    f"{world} ranks in {ctx.window_s!r} s; {ctx.work['total']:.6e} model FLOP "
                    f"a step on rank 0's rows")


def main():
    """A rank other than 0, started by ``run``."""
    ap = argparse.ArgumentParser()
    for name in ("--cell", "--device"):
        ap.add_argument(name, required=True)
    for name in ("--rank", "--world", "--port", "--seed", "--trace"):
        ap.add_argument(name, type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    files = json.loads(Path(args.cell).read_text())
    cfg = files["cfg"]
    os.environ.update({k: str(v) for k, v in cfg.get("env", {}).items()})
    os.environ["USE_FLAX"] = "0"
    import torch

    from portbench import harness

    if cfg.get("torch_threads"):
        torch.set_num_threads(int(cfg["torch_threads"]))
    device = torch.device(f"cuda:{args.rank}" if args.device == "cuda" else args.device)
    ctx = harness.Context(args=args, cell=files["cell"], cfg=cfg, traffic=files["traffic"],
                          limits=files["limits"], start=time.perf_counter(), device=device,
                          root=ROOT)
    rank_loop(ctx, args.rank, args.world, args.port)


if __name__ == "__main__":
    main()
