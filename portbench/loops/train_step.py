"""Closed loop of train steps through the port's ``make_train_step`` (the
step the trainers run: augmentation, dropout, the contrastive loss, AdamW),
each step's batch gathered on the card from a pool of clips that set-up
placed there, as the trainer's device cache does for a small set.

Set-up builds the model (the port's own initialisation, then the seeded
weights loaded), the optimizer, the step and the pool, and drives that one
step object through the checked first steps on rows that all differ; the
window then goes on with the same object. After the window the program's
state is freed and the reference follows the checked steps from the same
weights, rows and generators.
"""
import time

import torch
from torch.profiler import record_function

from portbench import clips, compare, flops, harness, weights
from portbench.reference import model as ref
from portbench.reference import step as ref_step


def run(ctx):
    from simple_multimodal_tpu_torch.models.multimodal_model import create_model
    from simple_multimodal_tpu_torch.train.optim import make_optimizer
    from simple_multimodal_tpu_torch.train.state import TrainState
    from simple_multimodal_tpu_torch.train.steps import make_train_step

    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    B = tr["batch"]
    config = ctx.program_config()
    model = create_model(config, "standard", device=dev)
    P0 = weights.make(ref.spec(cfg), ctx.seed, dev)
    model.load_state_dict(P0)
    opt = make_optimizer(config, model, cfg["total_steps"])
    step = make_train_step(model, opt, config, augment=True, compute_contrastive_loss=True)
    if ctx.patch:
        opt = ctx.patch("optimizer", opt)
        step = ctx.patch("step", step)
    state = TrainState(step=0, generator=torch.Generator().manual_seed(ctx.seed))
    pool = clips.train_pool(cfg, tr, ctx.seed, dev)
    first, rest = clips.train_rows(tr, ctx.seed)

    prog = {"loss": []}
    for i, rows in enumerate(first):
        state, parts = step(state, clips.take(pool, rows))
        prog["loss"].append(float(parts["total_loss"]))
        if i == 0:
            prog["grad"] = {n: float(m.double().norm()) / (1.0 - opt.b1)
                            for n, m in zip(opt.names, opt.mu)}
    prog["delta"] = {n: float((p.detach() - P0[n]).double().norm())
                     for n, p in zip(opt.names, opt.params)}
    del P0
    for _ in range(tr["warmup_steps"]):
        state, parts = step(state, clips.take(pool, next(rest)))
    ctx.reset_peak()
    ctx.setup_done()

    losses, n = [], 0
    t0 = time.perf_counter()
    while True:
        with record_function("portbench.step"):
            state, parts = step(state, clips.take(pool, next(rest)))
        losses.append(parts["total_loss"])
        n += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    ctx.sync()
    ctx.window_s = time.perf_counter() - t0
    finite = torch.isfinite(torch.stack(losses)).cpu().numpy()
    ctx.attempted, ctx.failed = n, int((~finite).sum())
    done = int(finite.sum())
    ctx.clips = done * B
    work = flops.train_step(cfg, B)
    ctx.flops_done = done * work["total"]
    ctx.work = work

    if ctx.tracing:
        holder = {"state": state}

        def one():
            with record_function("portbench.step"):
                holder["state"], _ = step(holder["state"], clips.take(pool, next(rest)))

        harness.profile_segment(ctx, one, tr["traced_steps"])
    ctx.read_peak()
    ctx.card_line()
    del model, opt, step, state, parts, losses, pool
    ctx.free()

    P = weights.make(ref.spec(cfg), ctx.seed, dev)
    start = {n: t.clone() for n, t in P.items()}
    pool = clips.train_pool(cfg, tr, ctx.seed, dev)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            r = ref_step.train(cfg, P, [clips.take(pool, rows) for rows in first],
                               torch.Generator().manual_seed(ctx.seed))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
    r["delta"] = {n: float((P[n] - start[n]).double().norm()) for n in P}
    numbers, info = compare.train(prog, r)
    ctx.info += info
    for name, value in numbers.items():
        ctx.check(name, value)
    ctx.decide()
    ctx.info.append(f"train window: {n} steps of {B} clips in {ctx.window_s!r} s; "
                    f"{work['total']:.6e} model FLOP a step")
