"""``train_step.py``'s closed loop of train steps, for the configuration with
Moonlight-16B-A3B's decoder as the text tower (``reference/moonlight.py``).

The same set-up, window and check as ``train_step.py``: the model with the
seeded weights loaded, ``make_train_step``, batches gathered on the card
from a pool of clips, the checked first steps on distinct rows, then the
window; after it the program's state is freed and the reference follows
the checked steps from the same weights, rows and generators. What
differs:

- before anything runs, the program's tower is held to the file's numbers
  (widths, depth, router, the expert share), so that the reference and the
  program compute the same configuration;
- the program's routing choices of the first checked step are taken (a
  forward pre-hook on each MoE layer evaluates the layer's own router on
  its input) and the share of the real tokens' (token, slot) choices that
  the f32 reference routes otherwise is printed, not compared: a near-tie
  at the last choice flips under bf16;
- the traced steps run under ``layer_spans.profile_segment``, so that the
  layer spans are read from the profiler's events beside ``trace.py``'s
  summary; the rows each held expert took in the traced steps come from
  the program's counter, read before and after them.
"""
import time

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from portbench import clips, compare, flops_moonlight, layer_spans, weights
from portbench.reference import moonlight as ml

SAME = ("hidden_size", "intermediate_size", "moe_intermediate_size", "num_hidden_layers",
        "num_attention_heads", "kv_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim",
        "v_head_dim", "num_experts_per_tok", "n_shared_experts", "first_k_dense_replace",
        "routed_scaling_factor", "rms_norm_eps", "rope_theta", "vocab_size")


def check_tower(tower, cfg):
    """Raise unless the program's tower is the configuration file's (the
    file's ``router_experts`` is the program's ``n_routed_experts``; its
    ``n_routed_experts`` the experts held)."""
    tc = tower.cfg
    wrong = {k: (cfg[k], getattr(tc, k)) for k in SAME if cfg[k] != getattr(tc, k)}
    if cfg["router_experts"] != tc.n_routed_experts:
        wrong["router_experts"] = (cfg["router_experts"], tc.n_routed_experts)
    if list(tc.held_experts) != list(ml.held(cfg)):
        wrong["held experts"] = (list(ml.held(cfg)), list(tc.held_experts))
    if wrong:
        raise SystemExit(f"the program's text tower is not the configuration's: {wrong}")


def choice_hooks(tower, choices):
    """Pre-hooks that keep each MoE layer's choice [T, k] of the next forward
    in ``choices`` under the reference's layer prefix."""
    from simple_multimodal_tpu_torch.models.deepseek import MoE, route

    hooks = []
    for i, layer in enumerate(tower.layers):
        moe = layer.mlp
        if not isinstance(moe, MoE):
            continue

        def hook(mod, args, key=f"{ml.PREFIX}layers.{i}.mlp."):
            with torch.no_grad():
                h = args[0].reshape(-1, args[0].shape[-1]).float()
                c = mod.cfg
                choices.setdefault(key, route(F.linear(h, mod.gate.weight),
                                              mod.gate.e_score_correction_bias,
                                              c.num_experts_per_tok, c.routed_scaling_factor)[0])

        hooks.append(moe.register_forward_pre_hook(hook))
    return hooks


def routing_mismatch(prog, ref, mask):
    """Share of the real tokens' (token, slot) choices of the program that
    the reference did not make, over every MoE layer."""
    real = mask.reshape(-1).bool()
    differ = total = 0
    for key, p in prog.items():
        r = ref[key]
        p, r = p[real], r[real]
        same = (p[:, :, None] == r[:, None, :]).any(dim=-1)
        differ += int((~same).sum())
        total += same.numel()
    return differ / max(total, 1)


def expert_load(ctx):
    """Prints the rows each held expert took a traced step (the program's counter)."""
    rows = ctx.counted.double() / ctx.traced_units
    ctx.info.append(f"rows a held expert a traced step: mean {rows.mean().item():.1f}, max "
                    f"{rows.max().item():.0f}, min {rows.min().item():.0f} over "
                    f"{rows.shape[0]} MoE layers x {rows.shape[1]} experts")


def run(ctx):
    from simple_multimodal_tpu_torch.models.multimodal_model import create_model
    from simple_multimodal_tpu_torch.train.optim import make_optimizer
    from simple_multimodal_tpu_torch.train.state import TrainState
    from simple_multimodal_tpu_torch.train.steps import make_train_step

    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    B = tr["batch"]
    clip_cfg = dict(cfg, text={"vocab_size": cfg["vocab_size"]})
    config = ctx.program_config()
    model = create_model(config, "standard", device=dev)
    tower = model.text_encoder.model
    check_tower(tower, cfg)
    P0 = weights.make(ml.spec(cfg), ctx.seed, dev)
    model.load_state_dict(P0)
    opt = make_optimizer(config, model, cfg["total_steps"])
    step = make_train_step(model, opt, config, augment=True, compute_contrastive_loss=True)
    if ctx.patch:
        opt = ctx.patch("optimizer", opt)
        step = ctx.patch("step", step)
    state = TrainState(step=0, generator=torch.Generator().manual_seed(ctx.seed))
    pool = clips.train_pool(clip_cfg, tr, ctx.seed, dev)
    first, rest = clips.train_rows(tr, ctx.seed)

    prog, choices = {"loss": []}, {}
    for i, rows in enumerate(first):
        hooks = choice_hooks(tower, choices) if i == 0 else []
        state, parts = step(state, clips.take(pool, rows))
        for h in hooks:
            h.remove()
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
    work = flops_moonlight.train_step(cfg, B)
    ctx.flops_done = done * work["total"]
    ctx.work = work

    if ctx.tracing:
        holder = {"state": state}

        def one():
            with record_function("portbench.step"):
                holder["state"], _ = step(holder["state"], clips.take(pool, next(rest)))

        layer_spans.profile_segment(ctx, one, tr["traced_steps"], counter=tower.routed_rows)
        expert_load(ctx)
    ctx.read_peak()
    ctx.card_line()
    del model, tower, opt, step, state, parts, losses, pool
    ctx.free()

    P = weights.make(ml.spec(cfg), ctx.seed, dev)
    start = {n: t.clone() for n, t in P.items()}
    pool = clips.train_pool(clip_cfg, tr, ctx.seed, dev)
    batches = [clips.take(pool, rows) for rows in first]
    ref_choices = {}
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            r = ml.train(cfg, P, batches, torch.Generator().manual_seed(ctx.seed),
                         record=ref_choices)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
    r["delta"] = {n: float((P[n] - start[n]).double().norm()) for n in P}
    numbers, info = compare.train(prog, r)
    ctx.info += info
    share = routing_mismatch(choices, ref_choices, batches[0]["text"]["attention_mask"])
    ctx.info.append(f"routing: {share!r} of the first checked step's real (token, slot) choices "
                    f"differ from the reference's (printed, not compared)")
    for name, value in numbers.items():
        ctx.check(name, value)
    ctx.decide()
    ctx.info.append(f"train window: {n} steps of {B} clips in {ctx.window_s!r} s; "
                    f"{work['total']:.6e} model FLOP a step")
