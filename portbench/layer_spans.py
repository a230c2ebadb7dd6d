"""Device time a traced step inside the program's layer spans: the DeepSeek
tower's ``smm.mla`` (a layer's attention), ``smm.moe.route``,
``smm.moe.experts`` and ``smm.moe.shared`` (a MoE layer's parts), and the
mesh's ``smm.allreduce`` (``Mesh.all_reduce_mean_``).

Attributed as ``spans.py`` attributes its parts, with these spans as the
parts: a device interval belongs to the innermost of them around its
runtime launch on the launching thread, or, for a launch inside a backward
node, to the one around the forward op that made the node (its sequence
number on its forward thread). A span that no host event of the window
carries gives no number: a program without it reports nothing.

``profile_segment`` traces a loop's steps as ``harness.profile_segment``
does and keeps this attribution of the same profiler run in
``ctx.layer_spans``; ``per_step_ms(ctx, parts, family)`` is a metric's value.
"""
import collections

from portbench import spans, trace

PARTS = {"smm.mla": "mla", "smm.moe.route": "moe.route", "smm.moe.experts": "moe.experts",
         "smm.moe.shared": "moe.shared", "smm.allreduce": "allreduce"}


def contexts(ops):
    """{op index: (part or None, index of the enclosing backward node or
    None, False)}, as ``spans.contexts`` with this module's parts."""
    out = {}
    by_thread = collections.defaultdict(list)
    for i, op in enumerate(ops):
        by_thread[op.tid].append(i)
    for idx in by_thread.values():
        idx.sort(key=lambda i: (ops[i].start, -ops[i].end))
        stack = []
        for i in idx:
            op = ops[i]
            while stack and stack[-1][0] <= op.start:
                stack.pop()
            part, node, _ = stack[-1][1] if stack else (None, None, False)
            ctx = (PARTS.get(op.name, part), i if op.name.startswith(spans.EVALUATE) else node,
                   False)
            out[i] = ctx
            if op.name in PARTS or op.name.startswith(spans.EVALUATE):
                stack.append((op.end, ctx))
    return out


def attribute(ops, device, window):
    """→ {"steps": train steps in the window, "seen": the parts whose span
    lies in the window, "by_part": {part: {family: s}}}, or None where the
    window holds no ``smm.train_step``."""
    w0, w1 = window
    steps = sum(1 for op in ops if op.name == spans.ROOT and op.end > w0 and op.start < w1)
    if not steps:
        return None
    seen = {PARTS[op.name] for op in ops if op.name in PARTS and op.end > w0 and op.start < w1}
    ctxs = contexts(ops)
    node_parts = spans.backward_parts(ops, ctxs)
    launches = {op.launch: i for i, op in enumerate(ops) if op.launch}
    by_part = collections.defaultdict(lambda: collections.defaultdict(float))
    for d in device:
        if d.end <= w0 or d.start >= w1:
            continue
        i = launches.get(d.corr)
        if i is None:
            continue
        part, node, _ = ctxs[i]
        if part is None and node is not None:
            part = node_parts[node]
        if part is not None:
            by_part[part][trace.family(d.name)] += (min(d.end, w1) - max(d.start, w0)) / 1e9
    return {"steps": steps, "seen": seen,
            "by_part": {p: dict(f) for p, f in by_part.items()}}


def profile_segment(ctx, run_one, units, counter=None):
    """``harness.profile_segment`` (one call to absorb the profiler's start,
    then ``units`` calls inside the window) with the layer spans recorded
    from the same run; ``counter()``, a program counter on the device, is
    read just before and after the window, its growth kept in
    ``ctx.counted``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if ctx.cuda else [])
    with profile(activities=acts) as prof:
        run_one()
        ctx.sync()
        before = None if counter is None else counter().clone()
        with record_function(trace.WINDOW):
            for _ in range(units):
                run_one()
            ctx.sync()
    ctx.trace = trace.from_profiler(prof)
    ctx.traced_units = units
    if counter is not None:
        ctx.counted = (counter() - before).cpu()
    record(ctx, prof)
    fam = ctx.trace["by_family"]
    ctx.info.append("traced device time by family (s): " + ", ".join(
        f"{k} {v:.6f}" for k, v in sorted(fam.items(), key=lambda kv: -kv[1])))


def record(ctx, prof):
    """Keeps ``attribute()`` of the profiler run in ``ctx.layer_spans`` and
    prints the parts' device time a step."""
    ops, device, window = spans.events(prof)
    ctx.layer_spans = s = None if window is None else attribute(ops, device, window)
    if s is None or not s["seen"]:
        ctx.info.append("layer spans: none in the traced window")
        return
    n = s["steps"]
    ctx.info.append("device time a step by layer span (ms): " + "; ".join(
        f"{p} {1e3 * sum(f.values()) / n:.3f} ("
        + ", ".join(f"{k} {1e3 * v / n:.3f}" for k, v in sorted(f.items(), key=lambda kv: -kv[1]))
        + ")" for p, f in sorted(s["by_part"].items())))


def per_step_ms(ctx, parts, family=None):
    """The device time a traced step of ``parts`` (of kernels of
    ``family`` only, if given), in ms; None where none of the parts' spans
    lies in the traced window or nothing ran on a device."""
    s = getattr(ctx, "layer_spans", None)
    if not s or not set(parts) & s["seen"]:
        return None
    total = sum(v for p in parts for k, v in s["by_part"].get(p, {}).items()
                if family is None or k == family)
    return 1e3 * total / s["steps"] if total > 0 else None
