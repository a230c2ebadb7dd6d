"""The program's own spans in the traced segment: device idle by step phase
and device time by model part.

The port opens its spans through ``utils/profiling.py::annotate`` as
``record_function`` events of the same ``torch.profiler`` run that traces
the device, so they share its clock: ``smm.train_step`` around a train
step, ``smm.forward``, ``smm.backward`` and ``smm.optimizer`` inside it,
and in the model's forward ``smm.encode.text`` / ``.audio`` / ``.video``
and ``smm.fuse``.

Idle by phase: the gaps between the union of device intervals in the traced
window (as ``trace.summarize`` finds them), intersected with the phase
spans of the thread that opened ``smm.train_step``; what falls in no phase
(the benchmark's batch gather between steps) is kept apart as ``between``.

Device time by part: each device interval is linked by its correlation id
to the runtime launch that issued it (``cudaLaunchKernel`` and the like, on
the launching thread). A launch inside an ``smm.encode.*`` or ``smm.fuse``
span belongs to that part. A launch inside a backward node
(``autograd::engine::evaluate_function: …``, on the autograd thread)
belongs to the part of the forward op that made the node: the op of the
node's sequence number on its forward thread. The rest is ``optimizer``
inside ``smm.optimizer`` and ``other`` elsewhere. The parts partition the
device time that ``trace.summarize`` sums by name.

``record(ctx, prof)`` reads the profiler run of ``harness.profile_segment``
into ``ctx.spans`` and prints both partitions beside the trace's own sums;
a metric reader returns ``per_step_ms(ctx, kind, key)``.
"""
import bisect
import collections

from portbench import trace

ROOT = "smm.train_step"
PHASES = {"smm.forward": "forward", "smm.backward": "backward", "smm.optimizer": "optimizer"}
PARTS = {"smm.encode.text": "text", "smm.encode.audio": "audio", "smm.encode.video": "video",
         "smm.fuse": "fusion"}
PARTITION = ("text", "audio", "video", "fusion", "optimizer", "other")
EVALUATE = "autograd::engine::evaluate_function: "

# A host event: its interval, name, thread, autograd sequence number (-1:
# none), the forward thread on a backward node (0: none), and for a runtime
# launch the correlation id of the device activity it issued (0: a torch op
# or span).
Op = collections.namedtuple("Op", "start end name tid seq fwd_tid launch")
# A device interval and its correlation id.
Dev = collections.namedtuple("Dev", "start end name corr")


def _is_scope(op):
    return op.name in PARTS or op.name == "smm.optimizer" or op.name.startswith(EVALUATE)


def _gaps(device, window):
    """The idle intervals of the window, as ``trace.summarize`` finds them."""
    w0, w1 = window
    busy = trace.union([(max(s, w0), min(e, w1)) for s, e, *_ in device if e > w0 and s < w1])
    gaps, t = [], w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < w1:
        gaps.append((t, w1))
    return gaps


def _overlap(a, b):
    """Total length of the intersection of two sorted lists of disjoint intervals."""
    i = j = 0
    total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def contexts(ops):
    """{op index: (part or None, index of the enclosing backward node or
    None, inside smm.optimizer)} from the scopes that enclose each event on
    its thread: the part spans, the backward nodes and ``smm.optimizer``
    (record_function scopes, which nest properly on one thread)."""
    out = {}
    by_thread = collections.defaultdict(list)
    for i, op in enumerate(ops):
        by_thread[op.tid].append(i)
    for idx in by_thread.values():
        idx.sort(key=lambda i: (ops[i].start, -ops[i].end))
        stack = []  # (end, context) of the open scopes
        for i in idx:
            op = ops[i]
            while stack and stack[-1][0] <= op.start:
                stack.pop()
            part, node, opt = stack[-1][1] if stack else (None, None, False)
            ctx = (PARTS.get(op.name, part),
                   i if op.name.startswith(EVALUATE) else node,
                   opt or op.name == "smm.optimizer")
            out[i] = ctx
            if _is_scope(op):
                stack.append((op.end, ctx))
    return out


def backward_parts(ops, ctxs):
    """{backward node's op index: the part of the forward op that made the
    node, or None}. The node carries that op's sequence number and thread;
    of the forward ops that took the number, the one that made the node
    started last (the number moves on when a node is made)."""
    creator = {}  # (thread, sequence number) → op index
    for i, op in enumerate(ops):
        if op.seq >= 0 and op.fwd_tid == 0 and not op.launch and not op.name.startswith(EVALUATE):
            key = (op.tid, op.seq)
            if key not in creator or ops[creator[key]].start <= op.start:
                creator[key] = i
    out = {}
    for i, op in enumerate(ops):
        if op.name.startswith(EVALUATE):
            f = creator.get((op.fwd_tid, op.seq))
            out[i] = ctxs[f][0] if f is not None else None
    return out


def attribute(ops, device, window):
    """ops: [Op] of the host; device: [Dev]; window: (start_ns, end_ns).
    → None where no ``smm.train_step`` lies in the window (a program
    without spans), else {"steps", "idle": {forward, backward, optimizer,
    between}, "idle_total", "parts": {text, audio, video, fusion,
    optimizer, other}, "device_total", "other": {phase: s}, "other_names":
    {name: s}, "backward": [device intervals linked to a forward part, of
    those launched in a backward node], "unlinked": device intervals with
    no launch}, in seconds over the window."""
    w0, w1 = window
    roots = [op for op in ops if op.name == ROOT and op.end > w0 and op.start < w1]
    if not roots:
        return None
    tid = roots[0].tid
    phase_spans = sorted((max(op.start, w0), min(op.end, w1), PHASES[op.name]) for op in ops
                         if op.name in PHASES and op.tid == tid and op.end > w0 and op.start < w1)

    gaps = _gaps(device, window)
    idle = {p: _overlap(gaps, [(s, e) for s, e, q in phase_spans if q == p]) / 1e9
            for p in PHASES.values()}
    idle_total = sum(e - s for s, e in gaps) / 1e9
    idle["between"] = idle_total - sum(idle.values())

    ctxs = contexts(ops)
    node_parts = backward_parts(ops, ctxs)
    launches = {op.launch: i for i, op in enumerate(ops) if op.launch}
    starts = [s for s, _, _ in phase_spans]

    def phase_at(t):
        k = bisect.bisect_right(starts, t) - 1
        return phase_spans[k][2] if k >= 0 and t <= phase_spans[k][1] else "between"

    parts = dict.fromkeys(PARTITION, 0.0)
    other, other_names = collections.Counter(), collections.Counter()
    linked = backward = unlinked = 0
    for d in device:
        if d.end <= w0 or d.start >= w1:
            continue
        dt = (min(d.end, w1) - max(d.start, w0)) / 1e9
        i = launches.get(d.corr)
        part = None
        if i is None:
            unlinked += 1
        else:
            part, node, opt = ctxs[i]
            if part is None and node is not None:
                backward += 1
                part = node_parts[node]
                linked += part is not None
            if part is None and opt:
                part = "optimizer"
        if part is None:
            part = "other"
            other[phase_at(ops[i].start if i is not None else d.start)] += dt
            other_names[d.name] += dt
        parts[part] += dt
    return {"steps": len(roots), "idle": idle, "idle_total": idle_total, "parts": parts,
            "device_total": sum(parts.values()), "other": dict(other),
            "other_names": dict(other_names), "backward": [linked, backward],
            "unlinked": unlinked}


def events(prof):
    """(host events, device intervals, window or None) of a finished
    ``torch.profiler.profile``: the window and device intervals that
    ``trace.from_profiler`` takes. A host event with a linked correlation
    id is a runtime launch; its own correlation id is its device
    activity's."""
    from torch.autograd import DeviceType

    ops, device, window = [], [], None
    for ev in prof.profiler.kineto_results.events():
        s, e, n = ev.start_ns(), ev.end_ns(), ev.name()
        if ev.device_type() == DeviceType.CPU:
            if n == trace.WINDOW:
                window = (s, e)
            else:
                launch = ev.correlation_id() if ev.linked_correlation_id() else 0
                ops.append(Op(s, e, n, ev.start_thread_id(), ev.sequence_nr(),
                              ev.fwd_thread_id(), launch))
        elif not (ev.is_user_annotation() or n.startswith(trace.SPAN_PREFIX)):
            device.append(Dev(s, e, n, ev.correlation_id()))
    return ops, device, window


def from_profiler(prof):
    """attribute() of a finished ``torch.profiler.profile``; None where it
    holds no window."""
    ops, device, window = events(prof)
    return None if window is None else attribute(ops, device, window)


def record(ctx, prof):
    """Keeps ``attribute()`` of the traced segment in ``ctx.spans`` and
    prints the partitions beside the trace's own sums."""
    ctx.spans = s = from_profiler(prof)
    if s is None:
        ctx.info.append("program spans: no smm.train_step in the traced window")
        return
    n, t = s["steps"], ctx.trace
    ms = lambda v: f"{1e3 * v / n:.3f}"  # noqa: E731
    ctx.info.append(
        f"program spans: {n} traced steps; device idle a step (ms): "
        + ", ".join(f"{k} {ms(v)}" for k, v in s["idle"].items())
        + f"; sum {ms(s['idle_total'])} against the trace's {ms(t['window_s'] - t['busy_s'])}")
    ctx.info.append(
        "device time a step by part (ms): "
        + ", ".join(f"{k} {ms(v)}" for k, v in s["parts"].items())
        + f"; sum {ms(s['device_total'])} against by_name's {ms(sum(t['by_name'].values()))}"
        + "; device intervals of backward nodes linked to a forward part: {} of {}".format(
            *s["backward"]) + f"; with no launch found: {s['unlinked']}")
    top = sorted(s["other_names"].items(), key=lambda kv: -kv[1])[:8]
    ctx.info.append(
        "device time a step in 'other' by phase (ms): "
        + ", ".join(f"{k} {ms(v)}" for k, v in sorted(s["other"].items()))
        + "; the longest: " + "; ".join(f"{k[:80]} {ms(v)}" for k, v in top))


def per_step_ms(ctx, kind, key):
    """A metric's value: ``ctx.spans[kind][key]`` in ms a traced step, or
    None where the traced segment holds no program spans or no device
    activity (a run without a card)."""
    s = getattr(ctx, "spans", None)
    if not s or s["device_total"] <= 0:
        return None
    return 1e3 * s[kind][key] / s["steps"]
