"""From a ``torch.profiler`` run to the numbers the per-layer metrics read:
the device's busy intervals within the traced window, kernel time by name
and by family (``kernel_families.json``), and the idle gaps labelled by
what the host was doing when each began.

The traced window is the span of the benchmark's own ``portbench.traced``
annotation. Busy time is the union of every device interval (kernels,
copies, sets) clipped to it, so concurrent streams count once.
"""
import bisect
import json
import re
from pathlib import Path

FAMILIES = json.loads((Path(__file__).parent / "kernel_families.json").read_text())["families"]
_PATTERNS = [(name, re.compile(p, re.IGNORECASE)) for name, p in FAMILIES]
SPAN_PREFIX = "portbench."  # the benchmark's own spans around its calls into the program
WINDOW = SPAN_PREFIX + "traced"


def family(kernel):
    for name, pattern in _PATTERNS:
        if pattern.search(kernel):
            return name
    return "other"


def union(intervals):
    """Sorted, merged [(start, end)] of possibly overlapping intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def summarize(device, host, window):
    """device: [(start_ns, end_ns, name)] of device activity; host: [(start_ns,
    end_ns, name)] of host ops; window: (start_ns, end_ns).
    → {"window_s", "busy_s", "by_name": {name: s}, "by_family": {family: s},
    "gaps": [(label, s)]}."""
    w0, w1 = window
    inside = [(max(s, w0), min(e, w1), n) for s, e, n in device if e > w0 and s < w1]
    by_name, by_family = {}, {}
    for s, e, n in inside:
        by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e9
        f = family(n)
        by_family[f] = by_family.get(f, 0.0) + (e - s) / 1e9
    busy = union([(s, e) for s, e, _ in inside])
    gaps, t = [], w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < w1:
        gaps.append((t, w1))
    labels = _label(gaps, host)
    return {"window_s": (w1 - w0) / 1e9, "busy_s": sum(e - s for s, e in busy) / 1e9,
            "by_name": by_name, "by_family": by_family,
            "gaps": [(lab, (e - s) / 1e9) for lab, (s, e) in zip(labels, gaps)]}


def _label(gaps, host):
    """The innermost host op running at each gap's start (the latest-started
    one still open), or "host idle"."""
    events = sorted((s, e, n) for s, e, n in host if n != WINDOW)
    starts = [s for s, _, _ in events]
    out, active, i = [], [], 0
    for g0, _ in gaps:
        j = bisect.bisect_right(starts, g0)
        active.extend(events[i:j])
        i = max(i, j)
        active = [ev for ev in active if ev[1] > g0]
        out.append(max(active)[2] if active else "host idle")
    return out


def breakdown(summary, top=10):
    """The result line's ``breakdown``: the device ops that took most time, and
    the idle time by what the host was doing, each in seconds."""
    ops = sorted(summary["by_name"].items(), key=lambda kv: -kv[1])[:top]
    idle = {}
    for lab, s in summary["gaps"]:
        idle[lab] = idle.get(lab, 0.0) + s
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps]}


def from_profiler(prof):
    """summarize() of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    device, host, window = [], [], None
    for ev in prof.profiler.kineto_results.events():
        s, e, n = ev.start_ns(), ev.end_ns(), ev.name()
        if ev.device_type() == DeviceType.CPU:
            if n == WINDOW:
                window = (s, e)
            else:
                host.append((s, e, n))
        elif not (ev.is_user_annotation() or n.startswith(SPAN_PREFIX)):
            device.append((s, e, n))  # the device-side copies of host spans are not activity
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW} span")
    return summarize(device, host, window)
