"""Arithmetic that several metric readers share."""
import numpy as np

from portbench import flops


def percentile_ms(ctx, q):
    """The q-th percentile of every request latency of the window, in ms."""
    if not ctx.latencies:
        return None
    return float(np.percentile(np.asarray(ctx.latencies) * 1e3, q))


def idle_pct(ctx):
    """Share of the traced window in which no device activity ran."""
    t = ctx.trace
    if t is None or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def mfu_pct(ctx):
    """Model FLOP of the window's completed steps over the window and the peak."""
    if not ctx.flops_done or not ctx.window_s:
        return None
    return 100.0 * ctx.flops_done / ctx.window_s / flops.PEAK_FLOPS


def roofline_pct(ctx, kind, family):
    """The least time the chip could take for the traced steps' ``kind``
    products (operations over the peak) over the device time of the
    kernels the family table puts in ``family``."""
    t = ctx.trace
    if t is None or not ctx.work or kind not in ctx.work:
        return None
    busy = t["by_family"].get(family, 0.0)
    if busy <= 0:
        return None
    return 100.0 * ctx.work[kind] * ctx.traced_units / flops.PEAK_FLOPS / busy
