"""Tracing and step-time instrumentation (port of
simple_multimodal_tpu/utils/profiling.py).

``trace(log_dir)`` records the enclosed region with ``torch.profiler`` (CPU
activity, and CUDA activity where a card is present) and writes a Chrome
trace (viewable in Perfetto or chrome://tracing) into ``log_dir``; it
yields the profiler, whose ``key_averages()`` sum the time by kernel.
``annotate(name)`` names a region in such a trace (``record_function``)
and, on the card, as an NVTX range. ``StepTimer`` keeps rolling step-time
statistics on the host clock; ``memory_stats`` reads each card's memory.
"""
import contextlib
import os
import time
from typing import Dict, List, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed region and write ``trace_<time>_<pid>.json``
    (Chrome trace format) into ``log_dir``; yields the profiler."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    name = f"trace_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}.json"
    prof.export_chrome_trace(os.path.join(log_dir, name))


@contextlib.contextmanager
def annotate(name: str):
    """Named region that shows up in captured traces (and in NVTX on the card)."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


class StepTimer:
    """Rolling step-time stats on the host clock. ``tick`` reads the clock
    only; on the card, synchronise before a tick for device-complete times."""

    def __init__(self, window: int = 100):
        self.window = window
        self._times: List[float] = []
        self._last: Optional[float] = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now

    def summary(self) -> Dict[str, float]:
        if not self._times:
            return {}
        ts = sorted(self._times)
        n = len(ts)
        return {
            "steps": n,
            "mean_s": sum(ts) / n,
            "p50_s": ts[n // 2],
            "p90_s": ts[min(int(n * 0.9), n - 1)],
            "max_s": ts[-1],
        }


def memory_stats() -> Dict[str, Dict[str, int]]:
    """Per-card memory: bytes allocated now and at peak by PyTorch's
    allocator, and the card's total; {} on a host with no card."""
    if not torch.cuda.is_available():
        return {}
    out = {}
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        _, total = torch.cuda.mem_get_info(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": s.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": s.get("allocated_bytes.all.peak", 0),
            "bytes_limit": total,
        }
    return out
