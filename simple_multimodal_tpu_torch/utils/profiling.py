"""Tracing instrumentation (port of simple_multimodal_tpu/utils/profiling.py).

``trace(log_dir)`` records the enclosed region with ``torch.profiler`` (CPU
activity, and CUDA activity where a card is present) and writes a Chrome
trace (viewable in Perfetto or chrome://tracing) into ``log_dir``; it
yields the profiler, whose ``key_averages()`` sum the time by kernel.
``annotate(name)`` is the program's one way to open a span: a region of
such a trace, on the clock of the kernels it launches. ``memory_stats``
reads each card's memory.
"""
import contextlib
import os
import time
from typing import Dict

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


_NO_SPAN = contextlib.nullcontext()


def annotate(name: str):
    """A span named ``name``: ``record_function(name)`` while a profiler
    records, so the span is a host event in the profiler's own stream and
    shares the clock of the device activity it launches; with no profiler
    recording it costs one check and enters nothing. Under
    ``torch.autograd.profiler.emit_nvtx()`` the profiler records too, and
    ``record_function`` opens the span as an NVTX range for ``nsys``."""
    if not torch.autograd._profiler_enabled():
        return _NO_SPAN
    return record_function(name)


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
