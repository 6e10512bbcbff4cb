"""Profiling hooks.

Counterpart of ``r3d_tpu/utils/profiling.py`` on ``torch.profiler``:
``profile_trace`` records the host's operators and, where a card is
present, its kernels, and writes a Chrome trace (``trace.json``, which
Perfetto and ``chrome://tracing`` open) into ``log_dir`` when the region
ends; ``annotate`` names a region inside it. Disabled, it records and
writes nothing.
"""

from __future__ import annotations

import contextlib
import os

import torch
from torch.profiler import ProfilerActivity, profile, record_function

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def profile_trace(log_dir: str, enabled: bool = True):
    """``with profile_trace(d): run_steps()`` -> ``d/trace.json``; yields the
    profiler (None when disabled)."""
    if not enabled:
        yield None
        return
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()   # the region's kernels end inside the trace
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def annotate(name: str):
    """A named region inside a trace (a range on its timeline)."""
    return record_function(name)
