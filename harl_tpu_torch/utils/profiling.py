"""Profiling hooks (counterpart of ``harl_tpu/utils/profiling.py``): a
``torch.profiler`` trace over training iterations, written as a Chrome
trace under a directory, and wall-clock phase timers."""
from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile


def start_trace(log_dir: str, device: torch.device) -> profile:
    """Start tracing the host and, on a CUDA device, the card; pass the
    returned profiler to ``stop_trace``."""
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.__enter__()
    prof.trace_dir = log_dir
    return prof


def stop_trace(prof: profile) -> str:
    """Stop ``prof`` and write its Chrome trace (view in chrome://tracing or
    Perfetto) as ``<log_dir>/trace_<pid>_<time>.json``; returns its path."""
    prof.__exit__(None, None, None)
    os.makedirs(prof.trace_dir, exist_ok=True)
    path = os.path.join(prof.trace_dir,
                        f"trace_{os.getpid()}_{time.strftime('%Y%m%d_%H%M%S')}.json")
    prof.export_chrome_trace(path)
    return path


class PhaseTimer:
    """Accumulates wall-clock per phase; ``timings()`` returns averages.
    ``sync`` (e.g. ``torch.cuda.synchronize``) is called at each phase's
    start and end, so a phase's time holds its device work."""

    def __init__(self, sync=None):
        self.totals = {}
        self.counts = {}
        self.sync = sync or (lambda: None)

    @contextlib.contextmanager
    def phase(self, name: str):
        self.sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.sync()
            self.totals[name] = self.totals.get(name, 0.0) + time.perf_counter() - t0
            self.counts[name] = self.counts.get(name, 0) + 1

    def timings(self):
        return {k: self.totals[k] / max(self.counts[k], 1) for k in self.totals}
