"""Profiling / tracing utilities: a device trace around a block and named
phase timers feeding the RTF report's format.

JAX counterpart: ``f5_tts_tpu/utils/profiling.py`` (``jax.profiler`` xplane
traces there; ``torch.profiler`` with CUDA activity here, written as a
Chrome trace).  ``PhaseTimer`` is unchanged.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Trace the enclosed block with ``torch.profiler`` (CPU activity, and
    CUDA activity where a card is present) and write it as a Chrome trace,
    ``<log_dir>/trace.json``; yields the profiler (``key_averages()`` reads
    the per-kernel times)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"trace written to {path}")


class PhaseTimer:
    """Named phase accumulator: preprocess / dit / vocoder / transfer split
    like the reference's DiT-vs-vocoder report (benchmark.py:461-462)."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> dict:
        return {
            name: {"total_s": round(t, 4), "count": self.counts[name],
                   "mean_ms": round(t / max(self.counts[name], 1) * 1e3, 2)}
            for name, t in sorted(self.totals.items())
        }

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.report(), f, indent=2)
