"""Host spans, and the reading of a profiler trace.

``Spans`` records the harness's own spans (name, start, end, info) on the
host clock, around the calls into each layer of the program, with their wall
clock times, so the trace can say what the host was doing in a gap of the
device.

``Trace`` runs ``torch.profiler`` over a bounded slice of a window and
reduces it to what the per-layer metrics read: the device operations
(kernels, copies, sets) with their names and intervals, the busy time (the
union of their intervals), the slice's length, the operations that took
most time grouped by name, and the longest idle gaps by the innermost
harness span the host was in.
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch

class Spans:
    """The harness's spans: (name, start, end, info, wall start ns, wall end
    ns), start and end on ``time.perf_counter``, the wall clock the one the
    profiler stamps its device operations with."""

    def __init__(self):
        self.items: list[tuple] = []
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, name: str, **info):
        w0, t0 = time.time_ns(), time.perf_counter()
        try:
            yield info
        finally:
            t1, w1 = time.perf_counter(), time.time_ns()
            with self._lock:
                self.items.append((name, t0, t1, info, w0, w1))

    def of(self, name: str, lo: float = float("-inf")):
        """The spans called ``name`` that start at ``lo`` or later."""
        return [s for s in self.items if s[0] == name and s[1] >= lo]


def _union(intervals):
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


class Trace:
    """``with Trace(spans, device) as tr: ...`` profiles the device
    operations of the block (CUPTI only: no host operator is recorded, so the
    host runs as it does untraced); ``tr.summary`` reduces them after the
    window.  ``enter`` and ``exit`` may run on another thread than the work.
    With a ``device`` the block starts and ends with a synchronisation."""

    def __init__(self, spans: Spans | None = None, device=None):
        self.spans = spans
        self.device = device
        self._summary: dict | None = None

    def __enter__(self):
        act = torch.profiler.ProfilerActivity
        # CUDA only on the card; the CPU's (a run without a card, in tests) records no device
        self.prof = torch.profiler.profile(
            activities=[act.CUDA if torch.cuda.is_available() else act.CPU])
        if self.device is not None:
            torch.cuda.synchronize(self.device)
        self.prof.__enter__()
        self.t0, self.w0 = time.perf_counter(), time.time_ns()
        return self

    def __exit__(self, *exc):
        if self.device is not None:
            torch.cuda.synchronize(self.device)
        self.t1, self.w1 = time.perf_counter(), time.time_ns()
        self.prof.__exit__(*exc)
        return False

    @property
    def summary(self) -> dict:
        """The reduction, made on first use (after the window: reading the
        trace takes host seconds)."""
        if self._summary is None:
            events = self.prof.profiler.kineto_results.events()
            host = [] if self.spans is None else self.spans.items
            self._summary = reduce(events, host, self.w0 * 1e-9, self.w1 * 1e-9)
            del self.prof
        return self._summary


def reduce(events, host, lo: float, hi: float) -> dict:
    """The trace's device operations (kernels, copies, sets), cut to the
    traced window [lo, hi] (wall seconds), and the harness's spans -> the
    summary."""
    ops = []
    for e in events:
        if e.device_type().name != "CUDA" or e.is_user_annotation():
            continue
        a, b = max(e.start_ns() * 1e-9, lo), min(e.end_ns() * 1e-9, hi)
        if b > a:
            ops.append((e.name(), a, b))
    window_s = hi - lo
    busy = _union([(a, b) for _, a, b in ops])
    by_name: dict[str, float] = {}
    for name, a, b in ops:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    spans = [(h[0], h[4] * 1e-9, h[5] * 1e-9) for h in host]
    gaps, end = [], None
    for _, a, b in sorted(ops, key=lambda o: o[1]):
        if end is not None and a > end:
            gaps.append((end, a))
        end = b if end is None else max(end, b)
    labelled: dict[str, float] = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        inside = [h for h in spans if h[1] <= mid <= h[2]]
        label = max(inside, key=lambda h: h[1])[0] if inside else "outside every span"
        labelled[label] = labelled.get(label, 0.0) + (b - a)
    idle = sorted(labelled.items(), key=lambda kv: -kv[1])[:10]
    return {"ops": ops, "busy_s": busy, "window_s": window_s, "device_ops": top,
            "idle_gaps": idle}


def kernel_time(summary: dict, pattern: str) -> tuple[float, int]:
    """(seconds, launches) of the device operations whose name holds ``pattern``."""
    t, n = 0.0, 0
    for name, a, b in summary["ops"]:
        if pattern in name:
            t += b - a
            n += 1
    return t, n
