"""Profiling and tracing: the program's spans and counters, and a device
trace around a block.

JAX counterpart: ``f5_tts_tpu/utils/profiling.py`` (``jax.profiler`` xplane
traces there; ``torch.profiler`` with CUDA activity here, written as a
Chrome trace).  JAX's ``PhaseTimer`` is the tracer's ``report()`` here.

The tracer.  ``with span(name, **attrs):`` times a block of the program on
the host, and ``count(name, n)`` adds to a counter of the innermost span
open on the calling thread.  Each closed span is a ``Record``: its name, the
thread, the id of its parent span (on the same thread), its start and end
on ``time.time_ns()`` (the wall clock ``torch.profiler`` stamps device
operations with, so a device idle gap can be put down to the span the host
was in), its attributes and its counters.  Records go to a bounded buffer
(``CAPACITY``, the oldest dropped first), read by ``records()`` and emptied
by ``clear()``.

The tracer is on while a ``torch.profiler`` session runs (CUDA-only
sessions too) or between ``enable()`` and ``disable()``.  Off, ``span``
returns one shared no-op context after the flag reads: no clock reading, no
record.  A span only reads the host clock: it never waits for the device,
so it leaves the idle pattern it times as it is.

The spans and counters the program records:

- ``engine.call`` (``infer/engine.py``, per ``generate_batch`` /
  ``generate_batch_from_wavs``; attributes ``entry``, ``b``, ``n``,
  ``durs``), its children ``engine.prepare`` (host assembly; its child
  ``engine.upload``: the noise draw and the uploads, counter ``bytes``),
  ``engine.lock_wait``, ``engine.capture`` (a new key only),
  ``engine.enqueue`` (input copies, the replay or the eager call, the
  output clones; ``sweeps`` under Picard; a replay's counters
  ``<kernel>.launches``, each hand-written kernel's launches in it by its
  ``CudaKernel`` name, such as ``rope_qkv.launches``),
  ``engine.fetch`` (the copies to the host, which wait for the replay;
  counter ``bytes``) and ``engine.trim``;
- ``serve.batch`` (``infer/serve.py``, per batch of ``BatchServer.run``;
  ``rows``, ``real_rows``, ``n``), counters ``serve.frame_rows`` and
  ``serve.useful_frame_rows``;
- ``train.step`` (``train/step.py``; ``b``, ``n``, ``micro``), its children
  ``train.mel``, ``train.cast`` (mixed precision), ``train.forward``,
  ``train.backward``, ``train.norm``, ``train.optimizer`` and ``train.ema``
  (an update only); on a CUDA device its counters are the caching
  allocator's deltas over the step (``ALLOC_COUNTERS``).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import NamedTuple

import torch.autograd.profiler as _autograd_profiler

CAPACITY = 1 << 16  # records kept; the oldest go first
# ``torch.cuda.memory_stats`` keys ``train.step`` records as counters
ALLOC_COUNTERS = ("num_alloc_retries", "num_device_alloc", "num_device_free",
                  "num_sync_all_streams")


class Record(NamedTuple):
    id: int
    name: str
    thread: int
    parent: int | None  # the enclosing span's id on the same thread
    start_ns: int  # time.time_ns()
    end_ns: int
    attrs: dict
    counters: dict


class _Off:
    """The context ``span`` returns while the tracer is off."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False

    def set(self, **attrs):
        pass

    def count(self, name: str, n=1):
        pass


class _Span:
    __slots__ = ("tracer", "name", "attrs", "counters", "id", "parent", "thread", "start")

    def __init__(self, tracer, name, attrs):
        self.tracer, self.name, self.attrs, self.counters = tracer, name, attrs, {}

    def __enter__(self):
        stack = self.tracer._stack()
        self.parent = stack[-1].id if stack else None
        self.id = next(self.tracer._ids)
        self.thread = threading.get_ident()
        stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        stack = self.tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        self.tracer._records.append(Record(self.id, self.name, self.thread, self.parent,
                                           self.start, end, self.attrs, self.counters))
        return False

    def set(self, **attrs):
        """Add attributes known only once the span has started."""
        self.attrs.update(attrs)

    def count(self, name: str, n=1):
        self.counters[name] = self.counters.get(name, 0) + n


class Tracer:
    """Spans and counters into a bounded buffer (module docstring); the
    module's functions are one process-wide instance's."""

    def __init__(self, capacity: int = CAPACITY):
        self._records: collections.deque = collections.deque(maxlen=capacity)
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._enabled = False

    def enable(self) -> None:
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def span(self, name: str, **attrs):
        if not (self._enabled or _autograd_profiler._is_profiler_enabled):
            return _OFF
        return _Span(self, name, attrs)

    def count(self, name: str, n=1) -> None:
        """Add ``n`` to counter ``name`` of the calling thread's innermost
        open span (nothing without one, or while off)."""
        if not (self._enabled or _autograd_profiler._is_profiler_enabled):
            return
        stack = self._stack()
        if stack:
            stack[-1].count(name, n)

    def records(self) -> list[Record]:
        return list(self._records)

    def clear(self) -> None:
        self._records.clear()

    def report(self, records=None) -> dict:
        """Per span name, sorted: ``total_s``, ``count`` and ``mean_ms`` of
        ``records`` (default: the buffer's)."""
        totals: dict = collections.defaultdict(float)
        counts: dict = collections.defaultdict(int)
        for r in self.records() if records is None else records:
            totals[r.name] += (r.end_ns - r.start_ns) * 1e-9
            counts[r.name] += 1
        return {name: {"total_s": round(t, 4), "count": counts[name],
                       "mean_ms": round(t / counts[name] * 1e3, 2)}
                for name, t in sorted(totals.items())}

    def dump(self, path: str) -> None:
        """``report()`` as JSON at ``path``."""
        with open(path, "w") as f:
            json.dump(self.report(), f, indent=2)


_OFF = _Off()
TRACER = Tracer()
span, count, records, clear = TRACER.span, TRACER.count, TRACER.records, TRACER.clear
enable, disable, report, dump = TRACER.enable, TRACER.disable, TRACER.report, TRACER.dump


def children(recs, parent: Record) -> list[Record]:
    """The records of ``recs`` whose parent is ``parent``, by start."""
    return sorted((r for r in recs if r.parent == parent.id), key=lambda r: r.start_ns)


def alloc_counters(device) -> dict | None:
    """The caching allocator's ``ALLOC_COUNTERS`` on a CUDA ``device``
    (a host read of its statistics), else None."""
    import torch

    if torch.device(device).type != "cuda":
        return None
    stats = torch.cuda.memory_stats(device)
    return {k: stats.get(k, 0) for k in ALLOC_COUNTERS}


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Trace the enclosed block with ``torch.profiler`` (CPU activity, and
    CUDA activity where a card is present) and write it as a Chrome trace,
    ``<log_dir>/trace.json``; yields the profiler (``key_averages()`` reads
    the per-kernel times).  The tracer records meanwhile."""
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
