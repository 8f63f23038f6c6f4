"""The program's own spans and counters in a traced slice, for the
per-layer readers that read them.

The program's tracer (``f5_tts_tpu_torch/utils/profiling.py``) records
while a ``torch.profiler`` session runs, so in a benchmark run its records
are the traced slice's (``benchmark/trace.Trace``); ``records`` keeps those
that overlap the harness's spans of the slice, should one process make more
than one run.  The records' stamps are on ``time.time_ns()``, the clock of
the summary's device operations, so ``idle_by_span`` puts each idle gap
between device operations down to the innermost program span the host was
in.  A program without the tracer gives no records, and its readers None.
"""

from __future__ import annotations


def tracer():
    """The program's tracer module, or None where the program has none."""
    try:
        from f5_tts_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "records") else None


def slice_ns(ctx) -> tuple[int, int] | None:
    """(first start, last end), wall ns, of the harness's spans in the
    traced slice: the serving kinds' traced engine calls, or the training
    kind's traced steps."""
    spans = ctx.get("trace_calls") or []
    if not spans and ctx.get("trace_steps"):
        spans = ctx["spans"].of("train_step")[-len(ctx["trace_steps"]):]
    if not spans:
        return None
    return min(s[4] for s in spans), max(s[5] for s in spans)


def records(ctx, name: str | None = None) -> list:
    """The program's records that overlap the traced slice (only those
    called ``name``, if given)."""
    prof, bounds = tracer(), slice_ns(ctx)
    if prof is None or bounds is None or ctx.get("trace") is None:
        return []
    lo, hi = bounds
    return [r for r in prof.records()
            if r.end_ns >= lo and r.start_ns <= hi and name in (None, r.name)]


def gaps(summary) -> list[tuple[float, float]]:
    """The idle intervals between the summary's device operations (wall
    seconds), as ``benchmark/trace.reduce`` finds them."""
    out, end = [], None
    for _, a, b in sorted(summary["ops"], key=lambda o: o[1]):
        if end is not None and a > end:
            out.append((end, a))
        end = b if end is None else max(end, b)
    return out


def idle_by_span(summary, recs) -> dict[str, float]:
    """Seconds of device idle between operations, by the innermost of
    ``recs`` the host was in (the covering span that started last), or
    "outside every span".  A gap is cut at every span boundary inside it."""
    spans = sorted((r.start_ns * 1e-9, r.end_ns * 1e-9, r.name) for r in recs)
    out: dict[str, float] = {}
    for a, b in gaps(summary):
        near = [s for s in spans if s[0] < b and s[1] > a]
        cuts = sorted({a, b, *(t for s in near for t in s[:2] if a < t < b)})
        for x, y in zip(cuts, cuts[1:]):
            mid = 0.5 * (x + y)
            inside = [s for s in near if s[0] <= mid <= s[1]]
            label = max(inside, key=lambda s: (s[0], -s[1]))[2] if inside else "outside every span"
            out[label] = out.get(label, 0.0) + (y - x)
    return out

