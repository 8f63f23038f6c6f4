"""Serve layer (``infer/serve.py``), counted by the program: 100 x (1 -
useful over executed frame-rows) of the traced batches, from the
``serve.batch`` spans' ``serve.useful_frame_rows`` and ``serve.frame_rows``
counters."""

from benchmark.program_spans import records


def read(ctx):
    batches = records(ctx, "serve.batch")
    total = sum(r.counters.get("serve.frame_rows", 0) for r in batches)
    useful = sum(r.counters.get("serve.useful_frame_rows", 0) for r in batches)
    return 100.0 * (1 - useful / total) if total else None
