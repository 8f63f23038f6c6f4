"""Serve layer (``infer/serve.py``): padded frame-rows over executed
frame-rows of the window's engine calls: bucket padding plus the rows that
repeat a request to fill a batch."""

from benchmark.readers import rows


def read(ctx):
    executed = useful = 0
    for c in ctx["calls"]:
        b, n, durs = rows(c)
        executed += b * n
        useful += sum(durs[:c[3]["real"]])
    return 100.0 * (1 - useful / executed) if executed else None
