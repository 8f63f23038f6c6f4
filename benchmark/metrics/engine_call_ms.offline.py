"""Engine (``infer/engine.py``): the harness's spans around each
``generate_batch`` of the window, summed."""


def read(ctx):
    calls = ctx["calls"]
    return 1e3 * sum(c[2] - c[1] for c in calls) if calls else None
