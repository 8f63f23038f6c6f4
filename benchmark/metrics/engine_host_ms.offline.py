"""Engine (``infer/engine.py``): the mean host ms of a traced engine call
outside its wait for the outputs: its ``engine.prepare``,
``engine.lock_wait``, ``engine.enqueue`` and ``engine.trim`` spans, summed,
over the ``engine.call`` spans of the slice."""

from benchmark.program_spans import records

HOST = ("engine.prepare", "engine.lock_wait", "engine.enqueue", "engine.trim")


def read(ctx):
    recs = records(ctx)
    calls = {r.id for r in recs if r.name == "engine.call"}
    if not calls:
        return None
    ns = sum(r.end_ns - r.start_ns for r in recs if r.parent in calls and r.name in HOST)
    return 1e-6 * ns / len(calls)
