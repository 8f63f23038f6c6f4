"""Device: the CUDA caching allocator's retries per traced step (each frees
cached blocks and synchronises the device), the ``num_alloc_retries``
counter of the ``train.step`` spans."""

from benchmark.program_spans import records


def read(ctx):
    steps = [r for r in records(ctx, "train.step") if "num_alloc_retries" in r.counters]
    return sum(r.counters["num_alloc_retries"] for r in steps) / len(steps) if steps else None
