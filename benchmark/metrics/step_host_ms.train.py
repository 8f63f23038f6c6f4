"""Step (``train/step.py``): the mean ms of the traced ``train.step`` spans,
the host's time in ``train_step`` (it does not wait for the card)."""

from benchmark.program_spans import records


def read(ctx):
    steps = records(ctx, "train.step")
    return 1e-6 * sum(r.end_ns - r.start_ns for r in steps) / len(steps) if steps else None
