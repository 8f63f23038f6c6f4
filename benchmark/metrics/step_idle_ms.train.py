"""Step (``train/step.py``): the card's idle ms per traced step while the
host was inside a ``train.*`` span: the gaps between device operations,
each put down to the innermost program span the host was in."""

from benchmark.program_spans import idle_by_span, records


def read(ctx):
    recs = records(ctx)
    steps = [r for r in recs if r.name == "train.step"]
    if not steps:
        return None
    idle = idle_by_span(ctx["trace"], recs)
    if not idle:  # no device operation traced (a run without a card)
        return None
    return 1e3 * sum(v for k, v in idle.items() if k.startswith("train.")) / len(steps)
