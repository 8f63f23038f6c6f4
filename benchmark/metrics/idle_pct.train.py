"""Device: the share of the traced slice in which no operation ran on the
card (the union of the device operations' intervals)."""

from benchmark.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
