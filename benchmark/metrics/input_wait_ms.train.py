"""Trainer input (``train/dataset.py``): the step loop's mean wait for the
next uploaded batch in the window."""


def read(ctx):
    w = ctx["waits"]
    return 1e3 * sum(w) / len(w) if w else None
