"""Trainer input: padded frames over collated frames of the window's
batches."""


def read(ctx):
    total = sum(b * n for b, n, _ in ctx["steps"])
    valid = sum(int(lens.sum()) for _, _, lens in ctx["steps"])
    return 100.0 * (1 - valid / total) if total else None
