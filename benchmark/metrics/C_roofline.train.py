"""Kernels (``ops/flash_attention.py``): kernel C's summed roofline bound
over its device time in the traced steps."""

from benchmark.readers import share, train_bounds


def read(ctx):
    b = train_bounds(ctx)
    return None if b is None else share(b["C"], ctx["trace"], "flash_fwd_kernel")
