"""Kernels (``ops/flash_attention.py``): kernel A's summed roofline bound
over its summed device time in the traced slice."""

from benchmark.readers import serving_bounds, share


def read(ctx):
    b = serving_bounds(ctx)
    return None if b is None else share(b[0], ctx["trace"], "flash_fwd_kernel")
