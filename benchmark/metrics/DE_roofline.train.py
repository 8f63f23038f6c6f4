"""Kernels (``ops/flash_attention.py``, the backward): kernels D and E's
summed roofline bounds over their summed device time in the traced steps."""

from benchmark.readers import train_bounds
from benchmark.trace import kernel_time


def read(ctx):
    b, s = train_bounds(ctx), ctx["trace"]
    if b is None or s is None:
        return None
    t = kernel_time(s, "flash_bwd_dq_kernel")[0] + kernel_time(s, "flash_bwd_dkv_kernel")[0]
    return 100.0 * (b["D"] + b["E"]) / t if t > 0 else None
