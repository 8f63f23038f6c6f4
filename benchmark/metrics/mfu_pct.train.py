"""Step (``train/step.py``): 3 x the forward FLOPs at each row's valid
length over the window times the bf16 peak."""

from benchmark import flops
from benchmark.readers import forward_flops


def read(ctx):
    if not ctx["steps"]:
        return None
    total = sum(3.0 * forward_flops(ctx["cfg"], int(x)) for _, _, lens in ctx["steps"]
                for x in lens)
    return 100.0 * total / (ctx["wall"] * flops.H100_BF16_PEAK_FLOPS)
