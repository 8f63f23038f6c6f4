"""Model step (``models/cfm.py`` and the backbone): useful model FLOPs over
the window times the bf16 peak.  Each served request counts at its own
frames (both guidance rows of every step, the text stack once, Vocos);
bucket padding and pad rows count nothing."""

from benchmark import flops
from benchmark.readers import arch, rows


def read(ctx):
    calls, (t0, t1) = ctx["calls"], ctx["window"]
    if not calls or t1 <= t0:
        return None
    model = type("M", (), {"arch": arch(ctx["cfg"])})
    total = sum(flops.sampling_flops(model, ctx["nfe"], d)
                for c in calls for d in rows(c)[2][:c[3]["real"]])
    return 100.0 * total / ((t1 - t0) * flops.H100_BF16_PEAK_FLOPS)
