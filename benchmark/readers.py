"""What the per-layer metric readers (``benchmark/metrics/<name>.py``)
share: the model's sizes for the FLOP and roofline arithmetic, the engine
calls' rows, and a kernel's share of its roofline in a traced slice.  A
reader returns None where it finds nothing to read."""

from __future__ import annotations

from types import SimpleNamespace

from benchmark import flops, roofline
from benchmark.trace import kernel_time


def arch(cfg: dict) -> SimpleNamespace:
    """The configuration's ``arch`` with the defaults the FLOP functions read."""
    base = {"mel_dim": 100, "conv_mult": 2, "text_dim": None, "skip_connect_type": "concat",
            "backbone": cfg["backbone"]}
    return SimpleNamespace(**{**base, **cfg["arch"]})


def rows(call) -> tuple[int, int, list[int]]:
    """(rows b, bucket n, each row's frames: the server's pad rows repeat its
    last request) of a recorded engine call."""
    info = call[3]
    n, durs = info["n"], [min(int(d), info["n"]) for d in info["durs"]]
    return info["b"], n, durs + [durs[-1]] * (info["b"] - len(durs))


def serving_bounds(ctx) -> tuple[float, float] | None:
    """(kernel A's, kernel B's) summed bounds over the traced engine calls:
    per call ``nfe`` forwards of 2b rows (the guidance pair); UNetT runs
    attention over the time token too, and its position convolution over the
    whole bucket."""
    calls = ctx.get("trace_calls")
    if not calls:
        return None
    cfg, nfe = ctx["cfg"], ctx["nfe"]
    a = arch(cfg)
    unet = cfg["backbone"] == "UNetT"
    ba = bb = 0.0
    for c in calls:
        b, n, durs = rows(c)
        kv = [d + 1 for d in durs] * 2 if unet else durs * 2
        ba += nfe * a.depth * roofline.attention_fwd(2 * b, a.heads, n + unet, a.dim_head, kv)
        bb += nfe * roofline.convpos(2 * b, n, a.dim, [n] * (2 * b) if unet else durs * 2)
    return ba, bb


def share(bound: float, summary, pattern: str) -> float | None:
    """100 x bound over the device time of the kernels whose name holds
    ``pattern``, or None."""
    if summary is None or not bound:
        return None
    t, launches = kernel_time(summary, pattern)
    return 100.0 * bound / t if launches else None


def train_bounds(ctx) -> dict | None:
    """Kernels C, D and E's summed bounds over the traced steps (one launch
    of each per block per step)."""
    steps = ctx.get("trace_steps")
    if not steps:
        return None
    a = arch(ctx["cfg"])
    out = {"C": 0.0, "D": 0.0, "E": 0.0}
    for b, n, lens in steps:
        bd = roofline.train_attention(b, a.heads, n, a.dim_head, [int(x) for x in lens])
        for k in out:
            out[k] += a.depth * getattr(bd, k)
    return out


def idle_pct(ctx) -> float | None:
    s = ctx.get("trace")
    if s is None or s["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])


def forward_flops(cfg: dict, n: int) -> float:
    return flops.backbone_forward_flops(arch(cfg), n)
