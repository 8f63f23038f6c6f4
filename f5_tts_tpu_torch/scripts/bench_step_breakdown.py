"""Device-only microbenchmarks of the serving and training hot paths.

JAX counterpart: ``scripts/bench_step_breakdown.py``.  JAX repeats the op
inside one jitted ``lax.scan``; here every time is device time per call from
a CUDA-graph replay (``utils/device.device_ms``), and the per-op table comes
from a ``torch.profiler`` trace (``utils/profiling.device_trace``, its Chrome
trace parsed by ``kernel_table``) where JAX parses its xplane.

    python -m f5_tts_tpu_torch.scripts.bench_step_breakdown step       # one DiT step
    python -m f5_tts_tpu_torch.scripts.bench_step_breakdown attn       # kernel A, every tile configuration
    python -m f5_tts_tpu_torch.scripts.bench_step_breakdown attn_sdpa  # the plain ops.attention.sdpa
    python -m f5_tts_tpu_torch.scripts.bench_step_breakdown profile    # kernel table, serving step
    python -m f5_tts_tpu_torch.scripts.bench_step_breakdown profile_train [b] [n] [policy]

``step`` and ``profile`` run one full-width F5TTS_v1_Base ``dit.forward``
in bf16 at [2, 1024] (the fused-CFG pair of a 1024-frame bucket), lens
{1024, 824}, ``backend="flash"``: kernels A and B.  ``profile_train`` runs
full training steps (loss, backward, AdamW, EMA; ``train/step.train_step``)
of F5TTS_v1_Base with activation checkpointing under ``policy`` (default b
8, n 1024, ``dots_flash``, as JAX): kernels B, C, D and E.  The modes time
the card only: on another device they raise.  Every mode prints the card's
name and power limit first and returns its numbers with the kernel launches
it made (captures included).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from collections import defaultdict

B, N, LENS = 2, 1024, (1024, 824)


def kernel_table(trace_path: str, cat: str = "kernel", top: int = 25) -> tuple[float, list]:
    """(total ms, top rows) of a ``torch.profiler`` Chrome trace: the events
    of category ``cat`` (``"kernel"``: CUDA kernels; ``"cpu_op"`` on a CPU
    trace) summed by name, each row {"name", "ms", "share", "count"}, by
    time, largest first."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    totals, counts = defaultdict(float), defaultdict(int)
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat") == cat:
            totals[ev["name"]] += float(ev.get("dur", 0.0)) / 1e3
            counts[ev["name"]] += 1
    total = sum(totals.values())
    rows = [{"name": name, "ms": ms, "share": ms / total if total else 0.0,
             "count": counts[name]}
            for name, ms in sorted(totals.items(), key=lambda kv: -kv[1])[:top]]
    return total, rows


def print_table(title: str, total: float, rows: list) -> None:
    print(f"\n{title}: total device time {total:.3f} ms")
    for r in rows:
        print(f"{r['ms']:9.3f} ms {r['share'] * 100:5.1f}%  x{r['count']:<5} {r['name'][:100]}")


def _card(device):
    from f5_tts_tpu_torch.utils.device import card_name_and_power_limit, resolve_device

    dev = resolve_device(device, "bench_step_breakdown")
    if dev.type != "cuda":
        raise ValueError(f"bench_step_breakdown times the card; got device {dev}")
    print(f"card: {card_name_and_power_limit()}", flush=True)
    return dev


def _dit_step(dev):
    """() -> one full-width bf16 F5TTS_v1_Base ``dit.forward`` at [2, 1024]
    through kernels A and B, on fixed seeded inputs."""
    import numpy as np
    import torch

    from f5_tts_tpu_torch.infer.api import _seeded
    from f5_tts_tpu_torch.models import dit
    from f5_tts_tpu_torch.models.configs import MODEL_CONFIGS

    cfg = MODEL_CONFIGS["F5TTS_v1_Base"].arch
    model = _seeded(lambda: dit.DiT(cfg), 0)
    model = dit.fuse_for_inference(model).to(dev, torch.bfloat16).eval().requires_grad_(False)
    rng = np.random.default_rng(0)

    def t(shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=torch.bfloat16, device=dev)

    cond, te, x = t((B, N, cfg.mel_dim)), t((B, N, cfg.text_dim)), t((B, N, cfg.mel_dim))
    time = torch.tensor([0.4, 0.4], dtype=torch.bfloat16, device=dev)
    mask = torch.arange(N, device=dev)[None, :] < torch.tensor(LENS, device=dev)[:, None]

    @torch.inference_mode()
    def step():
        return dit.forward(model, cfg, x, cond, te, time, mask=mask, backend="flash")

    return step


def bench_step(device=None, iters: int = 30) -> dict:
    from f5_tts_tpu_torch.ops import cuda_build
    from f5_tts_tpu_torch.utils.device import device_ms

    dev = _card(device)
    step = _dit_step(dev)
    before = cuda_build.launch_counts()
    ms = device_ms(step, iters)
    out = {"dit_step_ms": ms, "iters": iters, "launches": cuda_build.launches_since(before)}
    print(f"dit_step: {ms:.3f} ms/step  ({iters} steps per replay)")
    return out


def _attn_inputs(dev):
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    q, k, v = (torch.as_tensor(rng.standard_normal((B, 16, N, 64)), dtype=torch.bfloat16,
                               device=dev) for _ in range(3))
    return q, k, v, torch.tensor(LENS, dtype=torch.int32, device=dev)


def bench_attn(device=None, iters: int = 200) -> dict:
    """Kernel A at [2, 16, 1024, 64] bf16 in each tile configuration built
    (``flash_attention.FWD_CONFIGS``), where JAX sweeps its block pairs."""
    from f5_tts_tpu_torch.ops import flash_attention as FA
    from f5_tts_tpu_torch.utils.device import device_ms

    q, k, v, lens = _attn_inputs(_card(device))
    out = {}
    for cfg in FA.FWD_CONFIGS:
        ms = device_ms(lambda c=cfg: FA.flash_attention_cuda(q, k, v, lens, config=c), iters)
        out["x".join(map(str, cfg))] = ms
        print(f"flash rows={cfg[0]} stages={cfg[1]}{' (launched)' if cfg == FA.FWD_CONFIG else ''}"
              f": {ms * 1e3:.1f} us/call")
    return out


def bench_attn_sdpa(device=None, iters: int = 100) -> dict:
    """The port's plain ``ops.attention.sdpa`` at kernel A's shape."""
    import torch

    from f5_tts_tpu_torch.ops.attention import sdpa
    from f5_tts_tpu_torch.utils.device import device_ms

    q, k, v, lens = _attn_inputs(_card(device))
    mask = torch.arange(N, device=q.device)[None, :] < lens[:, None]
    ms = device_ms(lambda: sdpa(q, k, v, mask), iters)
    print(f"sdpa: {ms * 1e3:.1f} us/call")
    return {"sdpa_ms": ms}


def _traced(fn, iters: int, trace_dir: str | None):
    """Run ``fn`` ``iters`` times under ``device_trace``; (total, rows of
    the whole table) from its trace."""
    import torch

    from f5_tts_tpu_torch.utils.profiling import device_trace

    trace_dir = trace_dir or tempfile.mkdtemp(prefix="step_breakdown_")
    with device_trace(trace_dir):
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return kernel_table(os.path.join(trace_dir, "trace.json"), top=10**6)


def profile_step(device=None, iters: int = 30, trace_dir: str | None = None,
                 top: int = 25) -> dict:
    """Trace ``iters`` serving steps; print the kernel table (top 25)."""
    import torch

    from f5_tts_tpu_torch.ops import cuda_build

    dev = _card(device)
    step = _dit_step(dev)
    step()
    torch.cuda.synchronize()
    before = cuda_build.launch_counts()
    total, rows = _traced(step, iters, trace_dir)
    print_table(f"serving step [2, 1024] bf16, {iters} steps traced (divide ms by the steps)",
                total, rows[:top])
    return {"total_ms": total, "rows": rows[:top], "kernels": sum(r["count"] for r in rows),
            "iters": iters, "launches": cuda_build.launches_since(before)}


def profile_train(b: int = 8, n: int = 1024, policy: str = "dots_flash", device=None,
                  iters: int = 10, trace_dir: str | None = None, top: int = 40) -> dict:
    """Trace ``iters`` full training steps (one untraced first); print the
    kernel table (top 40)."""
    import copy
    import dataclasses

    import numpy as np
    import torch

    from f5_tts_tpu_torch.infer.api import _seeded
    from f5_tts_tpu_torch.models.cfm import CFM
    from f5_tts_tpu_torch.models.configs import MODEL_CONFIGS
    from f5_tts_tpu_torch.ops import cuda_build
    from f5_tts_tpu_torch.train.step import OptimConfig, make_optimizer, train_step

    dev = _card(device)
    arch = dataclasses.replace(MODEL_CONFIGS["F5TTS_v1_Base"].arch,
                               checkpoint_activations=True, remat_policy=policy)
    model = _seeded(lambda: CFM(arch), 0).to(dev).train()
    ema = copy.deepcopy(model).requires_grad_(False)
    opt_cfg = OptimConfig(mixed_precision=True)
    opt = make_optimizer(list(model.parameters()), opt_cfg)
    rng = np.random.default_rng(0)
    batch = {
        "mel": torch.as_tensor(rng.standard_normal((b, n, 100)).astype(np.float32), device=dev),
        "text_ids": torch.as_tensor(rng.integers(0, 2545, (b, 256)).astype(np.int32),
                                    device=dev),
        "lens": torch.full((b,), n, dtype=torch.int32, device=dev),
    }
    state = {"micro": 0}

    def step():
        state["micro"], m = train_step(model, opt, ema, state["micro"], batch, 1 + state["micro"],
                                       opt_cfg, backend="train_auto")
        return m

    step()
    torch.cuda.synchronize()
    before = cuda_build.launch_counts()
    total, rows = _traced(step, iters, trace_dir)
    launches = cuda_build.launches_since(before)
    print_table(f"train step b={b} n={n} policy={policy} ({iters} steps traced; divide ms by "
                "the steps)", total, rows[:top])
    return {"total_ms": total, "rows": rows[:top], "kernels": sum(r["count"] for r in rows),
            "iters": iters, "b": b, "n": n, "policy": policy, "launches": launches,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(dev)}


MODES = ("step", "attn", "attn_sdpa", "profile", "profile_train")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="bench_step_breakdown")
    ap.add_argument("which", nargs="?", default="step", choices=MODES)
    ap.add_argument("rest", nargs="*", help="profile_train: [b] [n] [policy]")
    ap.add_argument("--device", default=None, help="cuda (default); the modes time the card only")
    ap.add_argument("--iters", type=int, default=None, help="steps per replay or trace")
    args = ap.parse_args(argv)
    kw = {"device": args.device}
    if args.iters is not None:
        kw["iters"] = args.iters
    if args.which == "profile_train":
        r = args.rest
        out = profile_train(int(r[0]) if r else 8, int(r[1]) if len(r) > 1 else 1024,
                            r[2] if len(r) > 2 else "dots_flash", **kw)
    else:
        out = {"step": bench_step, "attn": bench_attn, "attn_sdpa": bench_attn_sdpa,
               "profile": profile_step}[args.which](**kw)
    print(json.dumps({"mode": args.which, **{k: v for k, v in out.items() if k != "rows"}}))
    return out


if __name__ == "__main__":
    main()
