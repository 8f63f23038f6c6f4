"""Training-step throughput on the card (frames/s per card).

JAX counterpart: ``scripts/bench_train.py``: the same positional arguments
and the same JSON line.  Reference scale point: 8 GPUs x 38,400 frames per
GPU per update (configs/F5TTS_v1_Base.yaml).  Runs the port's
``train/step.py`` ``train_step`` (CFM loss, clip, AdamW, EMA) on one fixed
random batch: one untimed micro-step, then ``iters`` timed ones.

    python -m f5_tts_tpu_torch.scripts.bench_train [b] [bf16] [backend] [policy] \
        [bucket] [accum] [model] [device] [iters]

backend: an ``ops/attention.py`` backend, ``train_auto`` by default (kernels
C, D, E on the card); JAX's default, ``chunked``, is the plain online-softmax
scan.  policy: a ``models/remat.py`` policy, or ``none`` for no activation
checkpointing (default ``nothing``, as JAX).  model: any ``MODEL_CONFIGS``
name.  device: ``cuda`` (default) or ``cpu``.

Under ``torchrun`` (``WORLD_SIZE`` > 1) every rank joins the group and runs
data-parallel steps on its own b rows of a global batch of
``WORLD_SIZE * b`` (gradients summed over the ranks, ``train/step.py``);
rank 0 prints the line, per card as before, with ``world_size`` added.
Ranks that share one card share its time: only one rank per card gives a
scaling figure.

    torchrun --nproc_per_node=4 -m f5_tts_tpu_torch.scripts.bench_train 8 bf16

MFU counts ``utils/flops.py`` ``train_step_flops`` (fwd + bwd = 3x the
forward, remat recompute not counted) against the H100's bf16 peak.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import sys
import time

import numpy as np
import torch


def main(argv=None) -> dict:
    from f5_tts_tpu_torch.infer.api import _seeded
    from f5_tts_tpu_torch.models.cfm import CFM
    from f5_tts_tpu_torch.models.configs import MODEL_CONFIGS
    from f5_tts_tpu_torch.train.step import OptimConfig, make_optimizer, train_step
    from f5_tts_tpu_torch.utils.device import resolve_device
    from f5_tts_tpu_torch.utils.flops import H100_BF16_PEAK_FLOPS, train_step_flops

    argv = sys.argv[1:] if argv is None else list(argv)

    def arg(i, default):
        return argv[i] if len(argv) > i else default

    b = int(arg(0, 8))
    mixed = arg(1, "") == "bf16"
    backend = arg(2, "train_auto")
    pol = arg(3, "nothing")
    n = int(arg(4, 1024))  # frame bucket
    accum = int(arg(5, 1))  # gradient accumulation
    model_name = arg(6, "F5TTS_v1_Base")
    dev = resolve_device(arg(7, None), "bench_train")
    iters = int(arg(8, 10))
    nt = 256
    import os

    world = int(os.environ.get("WORLD_SIZE", "1"))
    par = {}
    if world > 1:
        import torch.distributed as dist

        from f5_tts_tpu_torch.parallel.distributed import init_distributed

        topo = init_distributed(device=arg(7, None))
        dev = torch.device(topo["device"])
        rank = dist.get_rank()
        par = dict(rows=(rank * b, world * b), data_group=dist.group.WORLD,
                   grad_group=dist.group.WORLD)

    # "none" = no activation checkpointing at all (every activation kept)
    arch = dataclasses.replace(MODEL_CONFIGS[model_name].arch,
                               checkpoint_activations=pol != "none",
                               remat_policy="nothing" if pol == "none" else pol)
    model = _seeded(lambda: CFM(arch), 0).to(dev).train()
    ema = copy.deepcopy(model).requires_grad_(False)
    opt_cfg = OptimConfig(mixed_precision=mixed, grad_accumulation_steps=accum)
    opt = make_optimizer(list(model.parameters()), opt_cfg)
    rng = np.random.default_rng(0)
    batch = {
        "mel": torch.as_tensor(rng.standard_normal((b, n, 100)).astype(np.float32), device=dev),
        "text_ids": torch.as_tensor(rng.integers(0, 2545, (b, nt)).astype(np.int32), device=dev),
        "lens": torch.full((b,), n, dtype=torch.int32, device=dev),
    }

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    micro, m = train_step(model, opt, ema, 0, batch, 1, opt_cfg, backend=backend, **par)
    loss = float(m["loss"])
    print(f"first step: {time.perf_counter() - t0:.1f}s, loss {loss:.4f}", file=sys.stderr)
    sync()
    t0 = time.perf_counter()
    for i in range(iters):
        micro, m = train_step(model, opt, ema, micro, batch, 2 + i, opt_cfg, backend=backend,
                              **par)
    sync()
    dt = (time.perf_counter() - t0) / iters
    frames_s = b * n / dt
    print(f"step: {dt * 1000:.1f} ms, {frames_s:,.0f} frames/s/card (batch {b}x{n})",
          file=sys.stderr)
    # MFU on the port's basis (utils/flops.py: fwd+bwd = 3x fwd, remat
    # recompute not counted)
    step_flops = train_step_flops(MODEL_CONFIGS[model_name], n, batch=b)
    tflops = step_flops / dt / 1e12
    mfu_pct = 100.0 * step_flops / dt / H100_BF16_PEAK_FLOPS
    print(f"MFU: {tflops:.1f} TFLOP/s = {mfu_pct:.1f}% of the H100 bf16 peak", file=sys.stderr)
    rec = {"metric": "train_frames_per_s", "value": round(frames_s), "unit": "frames/s/chip",
           "model_tflops_per_s": round(tflops, 1), "mfu_pct": round(mfu_pct, 1)}
    if world > 1:
        rec["world_size"] = world
        if torch.distributed.get_rank() != 0:
            return rec
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
