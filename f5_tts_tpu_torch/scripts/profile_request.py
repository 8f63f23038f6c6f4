"""Request-level latency profile: where do the milliseconds of ONE serving
call go?

JAX counterpart: ``scripts/profile_request.py``.  Ordinary
``engine.generate_batch`` calls (mel entry, wav decoded, on the engine's
CUDA graph, its key captured by a first call) run with the program's
tracer on (``utils/profiling.py``), and the phases are the engine's own
spans (``infer/engine.py``):

  assemble  ``engine.prepare`` less its ``engine.upload``: the host numpy
            batch assembly (pad / bucket / clamp)
  upload    ``engine.upload``: the seeded noise drawn on the device and the
            request tensors copied there
  compute   ``engine.lock_wait`` + ``engine.enqueue``: the copies into the
            graph's inputs and the replay's launch (the CPU runs the call
            itself here)
  fetch     ``engine.fetch`` + ``engine.trim``: the copies to the host,
            which wait for the replay (on the card, its compute lands here:
            no span synchronises), and the wav's dequantize and crop
  total     ``engine.call``

``upload_bytes`` and ``fetch_bytes`` are the two spans' ``bytes`` counters.
One more call runs under ``utils/profiling.device_trace``
(``torch.profiler``), which writes ``<trace_dir>/trace.json`` and gives the
call's device time: the sum of its kernels' times, and the busy share over
the traced wall.

    python -m f5_tts_tpu_torch.scripts.profile_request [--batch 1] [--nfe 32] \
        [--buckets 512 1024] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time
from collections import Counter

import numpy as np


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def phases(recs) -> dict:
    """The report's phases (ms) and bytes of the last ``engine.call`` in
    the tracer's records ``recs``."""
    from f5_tts_tpu_torch.utils.profiling import children

    call = [r for r in recs if r.name == "engine.call"][-1]
    kids = children(recs, call)
    ms, nbytes = Counter(), Counter()
    for k in kids + [g for k in kids for g in children(recs, k)]:
        ms[k.name] += (k.end_ns - k.start_ns) * 1e-6
        nbytes[k.name] += k.counters.get("bytes", 0)
    return {"assemble_ms": ms["engine.prepare"] - ms["engine.upload"],
            "upload_ms": ms["engine.upload"],
            "compute_ms": ms["engine.lock_wait"] + ms["engine.enqueue"],
            "fetch_ms": ms["engine.fetch"] + ms["engine.trim"],
            "total_ms": (call.end_ns - call.start_ns) * 1e-6,
            "upload_bytes": nbytes["engine.upload"], "fetch_bytes": nbytes["engine.fetch"]}


def profile(engine, n_bucket: int, batch: int, reps: int = 5, trace_dir: str | None = None,
            seed: int = 0) -> dict:
    """The median phase times (ms) and bytes of ``reps`` wav-decoding
    mel-entry calls at bucket ``n_bucket`` with ``batch`` rows, after a
    first call (the key's capture on the card); with ``trace_dir`` one more
    call under ``device_trace`` adds ``device_ms``, ``traced_wall_ms`` and
    ``busy``."""
    from f5_tts_tpu_torch.utils import profiling

    rng = np.random.default_rng(seed)
    d = engine.model_cfg.mel.n_mel_channels
    dev = engine.device
    n_ref = min(250, n_bucket // 4)
    ref_mels = [rng.standard_normal((n_ref, d)).astype(np.float32) for _ in range(batch)]
    texts = [rng.integers(0, 2545, size=min(150, n_bucket // 4)).astype(np.int32)
             for _ in range(batch)]
    durs = [n_bucket - 10] * batch

    def call():
        engine.generate_batch(ref_mels, texts, durs, seeds=list(range(batch)), fetch_mel=False)

    def one():
        call()
        return phases(profiling.records())

    call()  # the key's first call: an eager call and the capture on the card
    profiling.enable()
    try:
        rows = [one() for _ in range(reps)]
    finally:
        profiling.disable()
    out = {k: float(np.median([r[k] for r in rows])) for k in rows[0]}
    if trace_dir:
        from f5_tts_tpu_torch.utils.profiling import device_trace

        _sync(dev)
        t0 = time.perf_counter()
        with device_trace(trace_dir) as prof:
            call()
        wall = (time.perf_counter() - t0) * 1e3
        kern = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
        dev_ms = sum(e.self_device_time_total for e in kern) / 1e3
        out.update(traced_wall_ms=wall, device_ms=dev_ms if kern else None,
                   busy=dev_ms / wall if kern else None)
    return out


def main(argv=None) -> dict:
    from f5_tts_tpu_torch.infer.engine import EngineOptions
    from f5_tts_tpu_torch.runtime.aot import build_engine

    p = argparse.ArgumentParser(prog="profile_request")
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--nfe", type=int, default=16)
    p.add_argument("--buckets", type=int, nargs="+", default=[768, 1024])
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--model", default="F5TTS_v1_Base")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--trace-dir", default=None, help="write a torch.profiler trace here")
    args = p.parse_args(argv)

    engine = build_engine(args.model, device=args.device,
                          options=EngineOptions(nfe_step=args.nfe))
    report = {}
    for n in args.buckets:
        med = profile(engine, n, args.batch, args.reps, args.trace_dir)
        report[f"n{n}"] = med
        print(f"bucket {n} batch {args.batch} nfe {args.nfe}:")
        for k, v in med.items():
            if v is None:
                continue
            unit = "B" if k.endswith("bytes") else ("" if k == "busy" else "ms")
            print(f"  {k:>14}: {v:9.3f} {unit}")
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
