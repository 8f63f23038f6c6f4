"""Request-level latency profile: where do the milliseconds of ONE serving
call go?

JAX counterpart: ``scripts/profile_request.py``.  Phases per request batch,
on the engine's CUDA graph (its key captured by a first call):

  assemble  host numpy batch assembly (pad / bucket / clamp)
  upload    the request tensors to the card and the seeded noise drawn
            there, synchronised
  compute   the engine call (one CUDA-graph replay: sampling and the
            vocoder), synchronised
  fetch     the int16 wav copied to the host

One more call runs under ``utils/profiling.device_trace`` (``torch.profiler``),
which writes ``<trace_dir>/trace.json`` and gives the call's device time:
the sum of its kernels' times, and the busy share over the traced wall.

    python -m f5_tts_tpu_torch.scripts.profile_request [--batch 1] [--nfe 32] \
        [--buckets 512 1024] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def profile(engine, n_bucket: int, batch: int, reps: int = 5, trace_dir: str | None = None,
            seed: int = 0) -> dict:
    """The median phase times (ms) and bytes of ``reps`` wav-decoding
    mel-entry calls at bucket ``n_bucket`` with ``batch`` rows, after a
    first call (the key's capture on the card); with ``trace_dir`` one more
    call under ``device_trace`` adds ``device_ms``, ``traced_wall_ms`` and
    ``busy``."""
    import torch

    from f5_tts_tpu_torch.infer.engine import _clamp_duration, draw_noise

    rng = np.random.default_rng(seed)
    d = engine.model_cfg.mel.n_mel_channels
    dev = engine.device
    n_ref = min(250, n_bucket // 4)
    ref_mels = [rng.standard_normal((n_ref, d)).astype(np.float32) for _ in range(batch)]
    texts = [rng.integers(0, 2545, size=min(150, n_bucket // 4)).astype(np.int32)
             for _ in range(batch)]
    durs = [n_bucket - 10] * batch

    def one():
        t0 = time.perf_counter()
        cond = np.zeros((batch, n_bucket, d), np.float32)
        lens = np.zeros((batch,), np.int32)
        text_ids = np.full((batch, n_bucket), -1, np.int32)
        for i, (m, t) in enumerate(zip(ref_mels, texts)):
            cond[i, : len(m)] = m
            lens[i] = len(m)
            text_ids[i, : len(t)] = t
        duration = _clamp_duration(np.asarray(durs, np.int32), text_ids, lens, n_bucket)
        t1 = time.perf_counter()
        args = (torch.as_tensor(cond, device=dev).to(engine.dtype),
                torch.as_tensor(text_ids, device=dev), torch.as_tensor(lens, device=dev),
                torch.as_tensor(duration, device=dev),
                draw_noise(list(range(batch)), n_bucket, d, dev))
        _sync(dev)
        t2 = time.perf_counter()
        _, wav = engine._run("mel", args, True)
        _sync(dev)
        t3 = time.perf_counter()
        wav_np = wav.cpu().numpy()
        t4 = time.perf_counter()
        up = sum(int(a.numel() * a.element_size()) for a in args)
        return {"assemble_ms": (t1 - t0) * 1e3, "upload_ms": (t2 - t1) * 1e3,
                "compute_ms": (t3 - t2) * 1e3, "fetch_ms": (t4 - t3) * 1e3,
                "total_ms": (t4 - t0) * 1e3, "upload_bytes": up,
                "fetch_bytes": int(wav_np.nbytes)}

    one()  # the key's first call: an eager call and the capture on the card
    rows = [one() for _ in range(reps)]
    out = {k: float(np.median([r[k] for r in rows])) for k in rows[0]}
    if trace_dir:
        from f5_tts_tpu_torch.utils.profiling import device_trace

        _sync(dev)
        t0 = time.perf_counter()
        with device_trace(trace_dir) as prof:
            one()
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
