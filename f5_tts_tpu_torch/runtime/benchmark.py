"""Offline serving benchmark with a same-harness backend comparison
(reference runtime/triton_trtllm/benchmark.py: --backend-type trt|pytorch).

JAX counterpart: ``f5_tts_tpu/runtime/benchmark.py``: the same flags (and
``--device``), the same seeded prompt set and the same two passes through
the batch server: a warm pass (``overlap=1``, which captures every (batch,
bucket) CUDA graph the prompts hit), then the timed pass (``overlap=2``).
The comparison axis is the attention backend: ``flash`` launches kernel A,
``sdpa`` runs the port's plain ``ops/attention.sdpa``.  The report is
``serve.rtf_report`` plus ``wall_s``, ``wall_rtf``, ``backend`` and
``nfe``, and, of the timed pass, the engine calls by (rows, bucket), the
kernel launches (``cuda_build`` counters), the model FLOPs on the basis of
``utils/flops.py`` (BigVGAN counts nothing) and, on the card, the MFU
against the H100's bf16 peak over the pass's wall.

    python -m f5_tts_tpu_torch.runtime.benchmark --backend-type flash --nfe 16
"""

from __future__ import annotations

import argparse
import json
import time
from collections import Counter

import numpy as np
import torch


def prompts(n_mels: int, num: int):
    """The seeded prompt set (JAX's): random ref mels of 200-300 frames,
    80-200 text ids, durations of 500-1020 frames."""
    from f5_tts_tpu_torch.infer.serve import Request

    rng = np.random.default_rng(0)
    reqs = []
    for i in range(num):
        ref = rng.standard_normal((int(rng.integers(200, 300)), n_mels)).astype(np.float32)
        text = rng.integers(0, 2545, size=int(rng.integers(80, 200))).astype(np.int32)
        reqs.append(Request(ref_mel=ref, text_ids=text, duration=int(rng.integers(500, 1020)),
                            seed=i))
    return reqs


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--backend-type", default="flash", choices=["flash", "sdpa"])
    p.add_argument("--dtype", default="auto", choices=["auto", "bf16", "fp32"])
    p.add_argument("--model", default="F5TTS_v1_Base")
    p.add_argument("--ckpt_file", default="")
    p.add_argument("--vocoder_local_path", default=None)
    p.add_argument("--nfe", type=int, default=16)
    p.add_argument("--num-prompts", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--output", default=None, help="write rtf report json here")
    args = p.parse_args(argv)

    from f5_tts_tpu_torch.infer.engine import EngineOptions, pick_bucket
    from f5_tts_tpu_torch.infer.serve import BatchServer, rtf_report
    from f5_tts_tpu_torch.ops import cuda_build
    from f5_tts_tpu_torch.runtime.aot import build_engine
    from f5_tts_tpu_torch.utils import flops

    dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}.get(args.dtype)  # auto: None
    engine = build_engine(args.model, args.ckpt_file, args.vocoder_local_path or "", args.device,
                          dtype, EngineOptions(nfe_step=args.nfe, backend=args.backend_type))
    model_cfg = engine.model_cfg
    reqs = prompts(model_cfg.mel.n_mel_channels, args.num_prompts)

    calls = Counter()  # (rows, bucket) of every engine call
    inner = engine.generate_batch

    def counted(ref_mels, text_ids_list, durations, **kw):
        calls[(len(ref_mels), pick_bucket(max(durations), engine.buckets))] += 1
        return inner(ref_mels, text_ids_list, durations, **kw)

    engine.generate_batch = counted
    srv = BatchServer(engine, mesh=None, batch_size=args.batch_size)
    # warm with a full pass: captures every (bucket, batch) graph the request
    # set will hit (a production server is warm; first-hit captures are
    # deployment one-offs)
    srv.run(reqs, overlap=1)
    calls.clear()
    before = cuda_build.launch_counts()
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    t0 = time.perf_counter()
    wavs, lats = srv.run(reqs, overlap=2)
    wall = time.perf_counter() - t0
    launched = {k.name: a - b for k, a, b in
                zip(cuda_build.KERNELS, cuda_build.launch_counts(), before) if a != b}
    rep = rtf_report(wavs, lats, model_cfg.mel.target_sample_rate)
    rep["wall_s"] = wall
    rep["wall_rtf"] = wall / rep["total_audio_s"]
    rep["backend"] = args.backend_type
    rep["nfe"] = args.nfe
    rep["engine_calls"] = {f"b{b}_n{n}": c for (b, n), c in sorted(calls.items())}
    rep["kernel_launches"] = launched
    fl = sum(c * flops.sampling_flops(model_cfg, args.nfe, n, batch=b,
                                      vocoder=engine.vocoder_type)
             for (b, n), c in calls.items())
    rep["model_tflop"] = fl / 1e12
    rep["mfu_pct"] = (100.0 * flops.mfu(fl / wall) if engine.device.type == "cuda" else None)
    print(json.dumps(rep, indent=2))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(rep, f, indent=2)
    return rep


if __name__ == "__main__":
    main()
