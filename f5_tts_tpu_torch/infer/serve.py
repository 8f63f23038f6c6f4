"""Offline batched serving of many utterances, and the RTF / latency report.

JAX counterpart: ``f5_tts_tpu/infer/serve.py``.  ``BatchServer`` groups
requests into fixed-size batches by duration (as the reference eval's
``get_inference_prompt`` buckets, utils_eval.py:72-205), so one engine call
(one CUDA graph on the card) serves each (batch, bucket) pair, and runs
``overlap`` batches at a time so one batch's host fetch overlaps the next
one's replay.  The port serves on one device: the JAX server's data-,
tensor- and sequence-parallel mesh modes are not ported yet, and a
``mesh`` raises (ROADMAP.md).

``rtf_report`` is the report in the reference benchmark's format
(benchmark.py:454-468, client_grpc.py:425-447).
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np

from f5_tts_tpu_torch.infer.engine import InferenceEngine


@dataclass
class Request:
    ref_mel: np.ndarray  # [n_ref, d]
    text_ids: np.ndarray  # [nt]
    duration: int  # total frames
    seed: int = 0


class BatchServer:
    """Groups requests into fixed-size batches and runs the engine."""

    def __init__(self, engine: InferenceEngine, mesh=None, batch_size: int = 8):
        if mesh is not None:
            raise NotImplementedError("mesh serving (data, tensor and sequence parallel) is "
                                      "not ported yet; see ROADMAP.md")
        self.engine = engine
        self.batch_size = batch_size

    def run(self, requests: list[Request], fetch_mel: bool = False, overlap: int = 2):
        """Processes all requests; returns (wavs, per_batch_latencies).

        ``overlap`` batches run concurrently (the concurrency-2 serving
        pattern of the reference's headline benchmark, README.md:131-138)."""
        order = sorted(range(len(requests)), key=lambda i: requests[i].duration)
        wavs: dict[int, np.ndarray] = {}
        latencies = []
        eng = self.engine
        B = self.batch_size
        groups = [order[s : s + B] for s in range(0, len(order), B)]

        def run_group(grp):
            reqs = [requests[i] for i in grp]
            reqs = reqs + [reqs[-1]] * (B - len(reqs))  # pad the batch with a repeat
            t0 = time.perf_counter()
            _, ws, _ = eng.generate_batch(
                [r.ref_mel for r in reqs], [r.text_ids for r in reqs],
                [r.duration for r in reqs], seeds=[r.seed for r in reqs], fetch_mel=fetch_mel)
            return grp, ws, time.perf_counter() - t0

        if overlap > 1 and len(groups) > 1:
            with ThreadPoolExecutor(max_workers=overlap) as ex:
                done = list(ex.map(run_group, groups))
        else:
            done = [run_group(grp) for grp in groups]
        for grp, ws, lat in done:
            latencies.append(lat)
            for j, i in enumerate(grp):
                wavs[i] = ws[j]
        return [wavs[i] for i in range(len(requests))], latencies

    def warmup_all(self, buckets=None, warm_crops: bool = True) -> None:
        """Capture the serving graph of every bucket at this server's batch
        size by serving one batch through it.  ``warm_crops`` is kept for
        the JAX signature: the port's wav crop is a plain slice, with
        nothing to warm."""
        eng = self.engine
        d = eng.model_cfg.mel.n_mel_channels
        for n in buckets or eng.buckets:
            req = Request(ref_mel=np.zeros((n // 4, d), np.float32),
                          text_ids=np.zeros((min(64, n),), np.int32), duration=n - 1)
            self.run([req] * self.batch_size, overlap=1)


def rtf_report(wavs: list[np.ndarray], latencies: list[float], sample_rate: int = 24_000) -> dict:
    """Reference-format report: RTF = total wall / total audio seconds,
    latency mean + p50/90/95/99 (benchmark.py:454-468, client_grpc.py:425-447)."""
    total_audio = sum(len(w) for w in wavs) / sample_rate
    total_wall = sum(latencies)
    lat_ms = np.asarray(latencies) * 1000.0
    return {
        "total_audio_s": total_audio,
        "total_wall_s": total_wall,
        "rtf": total_wall / max(total_audio, 1e-9),
        "latency_ms_mean": float(lat_ms.mean()),
        "latency_ms_p50": float(np.percentile(lat_ms, 50)),
        "latency_ms_p90": float(np.percentile(lat_ms, 90)),
        "latency_ms_p95": float(np.percentile(lat_ms, 95)),
        "latency_ms_p99": float(np.percentile(lat_ms, 99)),
    }
