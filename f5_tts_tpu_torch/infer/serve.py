"""Offline batched serving of many utterances, and the RTF / latency report.

JAX counterpart: ``f5_tts_tpu/infer/serve.py``.  ``BatchServer`` groups
requests into fixed-size batches by duration (as the reference eval's
``get_inference_prompt`` buckets, utils_eval.py:72-205), so one engine call
(one CUDA graph on the card) serves each (batch, bucket) pair, and runs
``overlap`` batches at a time so one batch's host fetch overlaps the next
one's replay.

With a ``mesh`` (``parallel/mesh.py``; one process per device, every rank
runs the same ``run``), as JAX :49-110:

- each batch's rows split over ``data``: rank r serves its contiguous
  rows on its own engine (its own CUDA graph; no collective inside it), and
  the waveforms are gathered to every rank after all batches
  (``all_gather_object``), so every rank returns all of them;
- JAX switches the engine's ``convpos_taps`` on under ``data`` > 1; the
  port's convpos is one function either way (``infer/engine.py``), so the
  server leaves the options as they are;
- with ``sequence_parallel`` and a ``seq`` axis, the engine gets the seq
  hook and the ring attention backend (``parallel/sequence.py``,
  ``parallel/ring.py``); its calls then run eagerly on the card, and
  ``run`` takes one batch at a time whatever its ``overlap``: every ring
  step sends and receives on the seq group, and two batches' collectives
  issued from two threads could pair up in another order on each rank;
- ``tensor_parallel=True`` raises ``NotImplementedError``: it is the next
  slice (ROADMAP.md).

Build a sequence-parallel server before warming the engine: it replaces
``engine.options`` and ``engine.parallel_hooks``.

``rtf_report`` is the report in the reference benchmark's format
(benchmark.py:454-468, client_grpc.py:425-447).
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
import dataclasses
from dataclasses import dataclass

import numpy as np

from f5_tts_tpu_torch.infer.engine import InferenceEngine
from f5_tts_tpu_torch.parallel import mesh as M


@dataclass
class Request:
    ref_mel: np.ndarray  # [n_ref, d]
    text_ids: np.ndarray  # [nt]
    duration: int  # total frames
    seed: int = 0


class BatchServer:
    """Groups requests into fixed-size batches and runs the engine."""

    def __init__(self, engine: InferenceEngine, mesh=None, batch_size: int = 8,
                 tensor_parallel: bool = False, sequence_parallel: bool = False):
        if tensor_parallel:
            raise NotImplementedError("tensor-parallel serving is the next slice of the port "
                                      "(tensor parallel, the pipeline and Picard over a mesh; "
                                      "see ROADMAP.md)")
        self.engine = engine
        self.mesh = mesh
        self.batch_size = batch_size
        self.mels: dict[int, np.ndarray] = {}  # run(fetch_mel=True): request index -> mel
        self.dp, self.data_rank, self._data_group = 1, 0, None
        if mesh is None:
            return
        from torch.distributed.device_mesh import DeviceMesh

        if not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh must be a torch DeviceMesh (parallel/mesh.py), "
                            f"got {type(mesh).__name__}")
        if sequence_parallel and M.SEQ_AXIS in mesh.mesh_dim_names:
            from f5_tts_tpu_torch.parallel.ring import make_ring_attention
            from f5_tts_tpu_torch.parallel.sequence import make_seq_constraint

            if engine.model_cfg.arch.backbone != "DiT":
                raise ValueError("sequence-parallel serving runs DiT only, as in JAX")
            engine.parallel_hooks = (None, make_seq_constraint(mesh))
            engine.options = dataclasses.replace(
                engine.options, backend=make_ring_attention(mesh, block_impl="auto"))
        self.data_rank, self.dp = M.data_rank_and_size(mesh)
        self._data_group = M.axis_group(mesh, M.DATA_AXIS)
        if batch_size % self.dp:
            raise ValueError(f"batch {batch_size} must divide over the data axis {self.dp}")

    def run(self, requests: list[Request], fetch_mel: bool = False, overlap: int = 2):
        """Processes all requests; returns (wavs, per_batch_latencies).

        ``overlap`` batches run concurrently (the concurrency-2 serving
        pattern of the reference's headline benchmark, README.md:131-138),
        and one at a time under the sequence-parallel hook (module
        docstring).  With ``fetch_mel`` each request's generated mel [n, d] is kept in
        ``self.mels``.  Over a data mesh a batch's latency is its slowest
        rank's."""
        order = sorted(range(len(requests)), key=lambda i: requests[i].duration)
        wavs: dict[int, np.ndarray] = {}
        latencies = []
        eng = self.engine
        B = self.batch_size
        groups = [order[s : s + B] for s in range(0, len(order), B)]

        per = B // self.dp  # this data rank's rows of each batch
        lo = self.data_rank * per

        def run_group(grp):
            reqs = [requests[i] for i in grp]
            reqs = (reqs + [reqs[-1]] * (B - len(reqs)))[lo:lo + per]  # pad with a repeat
            t0 = time.perf_counter()
            mels, ws, _ = eng.generate_batch(
                [r.ref_mel for r in reqs], [r.text_ids for r in reqs],
                [r.duration for r in reqs], seeds=[r.seed for r in reqs], fetch_mel=fetch_mel)
            return ws, mels, time.perf_counter() - t0

        if eng.parallel_hooks[1] is not None:
            overlap = 1  # the ring's collectives, in one order on every rank
        if overlap > 1 and len(groups) > 1:
            with ThreadPoolExecutor(max_workers=overlap) as ex:
                done = list(ex.map(run_group, groups))
        else:
            done = [run_group(grp) for grp in groups]
        if self._data_group is not None:  # every rank's rows, to every rank
            import torch.distributed as dist

            parts: list = [None] * self.dp
            dist.all_gather_object(parts, done, group=self._data_group)
            done = [(sum((p[g][0] for p in parts), []),
                     None if not fetch_mel else np.concatenate([p[g][1] for p in parts]),
                     max(p[g][2] for p in parts)) for g in range(len(groups))]
        self.mels = {}
        for grp, (ws, mels, lat) in zip(groups, done):
            latencies.append(lat)
            for j, i in enumerate(grp):
                wavs[i] = ws[j]
                if fetch_mel:
                    self.mels[i] = mels[j]
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
