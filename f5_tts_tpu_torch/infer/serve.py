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
  rows on its own engine (its own CUDA graph at its rows' bucket; no
  collective inside it), and
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
- ``tensor_parallel=True`` with a ``model`` axis above 1 (JAX :90-100)
  shards the engine's backbone over ``model`` (``parallel/mesh.shard_params``:
  Megatron's column / row split, each rank its ``heads / tp`` heads and
  ``inner / tp`` feed-forward columns, an all-reduce after each row-parallel
  linear).  JAX refuses an engine whose qkv is fused; the port's fusion is a
  serving transform (``Attention.fuse_qkv``), so each rank rebuilds its
  fused weight from its own q, k and v slices instead, and a fused engine
  serves.  Under W8A8 (``EngineOptions(quantize=True)``) a quantized
  module stays whole on every rank, as JAX's: its ``_tp_param_spec``
  matches ``kernel``, not the quantized ``kernel_q``, so JAX replicates the
  int8 weights and its quantized linears run whole on every device (kernel
  G at the full K); the dense modules (MMDiT's feed-forwards) split.  The
  engine's calls then all-reduce over ``model`` and run eagerly on the
  card, and ``run`` takes one batch at a time, as under the seq hook.

Build a sequence- or tensor-parallel server before warming the engine: it
replaces ``engine.options`` and ``engine.parallel_hooks``, or shards the
model.

Each batch is a ``serve.batch`` span of the program's tracer
(``utils/profiling.py``), with its ``rows``, ``real_rows`` (the rows that
are requests, not repeats) and bucket ``n``, and two counters:
``serve.frame_rows`` (rows x n, the frame-rows the engine runs) and
``serve.useful_frame_rows`` (each real row's duration, at most n).

``rtf_report`` is the report in the reference benchmark's format
(benchmark.py:454-468, client_grpc.py:425-447).
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
import dataclasses
from dataclasses import dataclass

import numpy as np

from f5_tts_tpu_torch.infer.engine import InferenceEngine, pick_bucket
from f5_tts_tpu_torch.parallel import mesh as M
from f5_tts_tpu_torch.utils.profiling import span


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
            engine.parallel_hooks = (None, make_seq_constraint(mesh), engine.parallel_hooks[2])
            engine.options = dataclasses.replace(
                engine.options, backend=make_ring_attention(mesh, block_impl="auto"))
        if tensor_parallel and M.axis_size(mesh, M.MODEL_AXIS) > 1:
            M.shard_params(engine.model.transformer, mesh)
            engine.tensor_parallel = True
        self.data_rank, self.dp = M.data_rank_and_size(mesh)
        self._data_group = M.axis_group(mesh, M.DATA_AXIS)
        if batch_size % self.dp:
            raise ValueError(f"batch {batch_size} must divide over the data axis {self.dp}")

    def run(self, requests: list[Request], fetch_mel: bool = False, overlap: int = 2):
        """Processes all requests; returns (wavs, per_batch_latencies).

        ``overlap`` batches run concurrently (the concurrency-2 serving
        pattern of the reference's headline benchmark, README.md:131-138),
        and one at a time when the engine's calls issue collectives (the
        sequence-parallel hook, tensor parallelism, Picard over a mesh).
        With ``fetch_mel`` each request's generated mel [n, d] is kept in
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
            real = max(0, min(len(reqs), lo + per) - lo)  # this rank's rows that are requests
            reqs = (reqs + [reqs[-1]] * (B - len(reqs)))[lo:lo + per]  # pad with a repeat
            durs = [r.duration for r in reqs]
            n = pick_bucket(max(durs), eng.buckets)
            t0 = time.perf_counter()
            with span("serve.batch", rows=len(reqs), real_rows=real, n=n) as sp:
                if sp:
                    sp.count("serve.frame_rows", len(reqs) * n)
                    sp.count("serve.useful_frame_rows", sum(min(int(d), n) for d in durs[:real]))
                mels, ws, _ = eng.generate_batch(
                    [r.ref_mel for r in reqs], [r.text_ids for r in reqs], durs,
                    seeds=[r.seed for r in reqs], fetch_mel=fetch_mel)
            return ws, mels, time.perf_counter() - t0

        if eng._collective():
            overlap = 1  # the collectives, in one order on every rank
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
                     None if not fetch_mel else _cat_rows([p[g][1] for p in parts]),
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


def _cat_rows(mels: list) -> np.ndarray:
    """The data ranks' mels [rows, n_r, d] as one array: each rank's bucket
    n_r is its rows' own, so the shorter ones are zero-padded (frames past a
    row's duration are zero already)."""
    n = max(m.shape[1] for m in mels)
    return np.concatenate([np.pad(m, ((0, 0), (0, n - m.shape[1]), (0, 0))) for m in mels])


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
