"""Online dynamic batching for serving: the Triton front-end equivalent.

JAX counterpart: ``f5_tts_tpu/infer/batcher.py``, with the same window,
batch-size ladder and overlap-2 worker pool.  The reference serves through
Triton's dynamic batcher: concurrent client requests are merged into one
engine batch if they arrive within a short queue window (reference
runtime/triton_trtllm/model_repo_f5_tts/f5_tts/config.pbtxt:15-20 ->
max_batch_size 4, dynamic_batching.max_queue_delay_microseconds 1000, and
f5_tts_trtllm.py:412-445 which pads/concats the batch).

A scheduler thread drains a queue: the first request opens a batch window
of ``queue_delay_ms``; requests arriving inside the window join, up to
``max_batch``.  Each group runs ONE engine call (its batch padded up to a
small ladder of batch sizes, so each (bucket, batch) has one CUDA graph on
the card) and results fan back to the callers through futures.  Two workers
run groups, so one group's host fetch overlaps the next group's replay (the
engine replays under its lock and fetches outside it).

``close()`` resolves every future: a submit and the close are ordered by a
lock, so nothing is queued after the scheduler's stop mark, and whatever
the scheduler did not take (a join that timed out, a pool already shut)
fails with "batcher closed".  The JAX batcher could leave such a future
hanging.

Two integration surfaces:
- ``DynamicBatcher.submit/generate``: explicit per-request API.
- ``BatchedEngine``: duck-typed ``InferenceEngine`` facade exposing the
  engine's generate methods; the shared pipeline and the socket/HTTP
  servers can use it wherever an engine is expected, so requests from
  independent client threads merge transparently.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np

from f5_tts_tpu_torch.infer.engine import InferenceEngine, pick_bucket


@dataclass(eq=False)  # identity equality — fields hold numpy arrays
class _Item:
    """One utterance chunk queued for generation."""

    text_ids: np.ndarray  # [nt] (already filtered of -1 padding)
    duration: int  # total frames (ref + gen)
    seed: int
    group_key: tuple  # (path, duration bucket) — computed eagerly at submit
    ref_mel: np.ndarray | None = None  # [n_ref, d] — cond-upload path
    ref_wav: np.ndarray | None = None  # [S] float32 — fused in-graph-mel path
    fetch_mel: bool = False
    future: Future = field(default_factory=Future)
    t_enqueue: float = 0.0


def _batch_size_ladder(max_batch: int) -> tuple[int, ...]:
    """1, 2, 4, ... up to max_batch: the padded batch sizes, one graph each."""
    sizes = []
    b = 1
    while b < max_batch:
        sizes.append(b)
        b *= 2
    sizes.append(max_batch)
    return tuple(sizes)


class DynamicBatcher:
    """Request queue + scheduler thread in front of an ``InferenceEngine``."""

    def __init__(
        self,
        engine: InferenceEngine,
        max_batch: int = 4,
        queue_delay_ms: float = 4.0,
        batch_sizes: tuple[int, ...] | None = None,
        overlap: int = 2,
    ):
        self.engine = engine
        self.max_batch = max(1, int(max_batch))
        self.queue_delay_s = max(0.0, queue_delay_ms) / 1000.0
        self.batch_sizes = tuple(sorted(batch_sizes or _batch_size_ladder(self.max_batch)))
        assert self.batch_sizes[-1] >= self.max_batch
        # groups run on a small worker pool so the replay of group i+1
        # overlaps the host fetch of group i (serve.py run(overlap=2))
        self._pool = ThreadPoolExecutor(max_workers=max(1, int(overlap)),
                                        thread_name_prefix="dyn-batch-run")
        self._q: queue.SimpleQueue[_Item | None] = queue.SimpleQueue()
        self._stats_lock = threading.Lock()
        self._stats = {
            "requests": 0,
            "batches": 0,
            "batched_rows": 0,  # incl. none; excl. padding
            "padded_rows": 0,
            "queue_ms_total": 0.0,
            "compute_ms_total": 0.0,
        }
        self._closed = False
        self._submit_lock = threading.Lock()  # orders submits against close()
        self._thread = threading.Thread(target=self._loop, daemon=True, name="dyn-batcher")
        self._thread.start()

    # ------------------------------------------------------------------ API
    def submit(
        self,
        text_ids: np.ndarray,
        duration: int,
        seed: int = 0,
        ref_mel: np.ndarray | None = None,
        ref_wav: np.ndarray | None = None,
        fetch_mel: bool = False,
    ) -> Future:
        """Enqueue one utterance; the future resolves to
        ``(wav float32 [S_gen], gen_frames int, mel [n, d] | None)``."""
        if (ref_mel is None) == (ref_wav is None):
            raise ValueError("provide exactly one of ref_mel / ref_wav")
        # requests batch together only when they share a compiled-graph family:
        # same input path and same duration bucket.  pick_bucket raises here,
        # synchronously, for out-of-range durations (never in the scheduler).
        key = ("wav" if ref_wav is not None else "mel",
               pick_bucket(int(duration), self.engine.buckets))
        item = _Item(
            text_ids=np.asarray(text_ids), duration=int(duration), seed=int(seed),
            group_key=key, ref_mel=ref_mel, ref_wav=ref_wav, fetch_mel=fetch_mel,
            t_enqueue=time.perf_counter(),
        )
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("batcher is closed")
            self._q.put(item)
        return item.future

    def generate(self, *args, timeout: float | None = None, **kwargs):
        """Blocking submit."""
        return self.submit(*args, **kwargs).result(timeout=timeout)

    def stats(self) -> dict:
        """Server-side queue/compute stats in the spirit of Triton's
        inference-statistics report (reference client_grpc.py:425-447)."""
        with self._stats_lock:
            s = dict(self._stats)
        n = max(s["requests"], 1)
        nb = max(s["batches"], 1)
        s["avg_batch_size"] = s["batched_rows"] / nb
        s["queue_ms_avg"] = s["queue_ms_total"] / n
        s["compute_ms_avg_per_batch"] = s["compute_ms_total"] / nb
        return s

    def close(self, timeout: float = 30.0):
        """Stop taking requests, run what was queued, and resolve every
        future: one the scheduler did not take fails with "batcher
        closed"."""
        with self._submit_lock:
            self._closed = True
            self._q.put(None)  # the last item ever queued
        self._thread.join(timeout=timeout)
        self._pool.shutdown(wait=True)
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                _fail([item])

    # ------------------------------------------------------------ scheduler
    def _loop(self):
        pending: list[_Item] = []
        while True:
            if not pending:
                item = self._q.get()
                if item is None:
                    return
                pending.append(item)
            # batch window opened by the oldest pending request
            deadline = pending[0].t_enqueue + self.queue_delay_s
            while len(pending) < self.max_batch:
                timeout = deadline - time.perf_counter()
                if timeout <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=timeout)
                except queue.Empty:
                    break
                if nxt is None:
                    self._flush(pending)
                    return
                pending.append(nxt)
            # group compatible requests; anything left waits for the next window
            key0 = pending[0].group_key
            matching = [it for it in pending if it.group_key == key0]
            rest = [it for it in pending if it.group_key != key0]
            group, overflow = matching[: self.max_batch], matching[self.max_batch :]
            pending = overflow + rest
            self._dispatch(group)

    def _flush(self, pending: list[_Item]):
        while pending:
            key0 = pending[0].group_key
            matching = [it for it in pending if it.group_key == key0]
            rest = [it for it in pending if it.group_key != key0]
            group, overflow = matching[: self.max_batch], matching[self.max_batch :]
            pending = overflow + rest
            self._dispatch(group)

    def _dispatch(self, group: list[_Item]):
        try:
            self._pool.submit(self._run_group, group)
        except RuntimeError:  # the pool is shut: close() timed out on the scheduler
            _fail(group)

    def _run_group(self, group: list[_Item]):
        t0 = time.perf_counter()
        real = len(group)
        padded_b = next(b for b in self.batch_sizes if b >= real)
        rows = group + [group[-1]] * (padded_b - real)
        try:
            if group[0].ref_wav is not None:
                mels, wavs, gen_frames = self.engine.generate_batch_from_wavs(
                    [r.ref_wav for r in rows],
                    [r.text_ids for r in rows],
                    [r.duration for r in rows],
                    seeds=[r.seed for r in rows],
                    fetch_mel=any(r.fetch_mel for r in group),
                )
            else:
                mels, wavs, gen_frames = self.engine.generate_batch(
                    [r.ref_mel for r in rows],
                    [r.text_ids for r in rows],
                    [r.duration for r in rows],
                    seeds=[r.seed for r in rows],
                    fetch_mel=any(r.fetch_mel for r in group),
                )
        except Exception as e:  # noqa: BLE001 — fan the failure to every caller
            for it in group:
                if not it.future.done():
                    it.future.set_exception(e)
            return
        t1 = time.perf_counter()
        with self._stats_lock:
            self._stats["requests"] += real
            self._stats["batches"] += 1
            self._stats["batched_rows"] += real
            self._stats["padded_rows"] += padded_b - real
            self._stats["queue_ms_total"] += sum((t0 - it.t_enqueue) * 1000 for it in group)
            self._stats["compute_ms_total"] += (t1 - t0) * 1000
        for i, it in enumerate(group):
            mel_i = mels[i] if (mels is not None and it.fetch_mel) else None
            it.future.set_result((wavs[i], gen_frames[i], mel_i))


def _fail(items: list[_Item]):
    for it in items:
        if not it.future.done():
            it.future.set_exception(RuntimeError("batcher closed"))


class BatchedEngine:
    """Duck-typed ``InferenceEngine`` facade over a ``DynamicBatcher``.

    Exposes the engine's three batch-generate entry points by fanning each
    row into the batcher and waiting on all futures — so one client's chunk batch and other
    clients' concurrent requests merge into shared device batches.
    Engine attributes (model_cfg, buckets, hop, ...) delegate to the real
    engine so it drops into any engine-shaped call site.
    """

    def __init__(self, batcher: DynamicBatcher):
        object.__setattr__(self, "batcher", batcher)

    def __getattr__(self, name):
        return getattr(self.batcher.engine, name)

    def __setattr__(self, name, value):
        # forward writes to the real engine too: callers that tweak
        # engine.options / parallel_hooks (api.infer, BatchServer) must hit
        # the engine the batcher actually runs, not shadow it on the facade
        setattr(self.batcher.engine, name, value)

    def _finish(self, futures, fetch_mel, durations):
        results = [f.result() for f in futures]
        wavs = [r[0] for r in results]
        gen_frames = [r[1] for r in results]
        mels = None
        if fetch_mel:
            eng = self.batcher.engine
            n = pick_bucket(max(durations), eng.buckets)
            d = eng.model_cfg.mel.n_mel_channels
            mels = np.zeros((len(results), n, d), np.float32)
            for i, r in enumerate(results):
                if r[2] is not None:
                    m = r[2][:n]
                    mels[i, : len(m)] = m
        return mels, wavs, gen_frames

    def generate_batch(self, ref_mels, text_ids_list, durations, seeds=None,
                       decode=True, fetch_mel=True):
        seeds = seeds or list(np.random.randint(0, 2**31 - 1, size=len(ref_mels)))
        futs = [
            self.batcher.submit(t, dur, seed=s, ref_mel=m, fetch_mel=fetch_mel)
            for m, t, dur, s in zip(ref_mels, text_ids_list, durations, seeds)
        ]
        return self._finish(futs, fetch_mel, durations)

    def generate_batch_from_wav(self, ref_wav, text_ids_list, durations, seeds=None,
                                decode=True, fetch_mel=True):
        seeds = seeds or list(np.random.randint(0, 2**31 - 1, size=len(text_ids_list)))
        futs = [
            self.batcher.submit(t, dur, seed=s, ref_wav=ref_wav, fetch_mel=fetch_mel)
            for t, dur, s in zip(text_ids_list, durations, seeds)
        ]
        return self._finish(futs, fetch_mel, durations)

    def generate_batch_from_wavs(self, ref_wavs, text_ids_list, durations, seeds=None,
                                 decode=True, fetch_mel=True):
        seeds = seeds or list(np.random.randint(0, 2**31 - 1, size=len(ref_wavs)))
        futs = [
            self.batcher.submit(t, dur, seed=s, ref_wav=w, fetch_mel=fetch_mel)
            for w, t, dur, s in zip(ref_wavs, text_ids_list, durations, seeds)
        ]
        return self._finish(futs, fetch_mel, durations)


def wrap_engine(engine: InferenceEngine, max_batch: int = 4,
                queue_delay_ms: float = 4.0) -> BatchedEngine:
    """One-liner used by the servers: engine -> dynamically-batched engine."""
    return BatchedEngine(DynamicBatcher(engine, max_batch=max_batch,
                                        queue_delay_ms=queue_delay_ms))
