"""Closed backlog through ``infer/serve.BatchServer.run`` (the eval path).

Set-up builds the engine, draws a pool of requests from the seed, takes
their reference mels with the engine's own ``ref_mel`` (as an eval script
prepares its prompts) and captures the one graph of each bucket the pool
can reach; spans time the two (``setup.ref_mels``, ``setup.captures``).  The window hands ``BatchServer.run`` the pool in chunks of
``chunk`` requests, one chunk after another, so the backlog is never empty
(each chunk holds the same sizes whatever the seed, so every seed's window
does the same work: ``BatchServer`` batches a chunk by sorted duration);
a batch that would start after ``--seconds`` is not started, and the window
runs from the first batch's start to the last one's end.  The traced run
profiles one more chunk of ``trace_chunk`` requests after the window.

Besides the comparison with the reference (``check.serving_errors``), the
check reads ``below_precision``: the engine's tensors held below the
configuration's stated precision, and its W8A8 option, once the window has
closed.  An engine that departs from what the configuration states is no
sound run, whatever its outputs read.
"""

from __future__ import annotations

import gc
import time
from types import SimpleNamespace

import numpy as np
import torch

from benchmark import check as cmp
from benchmark import program, traffic
from benchmark.trace import Trace


def setup(cfg, mix, seed, seconds, trace, device, spans, control=None):
    from f5_tts_tpu_torch.infer.engine import pick_bucket
    from f5_tts_tpu_torch.infer.serve import BatchServer, Request

    engine = program.build_engine(cfg, seed, device, mix["nfe"], mix["cfg_strength"], mix["sway"],
                                  quantize=control == "program")
    pool = traffic.requests(mix, seed, mix["pool"], block=mix["chunk"])
    with spans.span("setup.ref_mels"):
        served = [Request(ref_mel=engine.ref_mel(r.ref_wav), text_ids=r.text_ids,
                          duration=r.duration, seed=r.seed) for r in pool]
    srv = BatchServer(engine, batch_size=mix["batch"])
    with spans.span("setup.captures"):
        srv.warmup_all(sorted({pick_bucket(r.duration, engine.buckets) for r in pool}))
    st = SimpleNamespace(cfg=cfg, mix=mix, seed=seed, seconds=seconds, trace=trace,
                         device=device, spans=spans, engine=engine, srv=srv, pool=pool,
                         served=served, deadline=None, control=control)
    inner = engine.generate_batch

    def generate_batch(ref_mels, text_ids_list, durations, **kw):
        if st.deadline is not None and time.perf_counter() >= st.deadline:
            b = len(ref_mels)  # not started: outside the window
            return np.zeros((b, 1, 1), np.float32), [None] * b, [0] * b
        real = len({id(m) for m in ref_mels})  # the server pads with repeats of the last
        with spans.span("engine_call", b=len(ref_mels), real=real,
                        n=pick_bucket(max(durations), engine.buckets),
                        durs=[int(d) for d in durations[:real]]):
            return inner(ref_mels, text_ids_list, durations, **kw)

    engine.generate_batch = generate_batch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return st


def _cuda(device):
    return device if torch.device(device).type == "cuda" else None


def window(st, t0):
    mix, srv = st.mix, st.srv
    st.deadline = t0 + st.seconds
    done, pos = [], 0

    def chunk(size):
        nonlocal pos
        idx = [(pos + i) % len(st.pool) for i in range(size)]
        pos += size
        wavs, _ = srv.run([st.served[i] for i in idx], fetch_mel=True, overlap=mix["overlap"])
        for j, i in enumerate(idx):
            if wavs[j] is not None:
                done.append({"i": i, "wav": wavs[j], "mel": srv.mels[j]})

    while time.perf_counter() < st.deadline:
        chunk(mix["chunk"])
    calls = st.spans.of("engine_call")
    t_first, t_last = min(c[1] for c in calls), max(c[2] for c in calls)
    wall = t_last - t_first
    sr = st.cfg["mel_spec"]["target_sample_rate"]
    audio_s = sum(len(d["wav"]) for d in done) / sr
    tr = None
    if st.trace:  # a traced slice after the window: one more chunk
        st.deadline = None
        with Trace(st.spans, _cuda(st.device)) as tr:
            chunk(mix["trace_chunk"])
    st.done = done
    st.below_precision = program.below_precision(st.engine, st.cfg)
    ctx = {"calls": calls, "window": (t_first, t_last), "nfe": mix["nfe"],
           "trace_calls": [] if tr is None else st.spans.of("engine_call", lo=tr.t0)}
    return {"attempted": len(done), "failed": 0, "e2e": {"audio_s_per_s": audio_s / wall},
            "ctx": ctx, "trace": tr}


def release(st):
    """Drop the program's state before the reference runs."""
    del st.engine, st.srv, st.served
    gc.collect()
    if torch.device(st.device).type == "cuda":
        torch.cuda.empty_cache()


def check_items(st, k):
    """The sampled requests as ``check.serving_errors`` takes them."""
    sample = cmp.pick_sample(st.done, st.seed, k, lambda d: st.pool[d["i"]].duration)
    return [{"req": st.pool[d["i"]], "n": d["mel"].shape[0], "mel": d["mel"], "wav": d["wav"]}
            for d in sample]


def entry_lens(samples: int) -> int:
    """``engine.ref_mel``'s frames of an L-sample reference: 1 + L // hop."""
    return 1 + samples // traffic.HOP


def check(st, out, limits):
    items = check_items(st, st.mix["check_sample"])
    errs = cmp.serving_errors(st.cfg, st.mix, st.seed, st.device, items, entry_lens,
                              st.control)
    checks = cmp.serving_checks(errs, limits)
    if checks:
        checks["below_precision"] = {"value": st.below_precision,
                                     "limit": limits["below_precision"]}
    return checks
