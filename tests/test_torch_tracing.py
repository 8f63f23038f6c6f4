"""The program's tracer (``utils/profiling.py``) on the CPU: off it records
nothing and reads no clock; under ``torch.profiler`` its spans nest per
thread inside the session's wall window; the engine, the batch server and
the training step record their spans and counters (F5TTS_Tiny, NFE 2)."""

import torch_threads  # noqa: F401  (first: caps torch's threads per test worker)

import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from f5_tts_tpu_torch.infer.api import _seeded
from f5_tts_tpu_torch.infer.engine import EngineOptions, InferenceEngine, pick_bucket
from f5_tts_tpu_torch.infer.serve import BatchServer, Request
from f5_tts_tpu_torch.models.cfm import CFM
from f5_tts_tpu_torch.models.configs import MODEL_CONFIGS
from f5_tts_tpu_torch.models.vocos import Vocos
from f5_tts_tpu_torch.train import step as TS
from f5_tts_tpu_torch.utils import profiling as P

CFG = MODEL_CONFIGS["F5TTS_Tiny"]
BUCKETS = (256, 512)


@pytest.fixture(autouse=True)
def fresh_tracer():
    P.clear()
    yield
    P.disable()
    P.clear()


@pytest.fixture(scope="module")
def engine():
    return InferenceEngine(_seeded(lambda: CFM(CFG.arch), 0), CFG, vocoder=_seeded(Vocos, 1),
                           buckets=BUCKETS, options=EngineOptions(nfe_step=2))


def _requests(durs, seed=0):
    rng = np.random.default_rng(seed)
    d = CFG.mel.n_mel_channels
    return [Request(ref_mel=rng.standard_normal((40 + 3 * i, d)).astype(np.float32),
                    text_ids=rng.integers(0, 50, size=30).astype(np.int32), duration=dur, seed=i)
            for i, dur in enumerate(durs)]


def _by_name(recs, name):
    return [r for r in recs if r.name == name]


def _inside(child, parent):
    return parent.start_ns <= child.start_ns <= child.end_ns <= parent.end_ns


def test_off_the_tracer_records_nothing_and_reads_no_clock(engine, monkeypatch):
    def no_clock():
        raise AssertionError("the tracer read the clock while off")

    monkeypatch.setattr(P.time, "time_ns", no_clock)
    a, b = P.span("x", k=1), P.span("y")
    assert a is b and not a  # one shared no-op context
    with a as s:
        s.set(k=2)
        s.count("c", 3)
        P.count("c")
    reqs = _requests([200, 150])
    engine.generate_batch([r.ref_mel for r in reqs], [r.text_ids for r in reqs],
                          [r.duration for r in reqs], seeds=[0, 1])
    assert P.records() == []


def test_spans_nest_per_thread_inside_the_profiler_session():
    both = threading.Barrier(2, timeout=30)  # both threads alive at once: distinct idents

    def work(tag):
        with P.span("outer", tag=tag):
            if tag < 2:
                both.wait()
            with P.span("inner") as sp:
                sp.count("n", 2)
                P.count("n")
            with P.span("inner"):
                time.sleep(0.001)

    w0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        assert P.span("probe")
        threads = [threading.Thread(target=work, args=(t,)) for t in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        work(2)
    w1 = time.time_ns()
    assert not P.span("probe") and not any(t.is_alive() for t in threads)
    recs = P.records()
    assert len(recs) == 9
    outers = _by_name(recs, "outer")
    assert sorted(r.attrs["tag"] for r in outers) == [0, 1, 2]
    assert len({r.thread for r in outers}) == 3
    for o in outers:
        kids = P.children(recs, o)
        assert [k.name for k in kids] == ["inner", "inner"]
        assert all(k.thread == o.thread and _inside(k, o) for k in kids)
        assert kids[0].counters == {"n": 3} and kids[1].counters == {}
        assert o.parent is None
    assert all(w0 <= r.start_ns <= r.end_ns <= w1 for r in recs)
    with P.span("after"):
        pass
    assert len(P.records()) == 9  # off again once the session ends


def test_the_buffer_is_bounded():
    tr = P.Tracer(capacity=4)
    tr.enable()
    for i in range(10):
        with tr.span("s", i=i):
            pass
    assert [r.attrs["i"] for r in tr.records()] == [6, 7, 8, 9]
    tr.clear()
    assert tr.records() == []


@pytest.mark.parametrize("entry", ["mel", "wav"])
def test_an_engine_call_records_its_phases_inside_it(engine, entry):
    reqs = _requests([300, 220])
    P.enable()
    if entry == "mel":
        _, wavs, _ = engine.generate_batch([r.ref_mel for r in reqs], [r.text_ids for r in reqs],
                                           [r.duration for r in reqs], seeds=[0, 1])
    else:
        ref = np.sin(np.arange(24_000) * 0.01).astype(np.float32) * 0.3
        _, wavs, _ = engine.generate_batch_from_wav(ref, [r.text_ids for r in reqs],
                                                    [r.duration for r in reqs], seeds=[0, 1])
    P.disable()
    recs = P.records()
    (call,) = _by_name(recs, "engine.call")
    assert call.attrs["entry"] == entry and call.attrs["b"] == 2 and call.attrs["n"] == 512
    kids = P.children(recs, call)
    names = [k.name for k in kids]
    # the CPU engine runs its call eagerly: no lock, no capture
    assert names == ["engine.prepare", "engine.enqueue", "engine.fetch", "engine.fetch",
                     "engine.trim"]
    assert all(_inside(k, call) for k in kids)
    assert all(a.end_ns <= b.start_ns for a, b in zip(kids, kids[1:]))
    covered = sum(k.end_ns - k.start_ns for k in kids)
    assert covered >= 0.9 * (call.end_ns - call.start_ns)
    (up,) = P.children(recs, kids[0])
    assert up.name == "engine.upload" and up.counters["bytes"] > 0
    mel_fetch, wav_fetch = kids[2], kids[3]
    assert mel_fetch.counters["bytes"] == 2 * 512 * CFG.mel.n_mel_channels * 4
    assert wav_fetch.counters["bytes"] % 2 == 0
    assert wav_fetch.counters["bytes"] // 2 >= sum(len(w) for w in wavs) // 2


def test_a_two_thread_batch_server_records_batches_and_frame_rows(engine):
    durs = [120, 460, 300, 250, 500]
    reqs = _requests(durs)
    srv = BatchServer(engine, batch_size=2)
    P.enable()
    srv.run(reqs, overlap=2)
    P.disable()
    recs = P.records()
    batches = _by_name(recs, "serve.batch")
    calls = _by_name(recs, "engine.call")
    assert len(batches) == len(calls) == 3
    for c in calls:
        (parent,) = [b for b in batches if b.id == c.parent]
        assert parent.thread == c.thread and _inside(c, parent)
        assert parent.attrs["rows"] == c.attrs["b"] and parent.attrs["n"] == c.attrs["n"]
        kids = [k.name for k in P.children(recs, c)]
        assert kids[0] == "engine.prepare" and kids[-1] == "engine.trim"
    groups = [sorted(durs)[i:i + 2] for i in range(0, 5, 2)]
    frame_rows = sum(2 * pick_bucket(max(g), BUCKETS) for g in groups)
    useful = sum(min(d, pick_bucket(max(g), BUCKETS)) for g in groups for d in g)
    assert sum(b.counters["serve.frame_rows"] for b in batches) == frame_rows
    assert sum(b.counters["serve.useful_frame_rows"] for b in batches) == useful
    assert sum(c.attrs["b"] * c.attrs["n"] for c in calls) == frame_rows
    assert sorted(b.attrs["real_rows"] for b in batches) == [1, 2, 2]


@pytest.mark.parametrize("mixed", [False, True])
def test_a_train_step_records_its_phases_in_order(mixed):
    torch.manual_seed(0)
    model = CFM(CFG.arch)
    ema = CFM(CFG.arch).requires_grad_(False)
    ocfg = TS.OptimConfig(mixed_precision=mixed, num_warmup_updates=1, total_updates=5,
                          learning_rate=1e-3, ema_update_after_step=0, ema_update_every=1)
    opt = TS.make_optimizer(list(model.parameters()), ocfg)
    b, n = 2, 96
    batch = {"mel": torch.randn(b, n, CFG.mel.n_mel_channels),
             "text_ids": torch.randint(0, 50, (b, 20)), "lens": torch.tensor([96, 70])}
    P.enable()
    micro, _ = TS.train_step(model, opt, ema, 4, batch, seed=1, opt_cfg=ocfg)
    P.disable()
    recs = P.records()
    (st,) = _by_name(recs, "train.step")
    assert st.attrs == {"b": b, "micro": 4, "n": n} and micro == 5
    assert st.counters == {}  # the allocator's counters are read on a CUDA device only
    kids = P.children(recs, st)
    want = ["train.mel", "train.cast", "train.forward", "train.backward", "train.norm",
            "train.optimizer", "train.ema"]
    assert [k.name for k in kids] == [w for w in want if mixed or w != "train.cast"]
    assert all(_inside(k, st) for k in kids)
    assert all(a.end_ns <= b.start_ns for a, b in zip(kids, kids[1:]))
    assert sum(k.end_ns - k.start_ns for k in kids) >= 0.9 * (st.end_ns - st.start_ns)
    assert P.alloc_counters("cpu") is None
