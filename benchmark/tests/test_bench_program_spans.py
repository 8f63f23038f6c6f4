"""The readers of the program's spans and counters (``benchmark/program_spans.py``
and the five metrics that use it) on traced runs of every cell at the tiny
size on the CPU, and their arithmetic on planted records and device
operations (a CPU trace has no device operations)."""

import pytest

from benchmark import program_spans as PS
from benchmark import run
from benchmark.trace import Spans
from f5_tts_tpu_torch.utils import profiling as P

SEED = 2**31 + 11
CELLS = ["offline_f5v1_nfe32", "offline_e2_nfe32", "train_f5v1_38k"]
NEW = {"offline": ["engine_host_ms.offline", "serve_pad_pct.offline"],
       "train": ["step_host_ms.train", "step_idle_ms.train", "alloc_retries.train"]}


@pytest.fixture(scope="module")
def traced(tiny_root):
    """Each cell's traced run: (its result, the context its readers got)."""
    out = {}
    reader = run.Bench.reader
    for cell in CELLS:
        seen = {}

        def capture(self, metric, seen=seen):
            fn = reader(self, metric)

            def read(ctx):
                seen["ctx"] = ctx
                return fn(ctx)

            return read

        run.Bench.reader = capture
        try:
            res = run.run(cell, SEED, 2.0, True, "cpu", root=tiny_root)
        finally:
            run.Bench.reader = reader
        out[cell] = (res, seen["ctx"])
    return out


@pytest.mark.parametrize("cell", CELLS)
def test_traced_runs_report_the_program_metrics(traced, cell):
    res, ctx = traced[cell]
    assert res["correct"], res["checks"]
    m = res["metrics"]
    if cell.startswith("offline"):
        assert m["engine_host_ms.offline"]["value"] > 0
        assert 0 <= m["serve_pad_pct.offline"]["value"] < 100
        calls = PS.records(ctx, "engine.call")
        assert len(calls) == len(ctx["trace_calls"]) > 0
    else:
        assert m["step_host_ms.train"]["value"] > 0
        # a CPU trace holds no device operation, and the allocator's counters need a card
        assert "step_idle_ms.train" not in m and "alloc_retries.train" not in m
        steps = PS.records(ctx, "train.step")
        assert len(steps) == len(ctx["trace_steps"])
        assert all(r.attrs["b"] == b and r.attrs["n"] == n
                   for r, (b, n, _) in zip(steps, ctx["trace_steps"]))


@pytest.mark.parametrize("cell", CELLS[:2])
def test_the_serve_counters_equal_the_harness_count_of_the_same_calls(traced, tiny_root, cell):
    """``serve_pad_pct.offline`` counts inside the program what
    ``pad_share.offline`` reckons from the harness's engine-call spans; on
    the traced calls the two agree."""
    res, ctx = traced[cell]
    pad_share = run.Bench(tiny_root).reader("pad_share.offline")
    outside = pad_share({**ctx, "calls": ctx["trace_calls"]})
    assert res["metrics"]["serve_pad_pct.offline"]["value"] == pytest.approx(outside, abs=0.01)


def _rec(i, name, a, b, parent=None, **counters):
    return P.Record(i, name, 1, parent, int(a * 1e9), int(b * 1e9), {}, counters)


PLANTED = [_rec(1, "train.step", 10.0, 10.5), _rec(2, "train.forward", 10.1, 10.3, 1),
           _rec(3, "train.optimizer", 10.3, 10.45, 1)]
# gaps 10.15-10.2 (forward), 10.25-10.35 (forward to 10.3, optimizer after),
# 10.46-10.48 (the step, between its children) and 10.6-10.8 (outside every span)
OPS = [("k", 9.9, 10.15), ("k", 10.2, 10.25), ("k", 10.35, 10.46), ("k", 10.48, 10.6),
       ("k", 10.8, 11.0)]


def test_idle_gaps_go_to_the_innermost_program_span():
    idle = PS.idle_by_span({"ops": OPS}, PLANTED)
    assert set(idle) == {"train.forward", "train.optimizer", "train.step",
                         "outside every span"}
    assert idle["train.forward"] == pytest.approx(0.10, abs=1e-6)
    assert idle["train.optimizer"] == pytest.approx(0.05, abs=1e-6)
    assert idle["train.step"] == pytest.approx(0.02, abs=1e-6)
    assert idle["outside every span"] == pytest.approx(0.20, abs=1e-6)
    assert PS.gaps({"ops": OPS}) == [(10.15, 10.2), (10.25, 10.35), (10.46, 10.48), (10.6, 10.8)]


def _planted_ctx(monkeypatch, recs):
    monkeypatch.setattr(PS, "tracer", lambda: type("T", (), {"records": staticmethod(
        lambda: recs)}))
    spans = Spans()
    spans.items.append(("train_step", 0.0, 1.0, {}, int(9.95e9), int(10.55e9)))
    return {"trace": {"ops": OPS}, "trace_steps": [(2, 96, None)], "spans": spans}


def test_the_step_readers_on_planted_records(tiny_root, monkeypatch):
    bench = run.Bench(tiny_root)
    recs = PLANTED[:1] + [PLANTED[0]._replace(id=4, start_ns=int(5e9), end_ns=int(5.5e9))]
    recs = [recs[0]._replace(counters={"num_alloc_retries": 3})] + PLANTED[1:] + recs[1:]
    ctx = _planted_ctx(monkeypatch, recs)
    assert len(PS.records(ctx)) == 3  # the step of another run, at 5 s, is left out
    assert bench.reader("step_idle_ms.train")(ctx) == pytest.approx(170.0, abs=1e-3)
    assert bench.reader("step_host_ms.train")(ctx) == pytest.approx(500.0, abs=1e-3)
    assert bench.reader("alloc_retries.train")(ctx) == 3


def test_readers_read_nothing_from_a_program_without_the_tracer(tiny_root, monkeypatch):
    ctx = _planted_ctx(monkeypatch, PLANTED)
    monkeypatch.setattr(PS, "tracer", lambda: None)
    bench = run.Bench(tiny_root)
    for name in NEW["offline"] + NEW["train"]:
        assert bench.reader(name)({**ctx, "trace_calls": []}) is None
