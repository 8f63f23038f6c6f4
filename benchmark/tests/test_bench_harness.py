"""Whole runs of every cell on the CPU at the tiny size (the harness's look
for a chip skipped): the comparison comes out correct; with each fault the
cell can have planted under the timed path it comes out not correct; the
control reads far above the program; and a configuration, a traffic mix and
a per-layer metric added as files plus entries are found by name."""

import json
import os
import shutil

import pytest
import torch

from benchmark import control, run

CELLS = ["offline_f5v1_nfe32", "offline_e2_nfe32", "train_f5v1_38k"]
SEED = 2**31 + 5


@pytest.fixture(scope="module")
def sound(tiny_root):
    return {c: run.run(c, SEED, 3.0, c.startswith("train"), "cpu", root=tiny_root) for c in CELLS}


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(sound, cell):
    res = sound[cell]
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert all(c["value"] < 1e-3 for c in res["checks"].values()), res["checks"]


def test_traced_runs_report_their_metrics(sound):
    assert {"pad_share.train", "mfu_pct.train", "input_wait_ms.train"} <= set(
        sound["train_f5v1_38k"]["metrics"])
    assert "breakdown" in sound["train_f5v1_38k"]


def _alter_answer(monkeypatch, entry):
    from f5_tts_tpu_torch.infer import engine as E

    fn = getattr(E, entry)

    def altered(*a, **kw):
        mel, wav = fn(*a, **kw)
        return mel + 0.5, wav

    monkeypatch.setattr(E, entry, altered)


def _half_batch_served(monkeypatch, entry):
    from f5_tts_tpu_torch.infer import engine as E

    fn = getattr(E, entry)

    def half(*a, **kw):
        mel, wav = fn(*a, **kw)
        h = (mel.shape[0] + 1) // 2
        mel, wav = mel.clone(), wav.clone()
        mel[h:], wav[h:] = 0, 0
        return mel, wav

    monkeypatch.setattr(E, entry, half)


def _step_unchanged(monkeypatch):
    from f5_tts_tpu_torch.train import step as S

    def unchanged(model, optimizer, ema, micro, batch, seed, cfg, **kw):
        zero = torch.zeros(())
        return micro + 1, {"loss": zero, "grad_norm": zero}

    monkeypatch.setattr(S, "train_step", unchanged)


def _ema_not_updated(monkeypatch):
    from f5_tts_tpu_torch.train import step as S

    monkeypatch.setattr(S, "ema_update", lambda *a, **kw: None)


def _half_batch_loss(monkeypatch):
    from f5_tts_tpu_torch.models import cfm

    fn = cfm.loss

    def half(model, cfg, mel, text_ids, lens, **kw):
        b = mel.shape[0]
        kw["valid"] = (torch.arange(b) < max(1, b // 2)).float()
        return fn(model, cfg, mel, text_ids, lens, **kw)

    monkeypatch.setattr(cfm, "loss", half)


FAULTS = [
    ("offline_f5v1_nfe32", "answer altered", lambda mp: _alter_answer(mp, "sample_and_decode")),
    ("offline_f5v1_nfe32", "half batch", lambda mp: _half_batch_served(mp, "sample_and_decode")),
    ("offline_e2_nfe32", "answer altered", lambda mp: _alter_answer(mp, "sample_and_decode")),
    ("offline_e2_nfe32", "half batch", lambda mp: _half_batch_served(mp, "sample_and_decode")),
    ("train_f5v1_38k", "state unchanged", _step_unchanged),
    ("train_f5v1_38k", "half batch", _half_batch_loss),
    ("train_f5v1_38k", "EMA not updated", _ema_not_updated),
]


@pytest.mark.parametrize("cell,fault,plant", FAULTS, ids=[f"{c}-{f}" for c, f, _ in FAULTS])
def test_a_planted_fault_is_not_correct(tiny_root, monkeypatch, cell, fault, plant):
    plant(monkeypatch)
    res = run.run(cell, SEED, 3.0, False, "cpu", root=tiny_root)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", ["offline_f5v1_nfe32", "offline_e2_nfe32"])
def test_the_serving_control_reads_far_above_the_program(sound, tiny_root, cell):
    low = control.serving(cell, SEED, 3.0, "cpu", root=tiny_root, mode="reference")
    assert not low["correct"]
    for k in ("mel_err", "wav_err"):
        assert low[k] > 10 * sound[cell]["checks"][k]["value"], (k, low, sound[cell]["checks"])


def test_the_programs_own_w8a8_path_is_not_correct(sound, tiny_root):
    low = control.serving("offline_f5v1_nfe32", SEED, 3.0, "cpu", root=tiny_root)
    assert not low["correct"], low
    assert low["below_precision"] > 0 and sound["offline_f5v1_nfe32"]["checks"][
        "below_precision"]["value"] == 0


def test_the_training_control_and_fault_read_far_above_the_program(tiny_root):
    got = control.training("train_f5v1_38k", SEED, "cpu", root=tiny_root)
    for k in ("loss_gap", "grad_gap", "change_gap"):
        v = got["program"][k]
        assert got["control"][k] > 10 * v and got["half_batch"][k] > 10 * v, (k, got)
    assert got["program"]["ema_gap"] < 1e-3, got


def test_added_files_are_found_by_name(tiny_root, tmp_path):
    root = str(tmp_path / "copy")
    shutil.copytree(tiny_root, root)
    path = os.path.join(root, "BENCHMARK.json")
    spec = json.load(open(path))
    b = os.path.join(root, "benchmark")
    cfg = json.load(open(os.path.join(b, "configs", "f5tts_v1_base.json")))
    cfg["arch"]["ff_mult"] = 3
    json.dump(cfg, open(os.path.join(b, "configs", "dummy_model.json"), "w"))
    mix = json.load(open(os.path.join(b, "traffic", "offline_nfe32.json")))
    mix.update(batch=4, chunk=4)
    json.dump(mix, open(os.path.join(b, "traffic", "dummy_mix.json"), "w"))
    open(os.path.join(b, "metrics", "dummy_rows.offline.py"), "w").write(
        "def read(ctx):\n    return float(sum(c[3]['b'] for c in ctx['calls']))\n")
    shutil.copy(os.path.join(b, "limits", "offline_f5v1_nfe32.json"),
                os.path.join(b, "limits", "dummy_cell.json"))
    spec["configs"].append({"name": "dummy_model", "source": "https://example.org/dummy",
                            "file": "benchmark/configs/dummy_model.json", "reduced": [],
                            "why": "a test"})
    spec["workloads"].append({"name": "dummy_cell", "config": "dummy_model",
                              "traffic": "dummy_mix", "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "dummy_rows.offline", "unit": "rows", "better": "higher",
                              "source": "program_span", "layer": "engine (infer/engine.py)",
                              "moves": "audio_s_per_s", "workloads": ["dummy_cell"]})
    for m in spec["end_to_end"]:
        if m["name"] == "audio_s_per_s":
            m["workloads"].append("dummy_cell")
    json.dump(spec, open(path, "w"))
    res = run.run("dummy_cell", SEED, 2.0, True, "cpu", root=root)
    assert res["correct"], res["checks"]
    assert res["metrics"]["dummy_rows.offline"]["value"] % 4 == 0
    res = run.run("dummy_cell", SEED, 2.0, False, "cpu", root=root)
    assert set(res["metrics"]) == {"audio_s_per_s", "setup_s"}
