"""The last repo-level scripts of the port on the CPU, held to their JAX
counterparts under ``scripts/``.

- ``smoke``: ``--device cpu`` writes a finite wav and prints JAX's ``ok:``
  line; the ``F5TTS.infer`` chain it runs (F5TTS_Tiny) equals JAX's on the
  same weights (the port's seeded init with the zero-initialized
  projections filled, written once and read by both ``F5TTS``s) and the
  same noise (JAX's draw per seed handed to the port's engine): the mel
  within 1e-4.
- ``count_max_epoch`` and ``count_max_epoch_precise`` print JAX's lines on
  the same synthetic ``duration.json``.
- ``bench_input_pipeline``: on four short files each collate path gives
  JAX's ``lens`` and mel (or wav), and the script runs to its end.
- ``bench_step_breakdown``: ``kernel_table`` reads a CPU ``torch.profiler``
  trace's top rows; every mode raises on a non-CUDA device.
- ``run_serving.sh`` and ``eval_infer_batch.sh`` parse (``bash -n``), each
  ``python -m`` module they name is the port's and accepts the flags given,
  and no line names the JAX package or a JAX console name.
- the speak probe: corpus, held-out arrays and decoding bitwise JAX's, its
  ``ModelConfig`` JAX's field by field; on carried tiny weights the CER
  sampler's mel within 1e-4 of JAX's ``cfm.sample`` with equal decoded
  strings, the order MSE within 1e-5 relative; ``--tiny --device cpu`` end
  to end.
- the Picard probe: corpus and ``dominant_tone`` bitwise JAX's; on carried
  tiny weights with the same noise ``raw_sample`` takes JAX's sweeps at each
  tolerance, the mel within 1e-4; ``--tiny --device cpu --epochs 1`` end to
  end.

JAX's scripts are loaded from their files; the loops JAX keeps inside its
``main`` (the held-out set, ``vel_at``, ``raw_sample``) are restated here
with JAX's functions.  fp32 on the CPU.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads per test worker)

import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import re
import shlex
import subprocess
import sys
import tomllib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5_tts_tpu.models import cfm as JC
from f5_tts_tpu.models import dit as JD
from f5_tts_tpu.models.configs import MODEL_CONFIGS as JAX_CONFIGS
from f5_tts_tpu.ops import mel as JM
from f5_tts_tpu.utils.ckpt import params_from_state
from f5_tts_tpu_torch.models.backbones import randomize_zero_init
from f5_tts_tpu_torch.models.cfm import CFM
from f5_tts_tpu_torch.scripts import bench_input_pipeline as TBIP
from f5_tts_tpu_torch.scripts import bench_step_breakdown as TBSB
from f5_tts_tpu_torch.scripts import train_picard_probe as TPP
from f5_tts_tpu_torch.scripts import train_speak_probe as TSP

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "f5_tts_tpu_torch", "scripts")
MEL_TOL = 1e-4


def jax_script(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stdout(fn, *a, **k) -> list[str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*a, **k)
    return buf.getvalue().splitlines()


def _carried(arch, jarch, seed: int):
    """(port CFM, JAX params) holding the same seeded weights, the
    zero-initialized projections filled."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = CFM(arch).eval().requires_grad_(False)
    randomize_zero_init(model.transformer, torch.Generator().manual_seed(seed + 1))
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    return model, params_from_state(state, jarch)


# ---------------------------------------------------------------- smoke


def test_smoke_writes_a_finite_wav_and_prints_the_ok_line(tmp_path):
    from f5_tts_tpu_torch.audio.io import load_wav
    from f5_tts_tpu_torch.scripts import smoke

    out = str(tmp_path / "smoke.wav")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = smoke.main([out, "--device", "cpu"])
    last = buf.getvalue().splitlines()[-1]
    spec = res["spec"]
    assert last == (f"ok: {out} ({len(res['wav'])/res['sr']:.2f}s @ 24000 Hz, "
                    f"mel {spec.shape[0]}x{spec.shape[1]}, seed 0)")
    assert re.fullmatch(r"ok: \S+ \(\d+\.\d\ds @ 24000 Hz, mel 100x\d+, seed 0\)", last)
    wav, sr = load_wav(out)
    assert sr == 24000 and len(wav) > 0 and np.isfinite(wav).all()
    assert res["launches"] == {}  # the CPU launches no kernel


def test_f5tts_tiny_infer_chain_matches_jax(tmp_path, monkeypatch):
    from f5_tts_tpu.infer.api import F5TTS as JF5TTS
    from f5_tts_tpu_torch.infer import engine as TE
    from f5_tts_tpu_torch.infer.api import F5TTS, _seeded
    from f5_tts_tpu_torch.models.vocos import Vocos

    tts = F5TTS(model="F5TTS_Tiny", init_random=True, device="cpu", nfe_step=4)
    randomize_zero_init(tts.engine.model.transformer, torch.Generator().manual_seed(5))
    ckpt, voc = str(tmp_path / "tiny.pt"), str(tmp_path / "vocos.pt")
    torch.save(tts.engine.model.state_dict(), ckpt)
    torch.save(_seeded(Vocos, 1).state_dict(), voc)

    def jax_noise(seeds, n, d, device):
        return torch.from_numpy(np.stack([np.asarray(jax.random.normal(
            jax.random.PRNGKey(int(s)), (n, d), dtype=jnp.float32)) for s in seeds]))

    monkeypatch.setattr(TE, "draw_noise", jax_noise)
    ref = os.path.join(REPO, "examples", "assets", "basic_ref_en.wav")
    args = (ref, "Some call me nature, others call me mother nature.",
            "the quick brown fox jumps over the lazy dog.")
    port = F5TTS(model="F5TTS_Tiny", ckpt_file=ckpt, vocoder_local_path=voc, device="cpu",
                 nfe_step=4)
    jaxs = JF5TTS(model="F5TTS_Tiny", ckpt_file=ckpt, vocoder_local_path=voc, device="cpu",
                  nfe_step=4)
    _, sr_t, spec_t = port.infer(*args, seed=0)
    _, sr_j, spec_j = jaxs.infer(*args, seed=0)
    assert sr_t == sr_j and spec_t.shape == spec_j.shape
    np.testing.assert_allclose(spec_t, np.asarray(spec_j), atol=MEL_TOL, rtol=0)


# ------------------------------------------------------------ epoch counts


def test_count_max_epoch_prints_jax_lines():
    from f5_tts_tpu_torch.scripts import count_max_epoch

    jax_out = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "count_max_epoch.py")],
                             capture_output=True, text=True, check=True).stdout.splitlines()
    assert _stdout(count_max_epoch.main) == jax_out and len(jax_out) == 3


def test_count_max_epoch_precise_prints_jax_lines(tmp_path, monkeypatch):
    from f5_tts_tpu_torch.scripts import count_max_epoch_precise

    durs = np.random.default_rng(3).uniform(0.4, 28.0, 3000).round(3).tolist()
    (tmp_path / "duration.json").write_text(json.dumps({"duration": durs}))
    argv = ["--dataset_dir", str(tmp_path), "--frames_per_device", "9600", "--num_devices", "4",
            "--wanted_updates", "50000"]
    J = jax_script("count_max_epoch_precise")
    monkeypatch.setattr(sys, "argv", ["count_max_epoch_precise.py", *argv])
    jax_out = _stdout(J.main)
    assert _stdout(count_max_epoch_precise.main, argv) == jax_out and len(jax_out) == 2


# ------------------------------------------------------- input pipeline


def test_input_pipeline_collates_match_jax(tmp_path):
    from f5_tts_tpu.ops.mel import MelConfig as JMelConfig
    from f5_tts_tpu.train import dataset as JDS
    from f5_tts_tpu_torch.ops.mel import MelConfig
    from f5_tts_tpu_torch.train.dataset import CustomDataset

    rows = TBIP.make_rows(4, str(tmp_path / "wavs"), 0.8, 1.6)
    rng = np.random.default_rng(0)  # JAX's draws, as its main makes them
    for r in rows:
        dur = float(rng.uniform(0.8, 1.6))
        rng.standard_normal(int(dur * TBIP.SR))
        assert r["duration"] == dur
    mel_cfg, jmel_cfg = MelConfig(), JMelConfig()
    ds = CustomDataset(rows, durations=[r["duration"] for r in rows], mel_cfg=mel_cfg)
    jds = JDS.CustomDataset(rows, durations=[r["duration"] for r in rows], mel_cfg=jmel_cfg)
    batch = [0, 1, 2, 3]
    paths = dict(TBIP.collate_paths(ds, TBIP.compressed_copies(rows, mel_cfg), mel_cfg))
    want_wav = JDS.collate_wav_batch(jds.wav_batch(batch), None, "byte", jmel_cfg)
    want_mel = JDS.collate_batch([jds[i] for i in batch], None, "byte")
    checked = 0
    for name, fn in paths.items():
        got = fn(batch)
        if name.startswith("mel-path"):
            want = want_mel
            np.testing.assert_allclose(got["mel"], want["mel"], atol=1e-5, rtol=0)
        elif name.startswith("wav-path"):
            want = want_wav
            np.testing.assert_array_equal(got["wav"], want["wav"])
            np.testing.assert_array_equal(got["wav_scale"], want["wav_scale"])
        else:  # mp3 / flac: the JAX collate on the same compressed files
            fmt = name.split("-")[0]
            jc = JDS.CustomDataset([{**r, "audio_path": r["audio_path"].replace(".wav", f".{fmt}")}
                                    for r in rows], durations=[r["duration"] for r in rows],
                                   mel_cfg=jmel_cfg)
            want = JDS.collate_wav_batch(jc.wav_batch(batch), None, "byte", jmel_cfg)
            np.testing.assert_array_equal(got["wav"], want["wav"])
        np.testing.assert_array_equal(got["lens"], want["lens"])
        np.testing.assert_array_equal(got["text_ids"], want["text_ids"])
        checked += 1
    assert checked >= 2


def test_input_pipeline_runs_to_its_end_on_the_cpu(tmp_path):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = TBIP.main(["4", str(tmp_path / "wavs")])
    lines = buf.getvalue().splitlines()
    assert lines[0].startswith("dataset: 4 files")
    assert {"wav-path", "mel-path"} <= set(out["host_frames_per_s"])
    assert all(v > 0 for v in out["host_frames_per_s"].values())
    assert lines[-1].startswith("card consumption: not measured")


# --------------------------------------------------------- step breakdown


def test_kernel_table_reads_a_cpu_profiler_trace(tmp_path):
    from f5_tts_tpu_torch.utils.profiling import device_trace

    a = torch.randn(256, 256)
    with contextlib.redirect_stdout(io.StringIO()), device_trace(str(tmp_path)) as prof:
        for _ in range(3):
            a @ a
        for _ in range(5):
            a + 1.0
    total, rows = TBSB.kernel_table(str(tmp_path / "trace.json"), cat="cpu_op", top=5)
    by_name = {r["name"]: r for r in rows}
    assert by_name["aten::mm"]["count"] == 3 and by_name["aten::add"]["count"] == 5
    assert [r["ms"] for r in rows] == sorted((r["ms"] for r in rows), reverse=True)
    assert abs(sum(r["share"] for r in rows) - sum(r["ms"] for r in rows) / total) < 1e-9
    avg = {e.key: e for e in prof.key_averages()}
    assert abs(by_name["aten::mm"]["ms"] - avg["aten::mm"].cpu_time_total / 1e3) < 0.05


def test_kernel_table_sums_kernels_by_name(tmp_path):
    events = [{"ph": "X", "cat": "kernel", "name": n, "dur": d}
              for n, d in (("a", 10.0), ("b", 30.0), ("a", 15.0), ("c", 5.0))]
    events.append({"ph": "X", "cat": "cpu_op", "name": "aten::mm", "dur": 1000.0})
    (tmp_path / "t.json").write_text(json.dumps({"traceEvents": events}))
    total, rows = TBSB.kernel_table(str(tmp_path / "t.json"), top=2)
    assert total == pytest.approx(0.060)
    assert [(r["name"], r["count"]) for r in rows] == [("b", 1), ("a", 2)]
    assert rows[1]["ms"] == pytest.approx(0.025) and rows[0]["share"] == pytest.approx(0.5)


@pytest.mark.parametrize("mode", TBSB.MODES)
def test_every_breakdown_mode_refuses_the_cpu(mode):
    with pytest.raises(ValueError, match="times the card"):
        TBSB.main([mode, "--device", "cpu"])


# ------------------------------------------------------- shell pipelines

PIPELINES = ("run_serving.sh", "eval_infer_batch.sh")
PLACEHOLDERS = {"$CKPT": "ckpt.pt", "$VOC": "vocos.pt", "$REF": "ref.wav",
                "$REF_TEXT": "ref text", "$PORT": "8000", "$ARTIFACTS": "artifacts",
                "$DEVICE": "cuda", "$EXP": "F5TTS_v1_Base", "$seed": "0", "$testset":
                "seedtts_test_en", "$lang": "en", "$dir": "results/x"}


def _module_calls(path: str) -> list[tuple[str, list[str]]]:
    """Every ``"$PY" -m <module> flags...`` of a script, continuation lines
    joined, shell variables replaced by placeholders."""
    text = open(path).read().replace("\\\n", " ")
    calls = []
    for line in text.splitlines():
        m = re.search(r'"\$PY" -m (\S+)(.*)$', line)
        if not m:
            continue
        rest = m.group(2).replace('"${AOT_FLAG[@]}"', "").rstrip(" &")
        for var, val in sorted(PLACEHOLDERS.items(), key=lambda kv: -len(kv[0])):
            rest = rest.replace(var, val)
        calls.append((m.group(1), shlex.split(rest)))
    return calls


class _Parsed(Exception):
    pass


@pytest.mark.parametrize("name", PIPELINES)
def test_pipeline_parses_and_names_only_the_port(name, monkeypatch):
    import argparse

    path = os.path.join(SCRIPTS, name)
    subprocess.run(["bash", "-n", path], check=True)
    text = open(path).read()
    assert "f5_tts_tpu." not in text
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        consoles = tomllib.load(f)["project"]["scripts"]
    assert consoles and not [c for c in consoles if c in text]
    calls = _module_calls(path)
    assert calls
    parsed = []

    def parse_args(self, args=None, namespace=None):
        parsed.append(argparse.ArgumentParser.parse_known_args(self, args, namespace))
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse_args)
    for module, flags in calls:
        assert module.startswith("f5_tts_tpu_torch."), module
        mod = importlib.import_module(module if module != "f5_tts_tpu_torch.scripts.build_engine"
                                      else "f5_tts_tpu_torch.runtime.aot")
        with pytest.raises(_Parsed):
            mod.main(flags)
        ns, unknown = parsed[-1]
        assert unknown == [], (module, unknown)
    assert len(parsed) == len(calls)


def test_serving_pipeline_modules(monkeypatch):
    modules = {m for m, _ in _module_calls(os.path.join(SCRIPTS, "run_serving.sh"))}
    assert modules == {"f5_tts_tpu_torch.scripts.build_engine",
                       "f5_tts_tpu_torch.infer.http_server", "f5_tts_tpu_torch.runtime.benchmark"}
    text = open(os.path.join(SCRIPTS, "run_serving.sh")).read()
    assert "warmup_all" in text and "request_tts" in text
    modules = {m for m, _ in _module_calls(os.path.join(SCRIPTS, "eval_infer_batch.sh"))}
    assert modules == {"f5_tts_tpu_torch.eval.eval_infer_batch",
                       "f5_tts_tpu_torch.eval.eval_testset"}


# -------------------------------------------------------------- speak probe


@pytest.fixture(scope="module")
def jsp():
    return jax_script("train_speak_probe")


def test_speak_probe_corpus_matches_jax(jsp, tmp_path):
    rng_t, rng_j = np.random.default_rng(5), np.random.default_rng(5)
    np.testing.assert_array_equal(TSP.synth_utterance("abhgc", rng_t),
                                  jsp.synth_utterance("abhgc", rng_j))
    rows_t = TSP.make_dataset(str(tmp_path / "t"), 6, np.random.default_rng(0))
    rows_j = jsp.make_dataset(str(tmp_path / "j"), 6, np.random.default_rng(0))
    assert [(r["text"], r["duration"]) for r in rows_t] == \
        [(r["text"], r["duration"]) for r in rows_j]
    for rt, rj in zip(rows_t, rows_j):
        assert open(rt["audio_path"], "rb").read() == open(rj["audio_path"], "rb").read()
    # a second pass over the written files draws as the first (JAX's would not)
    again = TSP.make_dataset(str(tmp_path / "t"), 6, np.random.default_rng(0))
    assert [r["text"] for r in again] == [r["text"] for r in rows_t]
    mel_cfg = TSP.probe_config(64, 2, 2).mel
    freqs = TSP.bin_freqs(mel_cfg)
    fft = np.linspace(0, 12000, 1024 // 2 + 1)
    np.testing.assert_array_equal(freqs, fft[np.argmax(JM._fbank_for(JM.MelConfig()), axis=0)])
    gen = np.random.default_rng(1).standard_normal((200, 100)).astype(np.float32)
    assert TSP.decode_tones(gen, 7, freqs) == jsp.decode_tones(gen, 7, freqs)


@pytest.mark.parametrize("tiny", [True, False])
def test_speak_probe_held_out_set_is_bitwise_jax(jsp, tiny):
    n_eval = 2 if tiny else 24
    held = TSP.held_out(n_eval, tiny, TSP.probe_config(128, 4, 4).mel)
    # JAX's loop (its main)
    eval_rng = np.random.default_rng(4242)
    bucket = 512 if not tiny else 256
    jmel = JM.MelConfig()
    evals = []
    for _ in range(n_eval):
        ref_text = "".join(jsp.TONES[j] for j in eval_rng.integers(0, len(jsp.TONES), 4))
        n_gen = int(eval_rng.integers(6, 11)) if not tiny else 3
        gen_text = "".join(jsp.TONES[j] for j in eval_rng.integers(0, len(jsp.TONES), n_gen))
        ref_mel = JM.log_mel_np(jsp.synth_utterance(ref_text, eval_rng), jmel)[0]
        evals.append((ref_text, gen_text, ref_mel))
    cond = np.zeros((n_eval, bucket, 100), np.float32)
    tids = np.full((n_eval, bucket), -1, np.int32)
    durs = np.zeros((n_eval,), np.int32)
    rlens = np.zeros((n_eval,), np.int32)
    for i, (rt, gt, m) in enumerate(evals):
        cond[i, :len(m)] = m
        ids = np.frombuffer((rt + gt).encode(), np.uint8)
        tids[i, :len(ids)] = ids
        durs[i] = (len(rt) + len(gt)) * jsp.FRAMES_PER_CHAR
        rlens[i] = len(m)
    noise = np.asarray(np.random.default_rng(7).standard_normal((n_eval, bucket, 100)),
                       np.float32)
    assert held["bucket"] == bucket
    for key, want in (("cond", cond), ("tids", tids), ("durs", durs), ("rlens", rlens),
                      ("noise", noise)):
        assert held[key].dtype == want.dtype
        np.testing.assert_array_equal(held[key], want, err_msg=key)
    assert [(e["ref_text"], e["gen_text"]) for e in held["evals"]] == \
        [(rt, gt) for rt, gt, _ in evals]


def _jax_probe_config(dim, depth, heads):
    cfg = JAX_CONFIGS["F5TTS_v1_Base"]
    return dataclasses.replace(
        cfg, tokenizer="byte",
        arch=dataclasses.replace(
            cfg.arch, dim=dim, depth=depth, heads=heads, dim_head=dim // heads,
            text_dim=min(dim, 64), text_num_embeds=256, conv_layers=2,
            text_embedding_average_upsampling=True, checkpoint_activations=False))


@pytest.mark.parametrize("shape", [(128, 4, 4), (128, 4, 2), (64, 2, 2)])
def test_speak_probe_model_config_is_jax(shape):
    got, want = TSP.probe_config(*shape), _jax_probe_config(*shape)
    assert (got.name, got.tokenizer) == (want.name, want.tokenizer)
    ga, wa = dataclasses.asdict(got.arch), dataclasses.asdict(want.arch)
    assert set(ga) == set(wa) and ga == wa
    assert dataclasses.asdict(got.mel) == dataclasses.asdict(want.mel)


@pytest.fixture(scope="module")
def speak_tiny():
    cfg, jcfg = TSP.probe_config(64, 2, 2), _jax_probe_config(64, 2, 2)
    model, params = _carried(cfg.arch, jcfg.arch, seed=21)
    held = TSP.held_out(2, True, cfg.mel)
    return cfg, jcfg, model, params, held


def test_speak_probe_cer_sampler_matches_jax(speak_tiny, jsp):
    cfg, jcfg, model, params, held = speak_tiny
    got = TSP.sample_mel(TSP.cast_backbone(model, torch.float32), cfg.arch, held, 2, 2.0,
                         torch.float32)
    want = np.asarray(JC.sample(
        params, jcfg.arch, jnp.asarray(held["cond"]), jnp.asarray(held["tids"]),
        jnp.asarray(held["durs"]), jnp.asarray(held["noise"]), lens=jnp.asarray(held["rlens"]),
        opts=JC.SampleOptions(steps=2, cfg_strength=2.0), backend="sdpa"))
    np.testing.assert_allclose(got, want, atol=MEL_TOL, rtol=0)
    freqs = TSP.bin_freqs(cfg.mel)
    cer_t, acc_t, pairs_t = TSP.cer_of(got, held, freqs)
    pairs_j = [(e["gen_text"], jsp.decode_tones(want[i, e["ref_len"]:e["duration"]],
                                                len(e["gen_text"]), freqs))
               for i, e in enumerate(held["evals"])]
    assert pairs_t == pairs_j


def test_speak_probe_order_mse_matches_jax(speak_tiny):
    cfg, jcfg, model, params, held = speak_tiny
    got = TSP.order_mse(TSP.cast_backbone(model, torch.float32), cfg.arch, held, torch.float32)
    bucket, durs, rlens = held["bucket"], held["durs"], held["rlens"]

    def vel_at(ids, t):  # JAX's, from its main
        bb_mask = np.arange(bucket)[None, :] < durs[:, None]
        te = JD.text_embedding(params, jcfg.arch, jnp.asarray(ids), bucket,
                               lens=jnp.asarray(durs))
        step_cond = jnp.where((np.arange(bucket)[None, :] < rlens[:, None])[..., None],
                              jnp.asarray(held["cond"]), 0.0)
        return np.asarray(JD.forward(params, jcfg.arch, jnp.asarray(held["noise"]), step_cond, te,
                                     jnp.full((len(durs),), t, jnp.float32),
                                     mask=jnp.asarray(bb_mask), backend="sdpa"))

    want = float(np.mean((vel_at(held["tids"], 0.05)
                          - vel_at(TSP.shuffled_ids(held), 0.05)) ** 2))
    assert want > 0 and abs(got - want) <= 1e-5 * want


def test_speak_probe_tiny_end_to_end(tmp_path):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
        res = TSP.main(["--tiny", "--device", "cpu", "--fresh", "--ckpt-dir", str(tmp_path / "ck"),
                        "--out", str(tmp_path / "p.pt"), "--data-dir", str(tmp_path / "ds")])
    last = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert {"metric", "cer_curve", "final_cer", "engine_cer", "order_sensitivity_mse", "nfe",
            "cfg_strength", "arch"} <= set(last)
    assert last["metric"] == "speak_probe" and last["cer_curve"]
    assert 0.0 <= last["final_cer"] <= 1.0 and 0.0 <= last["engine_cer"] <= 1.0
    assert last["launches"]["train_updates"] == 4 and res["params"] == str(tmp_path / "p.pt")
    assert os.path.isfile(tmp_path / "p.pt")
    # --skip-train reads the file back
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
        again = TSP.main(["--tiny", "--device", "cpu", "--skip-train", str(tmp_path / "p.pt"),
                          "--data-dir", str(tmp_path / "ds")])
    assert again["cer_curve"][0]["update"] == -1
    assert again["order_sensitivity_mse"] == last["order_sensitivity_mse"]


# ------------------------------------------------------------- Picard probe


@pytest.fixture(scope="module")
def jpp():
    return jax_script("train_picard_probe")


def test_picard_probe_corpus_matches_jax(jpp, tmp_path):
    np.testing.assert_array_equal(TPP.synth_utterance("abjc", np.random.default_rng(2)),
                                  jpp.synth_utterance("abjc", np.random.default_rng(2)))
    rows_t = TPP.make_dataset(str(tmp_path / "t"), 4, np.random.default_rng(0))
    rows_j = jpp.make_dataset(str(tmp_path / "j"), 4, np.random.default_rng(0))
    assert [(r["text"], r["duration"]) for r in rows_t] == \
        [(r["text"], r["duration"]) for r in rows_j]
    for rt, rj in zip(rows_t, rows_j):
        assert open(rt["audio_path"], "rb").read() == open(rj["audio_path"], "rb").read()
    freqs = TSP.bin_freqs(TPP.probe_config(tiny=True).mel)
    rng = np.random.default_rng(4)
    for _ in range(20):
        seg = rng.standard_normal((25, 100)).astype(np.float32)
        assert TPP.dominant_tone(seg, freqs) == jpp.dominant_tone(seg, freqs)


def test_picard_probe_config_is_jax():
    cases = [dict(tiny=True), dict(), dict(dim=256), dict(dim=256, depth=4, heads=4),
             dict(avg_upsample=True)]
    for kw in cases:
        want = dataclasses.replace(JAX_CONFIGS["F5TTS_v1_Base"], tokenizer="byte")
        if kw.get("tiny"):
            want = dataclasses.replace(want, arch=dataclasses.replace(
                want.arch, dim=64, depth=2, heads=2, dim_head=32, text_dim=32, conv_layers=1))
        elif kw.get("dim"):
            heads = kw.get("heads") or max(2, kw["dim"] // 64)
            want = dataclasses.replace(want, arch=dataclasses.replace(
                want.arch, dim=kw["dim"], depth=kw.get("depth") or 8, heads=heads,
                dim_head=kw["dim"] // heads))
        if kw.get("avg_upsample"):
            want = dataclasses.replace(want, arch=dataclasses.replace(
                want.arch, text_embedding_average_upsampling=True))
        got = TPP.probe_config(**kw)
        assert dataclasses.asdict(got.arch) == dataclasses.asdict(want.arch), kw


def test_picard_probe_raw_sample_matches_jax_sweeps():
    cfg = TPP.probe_config(tiny=True)
    jcfg = dataclasses.replace(JAX_CONFIGS["F5TTS_v1_Base"], tokenizer="byte")
    jcfg = dataclasses.replace(jcfg, arch=dataclasses.replace(
        jcfg.arch, dim=64, depth=2, heads=2, dim_head=32, text_dim=32, conv_layers=1))
    model, params = _carried(cfg.arch, jcfg.arch, seed=31)
    backbone = model.transformer
    prompt = TPP.probe_prompt(cfg.mel)
    bucket = 1024
    inputs = TPP.sample_inputs(prompt, bucket, 100)
    noise = np.random.default_rng(7).standard_normal(inputs["cond"].shape).astype(np.float32)

    def jax_sample(tol):
        opts = JC.SampleOptions(steps=16, time_parallel_window=8 if tol is not None else 0,
                                picard_tol=tol if tol is not None else 1e-3)
        out, info = JC.sample(params, jcfg.arch, jnp.asarray(inputs["cond"]),
                              jnp.asarray(inputs["tids"]), jnp.asarray(inputs["duration"]),
                              jnp.asarray(noise), lens=jnp.asarray(inputs["lens"]), opts=opts,
                              backend="sdpa", return_info=True)
        return np.asarray(out), int(info["sweeps"])

    seen = []
    for tol in (None, 3e-2, 1e-2, 1e-3):
        got, info = TPP.raw_sample(backbone, cfg.arch, inputs, noise, 16, 8, tol, torch.float32)
        want, sweeps = jax_sample(tol)
        assert int(info["sweeps"]) == sweeps, (tol, info, sweeps)
        np.testing.assert_allclose(got, want, atol=MEL_TOL, rtol=0)
        seen.append(sweeps)
    assert seen[0] == 16 and all(s <= 16 for s in seen)


def test_picard_probe_tiny_end_to_end(tmp_path):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
        res = TPP.main(["--tiny", "--device", "cpu", "--epochs", "1", "--out",
                        str(tmp_path / "p.pt"), "--data-dir", str(tmp_path / "ds")])
    lines = [json.loads(x) for x in buf.getvalue().strip().splitlines()]
    summary = lines[-1]
    assert summary["metric"] == "picard_trained_probe" and summary["window"] == 8
    assert {"tone_accuracy", "tone_cer", "best_sweeps", "sequential_worst_case"} <= set(summary)
    assert [r["tol"] for r in lines[:-1]] == [3e-2, 1e-2, 1e-3]
    assert all(1 <= r["sweeps"] <= 16 for r in res["reports"])
    assert "rtf_sequential" in lines[-2] and "engine_mel_mae" in lines[-2]
    assert os.path.isfile(tmp_path / "p.pt")
