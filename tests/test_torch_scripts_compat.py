"""The port's measurement scripts and its import alias on the CPU:
``count_params_gflops`` prints JAX's lines; ``profile_request`` and
``picard_ab`` run at a tiny size; ``parity_vs_released`` holds a seeded
``.safetensors`` to the repo's torch oracle, exits 0 and imports no JAX;
the reference import paths under ``f5_tts_tpu_torch.compat`` resolve to
the port's objects, as ``tests/test_compat_alias.py`` holds ``f5_tts/`` to
the JAX package's."""

import torch_threads  # noqa: F401  (first: caps torch's threads per test worker)

import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_count_params_gflops_prints_jax_lines(monkeypatch):
    """JAX's script with its ``init`` under ``jax.eval_shape`` (shapes only:
    its parameter count reads ``.size``; nothing is drawn or compiled)."""
    import jax

    from f5_tts_tpu.models import dit, unett
    from f5_tts_tpu_torch.scripts import count_params_gflops as T

    for mod in (dit, unett):
        orig = mod.init
        monkeypatch.setattr(mod, "init", lambda k, a, o=orig: jax.eval_shape(lambda kk: o(kk, a), k))
    spec = importlib.util.spec_from_file_location(
        "jax_count_params_gflops", os.path.join(REPO, "scripts", "count_params_gflops.py"))
    J = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(J)
    out = {}
    for tag, fn in (("jax", J.main), ("port", T.main)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            fn()
        out[tag] = buf.getvalue().splitlines()
    assert out["port"] == out["jax"] and len(out["port"]) == 4
    assert out["port"][0].startswith("F5TTS_v1_Base: 337.1 M params, 1043.2 GFLOPs")


def test_profile_request_phases_on_the_cpu(tmp_path):
    from f5_tts_tpu_torch.scripts import profile_request

    rep = profile_request.main(["--device", "cpu", "--model", "F5TTS_Tiny", "--nfe", "2",
                                "--buckets", "256", "--batch", "2", "--reps", "2",
                                "--trace-dir", str(tmp_path / "trace")])
    row = rep["n256"]
    for k in ("assemble_ms", "upload_ms", "compute_ms", "fetch_ms", "total_ms"):
        assert row[k] > 0, (k, row)
    assert row["total_ms"] >= row["compute_ms"]
    assert row["fetch_bytes"] == 2 * 255 * 256 * 2  # int16 [2, (n - 1) * hop] (Vocos)
    assert row["device_ms"] is None  # no CUDA activity on the CPU
    assert os.path.isfile(tmp_path / "trace" / "trace.json")


def test_picard_ab_on_the_cpu():
    from f5_tts_tpu_torch.scripts import picard_ab
    from tests.test_torch_picard import SEQ_ATOL

    rep = picard_ab.main(["--device", "cpu", "--model", "F5TTS_Tiny", "--nfe", "4",
                          "--window", "2", "--tol", "0", "--iters", "1"])
    assert rep["sweeps"] == 4 and rep["evals_per_step"] == 2.0  # tol 0: one step per sweep
    assert rep["mel_mae"] < SEQ_ATOL
    assert rep["wall_ms_sequential"] > 0 and rep["wall_ms_picard"] > 0
    rep = picard_ab.main(["--device", "cpu", "--model", "F5TTS_Tiny", "--nfe", "4",
                          "--window", "4", "--tol", "1e9", "--iters", "1"])
    assert rep["sweeps"] == 1  # every window entry accepted at once


def test_parity_vs_released_on_a_seeded_safetensors(tmp_path):
    from f5_tts_tpu_torch.infer.api import _seeded
    from f5_tts_tpu_torch.models.backbones import randomize_zero_init
    from f5_tts_tpu_torch.models.cfm import CFM
    from f5_tts_tpu_torch.models.configs import MODEL_CONFIGS, with_vocab_size
    from f5_tts_tpu_torch.text.tokenizer import get_tokenizer
    from f5_tts_tpu_torch.utils import ckpt as CK

    _, vocab_size = get_tokenizer(None, "pinyin")
    cfg = with_vocab_size(MODEL_CONFIGS["F5TTS_Tiny"], vocab_size)
    model = _seeded(lambda: CFM(cfg.arch), 0)
    randomize_zero_init(model.transformer, torch.Generator().manual_seed(0))
    ckpt = str(tmp_path / "seeded.safetensors")
    CK.export_safetensors(model.state_dict(), ckpt)
    code = ("import json, sys\n"
            "from f5_tts_tpu_torch.scripts import parity_vs_released as P\n"
            f"rc = P.main(['--ckpt_file', {ckpt!r}, '--model', 'F5TTS_Tiny', '--device', 'cpu', "
            "'--seq_len', '64', '--text_len', '16'])\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'f5_tts_tpu.'))]\n"
            "print(json.dumps({'rc': rc, 'bad': bad}))\n")
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONSTARTUP", "PYTHONPATH")}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert json.loads(r.stdout.strip().splitlines()[-1]) == {"rc": 0, "bad": []}
    assert "PARITY OK" in r.stdout
    mae = [float(line.split("MAE: ")[1].split()[0]) for line in r.stdout.splitlines()
           if "MAE: " in line]
    assert len(mae) == 2 and max(mae) < 1e-5  # fp32 on the CPU


def test_compat_reference_import_paths_resolve_to_the_port():
    from f5_tts_tpu_torch.compat.api import F5TTS
    from f5_tts_tpu_torch.compat.infer.utils_infer import (
        chunk_text,
        infer_process,
        nfe_step,
        preprocess_ref_audio_text,
    )
    from f5_tts_tpu_torch.compat.model.dataset import CustomDataset, DynamicBatchSampler, load_dataset
    from f5_tts_tpu_torch.compat.model.utils import (
        convert_char_to_pinyin,
        get_tokenizer,
        seed_everything,
    )
    from f5_tts_tpu_torch.infer import api, pipeline
    from f5_tts_tpu_torch.text import chunk, pinyin, tokenizer
    from f5_tts_tpu_torch.train import dataset
    from f5_tts_tpu_torch.utils import seed
    from f5_tts_tpu_torch.audio import preprocess

    assert F5TTS is api.F5TTS and infer_process is pipeline.infer_process
    assert chunk_text is chunk.chunk_text and preprocess_ref_audio_text is \
        preprocess.preprocess_ref_audio_text
    assert (CustomDataset, DynamicBatchSampler, load_dataset) == \
        (dataset.CustomDataset, dataset.DynamicBatchSampler, dataset.load_dataset)
    assert convert_char_to_pinyin is pinyin.convert_char_to_pinyin
    assert get_tokenizer is tokenizer.get_tokenizer and seed_everything is seed.seed_everything
    assert nfe_step == 32
    assert chunk_text("a. b.", max_chars=100) == ["a. b."]
    assert get_tokenizer(None, "pinyin")[1] == 2545
    assert isinstance(convert_char_to_pinyin(["hi there"])[0], list)


def test_compat_entry_points_resolve_to_the_port():
    from f5_tts_tpu_torch.compat.eval.utils_eval import get_inference_prompt, run_wer
    from f5_tts_tpu_torch.compat.infer.infer_cli import main as infer_main
    from f5_tts_tpu_torch.compat.model import CFM, DiT, MMDiT, Trainer, UNetT
    from f5_tts_tpu_torch.compat.model.utils import get_epss_timesteps_schedule, word_error_rate
    from f5_tts_tpu_torch.compat.socket_server import TTSStreamingProcessor, start_server
    from f5_tts_tpu_torch.compat.train.finetune_cli import main as ft_main
    from f5_tts_tpu_torch.compat.train.train import main as train_main
    from f5_tts_tpu_torch.eval import metrics, testsets
    from f5_tts_tpu_torch.infer import cli, socket_server
    from f5_tts_tpu_torch.models import cfm, dit, mmdit, unett
    from f5_tts_tpu_torch.train import cli as train_cli
    from f5_tts_tpu_torch.train import finetune_cli, trainer

    assert infer_main is cli.main and train_main is train_cli.main and ft_main is finetune_cli.main
    assert start_server is socket_server.start_server
    assert TTSStreamingProcessor is socket_server.TTSStreamingProcessor
    assert (CFM, DiT, MMDiT, UNetT, Trainer) == (cfm.CFM, dit.DiT, mmdit.MMDiT, unett.UNetT,
                                                 trainer.Trainer)
    assert get_inference_prompt is testsets.prepare_eval_prompts and run_wer is metrics.run_wer
    assert word_error_rate is metrics.word_error_rate
    np.testing.assert_array_equal(get_epss_timesteps_schedule(32), cfm.timestep_schedule(32))
