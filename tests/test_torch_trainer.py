"""The port's training data path, Trainer loop and CLI config handling
(train/dataset.py, train/trainer.py, train/cli.py, models/configs.py), on
the CPU (``device="cpu"``), against the JAX package where it has the same
function.

Sampler batches and collated arrays must equal JAX's exactly; a resumed
run must equal an uninterrupted one exactly (same CPU arithmetic, same
per-micro-step draws).
"""

import torch_threads  # noqa: F401  (first: caps torch's threads per test worker)

import dataclasses
import json
import os
import signal

import numpy as np
import pytest
import torch

from f5_tts_tpu.ops.mel import MelConfig as JMelConfig
from f5_tts_tpu.train import cli as JCLI
from f5_tts_tpu.train import dataset as JD
from f5_tts_tpu_torch.audio.io import save_wav
from f5_tts_tpu_torch.models.cfm import CFM
from f5_tts_tpu_torch.models.configs import (MODEL_CONFIGS, DiTConfig, ModelConfig, from_yaml_dict,
                                             to_yaml_dict)
from f5_tts_tpu_torch.ops.mel import MelConfig
from f5_tts_tpu_torch.text.tokenizer import get_tokenizer
from f5_tts_tpu_torch.train import cli as TCLI
from f5_tts_tpu_torch.train import dataset as TD
from f5_tts_tpu_torch.train.step import OptimConfig
from f5_tts_tpu_torch.train.trainer import Trainer
from f5_tts_tpu_torch.utils import ckpt as TK

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(REPO, "configs", "F5TTS_v1_Base.yaml")
ARCH = DiTConfig(dim=32, depth=2, heads=2, dim_head=16, ff_mult=2, mel_dim=100,
                 text_num_embeds=256, text_dim=16, conv_layers=1, max_pos=512)
MODEL_CFG = ModelConfig(name="tiny", arch=ARCH, tokenizer="byte")


def _rows(n, seed=0, lo=40, hi=160):
    rng = np.random.default_rng(seed)
    words = ["hello", "world", "ni3", "hao3", "speech", "voice", "clone"]
    rows = []
    for _ in range(n):
        frames = int(rng.integers(lo, hi))
        rows.append({"mel_spec": rng.standard_normal((frames, 100)).astype(np.float32),
                     "text": " ".join(rng.choice(words, int(rng.integers(1, 6)))),
                     "duration": frames * 256 / 24_000})
    return rows


def _datasets(rows):
    return (TD.CustomDataset(rows, preprocessed_mel=True),
            JD.CustomDataset(rows, preprocessed_mel=True))


@pytest.mark.parametrize("kind", ["frame", "sample"])
def test_samplers_match_jax(kind):
    tds, jds = _datasets(_rows(40, seed=1))
    if kind == "frame":
        t = TD.DynamicBatchSampler(tds, 500, max_samples=5, random_seed=7)
        j = JD.DynamicBatchSampler(jds, 500, max_samples=5, random_seed=7)
    else:
        t = TD.SampleBatchSampler(tds, 6, random_seed=7)
        j = JD.SampleBatchSampler(jds, 6, random_seed=7)
    assert len(t) == len(j) > 2
    for epoch in (0, 1):
        t.set_epoch(epoch)
        j.set_epoch(epoch)
        assert [list(b) for b in t] == [list(b) for b in j]


@pytest.mark.parametrize("tokenizer", ["pinyin", "char", "byte"])
def test_collate_batch_matches_jax(tokenizer):
    tds, jds = _datasets(_rows(5, seed=2))
    vocab = None if tokenizer == "byte" else get_tokenizer(None, tokenizer)[0]
    got = TD.collate_batch([tds[i] for i in range(5)], vocab, tokenizer)
    want = JD.collate_batch([jds[i] for i in range(5)], vocab, tokenizer)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_raw_audio_rows_and_duration_filter_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    rows = []
    for i, secs in enumerate((0.1, 0.9, 1.3)):  # the first is filtered out (< 0.3 s)
        path = str(tmp_path / f"a{i}.wav")
        save_wav(path, (0.1 * rng.standard_normal(int(secs * 16_000))).astype(np.float32), 16_000)
        rows.append({"audio_path": path, "text": "hi", "duration": secs})
    tds = TD.CustomDataset(rows, mel_cfg=MelConfig())
    jds = JD.CustomDataset(rows, mel_cfg=JMelConfig())
    for i in range(3):
        got, want = tds[i], jds[i]
        assert got["mel"].shape == want["mel"].shape
        np.testing.assert_allclose(got["mel"], want["mel"], atol=1e-4)
    assert tds[0]["mel"].shape == tds[1]["mel"].shape  # row 0 probed to row 1


def _trainer(ckpt_dir, **kw):
    opt = kw.pop("opt", OptimConfig(num_warmup_updates=1, total_updates=20, learning_rate=1e-3))
    base = dict(batch_size_per_device=600, max_samples=4, save_per_updates=1000,
                last_per_updates=1000, seed=3, device="cpu", log_every_updates=1)
    base.update(kw)
    return Trainer(MODEL_CFG, None, opt, ckpt_dir=str(ckpt_dir), **base)


def _model(seed=0):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return CFM(ARCH)


def test_trainer_loop_log_and_rotation(tmp_path):
    ds = TD.CustomDataset(_rows(16, seed=4), preprocessed_mel=True)
    tr = _trainer(tmp_path / "ck", save_per_updates=2, keep_last_n_checkpoints=1)
    n_batches = len(TD.DynamicBatchSampler(ds, 600, 4, 3))
    model, ema, update = tr.train(_model(), ds, epochs=1, resume=False)
    assert update == n_batches >= 4
    log = [json.loads(x) for x in open(tr.log_file)]
    assert [r["update"] for r in log] == list(range(1, update + 1))
    assert all(np.isfinite(r["loss"]) and r["grad_norm"] > 0 for r in log)
    last_save = update - update % 2
    assert sorted(os.listdir(tmp_path / "ck")) == sorted(
        [f"model_{last_save}.pt", "model_last.pt", "train_log.jsonl"])
    ckpt = torch.load(tmp_path / "ck" / "model_last.pt", weights_only=True)
    assert ckpt["step"] == update
    assert {"model_state_dict", "ema_model_state_dict", "optimizer_state_dict",
            "scheduler_state_dict"} <= ckpt.keys()
    # the checkpoint reads back through load_torch_state: EMA and raw weights
    for use_ema, src in ((True, ema), (False, model)):
        fresh = TK.load_dit_state(CFM(ARCH), TK.load_torch_state(
            str(tmp_path / "ck" / "model_last.pt"), use_ema=use_ema))
        for k, v in fresh.state_dict().items():
            assert torch.equal(v, src.state_dict()[k]), k


def test_total_updates_derived_from_run_length(tmp_path):
    ds = TD.CustomDataset(_rows(12, seed=5), preprocessed_mel=True)
    tr = _trainer(tmp_path / "ck", opt=OptimConfig(num_warmup_updates=2),
                  grad_accumulation_steps=2)
    n_batches = len(TD.DynamicBatchSampler(ds, 600, 4, 3))
    _, _, update = tr.train(_model(), ds, epochs=3, resume=False)
    assert tr.opt_cfg.total_updates == max(-(-n_batches // 2) * 3, 3)
    assert tr.opt_cfg.grad_accumulation_steps == 2
    assert update == (n_batches * 3) // 2


def _weights(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("k,n_rows", [(1, 8), (2, 12)], ids=["k1", "k2_mid_accumulation"])
def test_resume_equals_an_uninterrupted_run(tmp_path, k, n_rows):
    """One epoch, a resume, a second epoch == two epochs uninterrupted,
    exactly.  With accumulation k = 2 and 3 batches an epoch, the first run
    stops between two updates and its checkpoint carries the gradient sum."""
    ds = TD.CustomDataset(_rows(n_rows, seed=6, lo=100, hi=140), preprocessed_mel=True)
    per_epoch = len(TD.DynamicBatchSampler(ds, 600, 4, 3))
    assert per_epoch == n_rows // 4
    opt = OptimConfig(num_warmup_updates=1, total_updates=4, learning_rate=1e-3,
                      ema_update_after_step=0, ema_update_every=1, grad_accumulation_steps=k)
    whole = _trainer(tmp_path / "a", opt=opt)
    m_ref, e_ref, u_ref = whole.train(_model(), ds, epochs=2, resume=False)
    first = _trainer(tmp_path / "b", opt=opt)
    _, _, u1 = first.train(_model(), ds, epochs=1, resume=False)
    ckpt = torch.load(tmp_path / "b" / "model_last.pt", weights_only=True)
    assert ckpt["step"] == per_epoch and ("grad_accumulation" in ckpt) == (per_epoch % k != 0)
    second = _trainer(tmp_path / "b", opt=opt)
    m2, e2, u2 = second.train(_model(seed=9), ds, epochs=2, resume=True)
    assert (u1, u2, u_ref) == (per_epoch // k, 2 * per_epoch // k, 2 * per_epoch // k)
    for ref, got in ((_weights(m_ref), _weights(m2)), (_weights(e_ref), _weights(e2))):
        for name in ref:
            assert torch.equal(ref[name], got[name]), name
    log = [json.loads(x) for x in open(second.log_file)]
    assert [r["micro_step"] for r in log] == list(range(k, 2 * per_epoch + 1, k))


def test_sigterm_saves_and_resumes(tmp_path):
    """SIGTERM finishes the step, writes model_last.pt and returns; resume
    continues from that micro-step to the end."""
    ds = TD.CustomDataset(_rows(16, seed=7), preprocessed_mel=True)
    n_batches = len(TD.DynamicBatchSampler(ds, 600, 4, 3))
    prior = signal.getsignal(signal.SIGTERM)
    tr = _trainer(tmp_path / "ck", save_per_updates=2,
                  log_samples_fn=lambda ema, update, model: os.kill(os.getpid(), signal.SIGTERM))
    _, _, u1 = tr.train(_model(), ds, epochs=3, resume=False)
    assert u1 == 2 and signal.getsignal(signal.SIGTERM) is prior
    assert torch.load(tmp_path / "ck" / "model_last.pt", weights_only=True)["step"] == 2
    tr2 = _trainer(tmp_path / "ck")
    _, _, u2 = tr2.train(_model(seed=1), ds, epochs=3, resume=True)
    assert u2 == 3 * n_batches


def test_log_samples_gets_ema_update_and_model(tmp_path):
    ds = TD.CustomDataset(_rows(8, seed=8), preprocessed_mel=True)
    seen = []
    tr = _trainer(tmp_path / "ck", save_per_updates=1,
                  log_samples_fn=lambda ema, update, model: seen.append((ema, update, model)))
    model, ema, update = tr.train(_model(), ds, epochs=1, resume=False)
    assert [s[1] for s in seen] == list(range(1, update + 1))
    assert all(s[0] is ema and s[2] is model for s in seen)


def test_producer_exception_reaches_the_step_loop(tmp_path):
    class Boom(TD.CustomDataset):
        def __getitem__(self, index):
            raise RuntimeError("boom: decode failed")

    ds = Boom(_rows(8, seed=9), preprocessed_mel=True)
    with pytest.raises(RuntimeError, match="boom"):
        _trainer(tmp_path / "ck").train(_model(), ds, epochs=1, resume=False)


@pytest.mark.parametrize("kw", [dict(mesh=object()), dict(zero1=True),
                                dict(sequence_parallel=True),
                                dict(tensor_parallel=True), dict(pipeline_microbatches=4),
                                dict(convpos_taps=True)],
                         ids=["mesh", "zero1", "sequence_parallel",
                              "tensor_parallel", "pipeline_microbatches", "convpos_taps"])
def test_unported_trainer_options_raise(tmp_path, kw):
    """Tensor parallel and the pipeline still raise, naming ROADMAP's next
    slice; a mesh must be a torch DeviceMesh; ZeRO-1, sequence parallel and
    the per-tap convpos are ported (ZeRO-1 and sequence parallel need a mesh
    axis and are off without one, as in JAX)."""
    if "tensor_parallel" in kw or "pipeline_microbatches" in kw:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            _trainer(tmp_path / "ck", **kw)
    elif "mesh" in kw:
        with pytest.raises(TypeError, match="DeviceMesh"):
            _trainer(tmp_path / "ck", **kw)
    else:
        tr = _trainer(tmp_path / "ck", **kw)
        assert not tr.zero1 and not tr.sequence_parallel
        assert tr.convpos_taps == ("convpos_taps" in kw)


def test_trainer_without_device_requires_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(MODEL_CFG, None, ckpt_dir=str(tmp_path / "ck"))


def test_yaml_parsing_and_overrides_match_jax():
    got, want = TCLI.parse_simple_yaml(YAML), JCLI.parse_simple_yaml(YAML)
    assert got == want
    over = ["optim.learning_rate=1e-4", "++model.arch.depth=18", "++ckpts.extra=[1,2.5,x]",
            "datasets.batch_size_type=sample"]
    assert TCLI.apply_overrides(got, over) == JCLI.apply_overrides(want, over)
    cfg = from_yaml_dict(TCLI.parse_simple_yaml(YAML)["model"])
    assert cfg.arch == MODEL_CONFIGS["F5TTS_v1_Base"].arch and cfg.tokenizer == "pinyin"
    assert from_yaml_dict(to_yaml_dict(cfg)) == cfg
    assert dataclasses.replace(cfg.arch, checkpoint_activations=True).checkpoint_activations


def test_activation_checkpointing_raises(tmp_path):
    """Activation checkpointing is ported; an unknown remat policy raises."""
    arch = dataclasses.replace(ARCH, checkpoint_activations=True, remat_policy="everything")
    with pytest.raises(ValueError, match="remat_policy"):
        Trainer(dataclasses.replace(MODEL_CFG, arch=arch), None, ckpt_dir=str(tmp_path),
                device="cpu")


def test_cli_trains_from_the_builtin_config(tmp_path, monkeypatch):
    """main() end to end on the CPU: a builtin config with dotted overrides,
    a ``--pretrain`` checkpoint, and the dataset loader swapped for
    in-memory rows (no dataset is in the repository)."""
    seen = {}

    def fake_load_dataset(name, tokenizer, mel_cfg=None, data_root="data"):
        seen.update(name=name, tokenizer=tokenizer, data_root=data_root)
        return TD.CustomDataset(_rows(6, seed=10), preprocessed_mel=True)

    monkeypatch.setattr(TD, "load_dataset", fake_load_dataset)
    vocab_size = get_tokenizer(None, "char")[1]
    tiny = dataclasses.replace(MODEL_CONFIGS["F5TTS_Tiny"].arch, text_num_embeds=vocab_size)
    pre = CFM(tiny)
    torch.save({"model_state_dict": pre.state_dict()}, tmp_path / "pre.pt")
    ck = tmp_path / "ck"
    TCLI.main(["--model", "F5TTS_Tiny", "--device", "cpu", "--epochs", "1",
               "--ckpt_dir", str(ck), "--pretrain", str(tmp_path / "pre.pt"),
               "--batch_size_per_gpu", "400", "--data_root", str(tmp_path),
               "++optim.num_warmup_updates=1", "++ckpts.last_per_updates=1"])
    assert seen == {"name": "Emilia_ZH_EN", "tokenizer": "char", "data_root": str(tmp_path)}
    log = [json.loads(x) for x in open(ck / "train_log.jsonl")]
    assert log and all(np.isfinite(r["loss"]) for r in log)
    ckpt = torch.load(ck / "model_last.pt", weights_only=True)
    ds = fake_load_dataset("", "")
    assert ckpt["step"] == len(TD.DynamicBatchSampler(ds, 400, 64, 666)) == 2
    assert [r["update"] for r in log] == [1]  # the default cadence: update 1, then every 10th
    # the run started from the --pretrain weights (two small AdamW steps away)
    for k, v in pre.state_dict().items():
        assert (ckpt["model_state_dict"][k] - v).abs().max() < 1e-3, k


def test_cli_rejects_parallel_layouts():
    with pytest.raises(SystemExit, match="not ported"):
        TCLI.main(["--tensor_parallel", "2"])
