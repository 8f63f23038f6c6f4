"""The rest of single-device training in the port, on the CPU: Adafactor
against ``optax.adafactor`` under the JAX package's chain, the in-graph mel
path (``collate_wav_batch``, ``CustomDataset.wav_batch``, the step's wav
branch), ``HFDataset``, asynchronous checkpoint writes and the loggers.

Tolerances: Adafactor's parameters after 5 updates within 2e-6 relative
(fp32; the factored statistics' means reduce in another order); the
collated arrays and ``HFDataset`` items equal to JAX's (bitwise for the
int16 wire format and the ids, 1e-4 on the host mel, as
test_torch_trainer.py holds ``CustomDataset``); the wav batch's loss
within 1e-4 relative of the mel batch's (the int16 requantization, ~3e-5
of full scale).
"""

import torch_threads  # noqa: F401  (first: caps torch's threads per test worker)

import dataclasses
import json
import os
import sys
import types

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from f5_tts_tpu.ops.mel import MelConfig as JMelConfig
from f5_tts_tpu.train import dataset as JD
from f5_tts_tpu.train import step as JS
from f5_tts_tpu_torch.audio.io import save_wav
from f5_tts_tpu_torch.models.cfm import CFM
from f5_tts_tpu_torch.models.configs import DiTConfig, ModelConfig
from f5_tts_tpu_torch.ops.mel import MelConfig
from f5_tts_tpu_torch.train import dataset as TD
from f5_tts_tpu_torch.train import step as TS
from f5_tts_tpu_torch.train.trainer import Trainer
from f5_tts_tpu_torch.utils import ckpt as TK

ARCH = DiTConfig(dim=32, depth=2, heads=2, dim_head=16, ff_mult=2, mel_dim=100,
                 text_num_embeds=256, text_dim=16, conv_layers=1, max_pos=512)
MODEL_CFG = ModelConfig(name="tiny", arch=ARCH, tokenizer="byte")
WORDS = ["hello", "world", "speech", "voice", "clone"]


def _model(seed=0):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return CFM(ARCH)


def _audio_rows(tmp_path, n, seed=0, sr=24_000):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        secs = float(rng.uniform(0.5, 1.6))
        wav = (0.2 * np.sin(np.arange(int(secs * sr)) * rng.uniform(0.01, 0.1))
               + 0.05 * rng.standard_normal(int(secs * sr))).astype(np.float32)
        path = str(tmp_path / f"a{i}.wav")
        save_wav(path, wav, sr)
        rows.append({"audio_path": path, "duration": secs,
                     "text": " ".join(rng.choice(WORDS, int(rng.integers(1, 4))))})
    return rows


# ----------------------------------------------------------------- Adafactor

def test_adafactor_matches_optax_with_clipping_and_accumulation():
    """5 updates at k = 2 with the global-norm clip active, a factored
    [160, 130] and an unfactored [6, 5] parameter, against the JAX chain."""
    cfg = JS.OptimConfig(optimizer="adafactor", learning_rate=1e-2, num_warmup_updates=2,
                         total_updates=8, max_grad_norm=0.5, weight_decay=0.01,
                         grad_accumulation_steps=2)
    rng = np.random.default_rng(0)
    p0 = {"a": rng.standard_normal((160, 130)).astype(np.float32) * 0.1,
          "b": rng.standard_normal((6, 5)).astype(np.float32)}
    assert TS.Adafactor.factored_dims((160, 130)) == (1, 0)
    assert TS.Adafactor.factored_dims((6, 5)) is None
    tx = JS.make_optimizer(cfg)
    pj = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(pj)
    pt = [torch.nn.Parameter(torch.from_numpy(p0[k].copy())) for k in ("a", "b")]
    opt = TS.make_optimizer(pt, TS.OptimConfig(**dataclasses.asdict(cfg)))
    clipped = 0
    for _ in range(5 * cfg.grad_accumulation_steps):
        g = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p0.items()}
        clipped += float(optax.global_norm(g)) > cfg.max_grad_norm
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, pj)
        pj = optax.apply_updates(pj, upd)
        opt.step([torch.from_numpy(g[k]) for k in ("a", "b")])
    assert clipped > 0
    for k, p in zip(("a", "b"), pt):
        want = np.asarray(pj[k])
        assert not np.allclose(want, p0[k])
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=2e-6, atol=1e-8)


def test_adafactor_resumes_mid_accumulation_exactly(tmp_path):
    """Weights and optimizer state through a checkpoint file, saved between
    the two micro-steps of an update, continue as the run that never
    stopped, bitwise."""
    cfg = TS.OptimConfig(optimizer="adafactor", learning_rate=1e-2, num_warmup_updates=1,
                         total_updates=10, grad_accumulation_steps=2)
    rng = np.random.default_rng(1)
    shapes = ((130, 140), (7,))
    grads = [[torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in shapes]
             for _ in range(7)]
    init = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in shapes]

    def fresh():
        model = torch.nn.ParameterList([torch.nn.Parameter(t.clone()) for t in init])
        return model, TS.make_optimizer(list(model), cfg)

    model, opt = fresh()
    for g in grads:  # the optimizer accumulates into the first micro-step's tensors
        opt.step([t.clone() for t in g])
    want = [p.detach().clone() for p in model]

    model, opt = fresh()
    for g in grads[:3]:  # stop after micro-step 3: half of update 2 accumulated
        opt.step([t.clone() for t in g])
    path = str(tmp_path / "model_last.pt")
    TK.write_checkpoint(path, TK.train_checkpoint(
        model, model, opt.inner.state_dict(), opt.scheduler.state_dict(), 3, 1,
        extra={"grad_accumulation": opt.accumulation_state()}))
    ck = torch.load(path, weights_only=True)
    model, opt = fresh()
    model.load_state_dict(ck["model_state_dict"])
    opt.inner.load_state_dict(ck["optimizer_state_dict"])
    opt.scheduler.load_state_dict(ck["scheduler_state_dict"])
    opt.load_accumulation_state(ck["grad_accumulation"])
    for g in grads[3:]:
        opt.step([t.clone() for t in g])
    assert all(torch.equal(p.detach(), w) for p, w in zip(model, want))
    # factored second moments: a row and a column statistic for the matrix
    assert opt.inner.state_bytes() == 4 * (130 + 140 + 7)


# -------------------------------------------------------------- in-graph mel

@pytest.mark.parametrize("tokenizer", ["byte", "char"])
def test_collate_wav_batch_matches_jax(tokenizer):
    from f5_tts_tpu_torch.text.tokenizer import get_tokenizer

    rng = np.random.default_rng(2)
    items = [{"wav": (rng.standard_normal(n) * s).astype(np.float32), "text": t}
             for n, s, t in ((24_000, 0.1, "hello there"), (9_000, 1.7, "voice"),
                             (200, 0.3, "a"), (31_337, 0.5, "speech clone"))]
    vocab = None if tokenizer == "byte" else get_tokenizer(None, tokenizer)[0]
    got = TD.collate_wav_batch(items, vocab, tokenizer, MelConfig())
    want = JD.collate_wav_batch(items, vocab, tokenizer, JMelConfig())
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    pinned = TD.collate_wav_batch(items, vocab, tokenizer, MelConfig(), mel_len=512, text_len=80)
    jpinned = JD.collate_wav_batch(items, vocab, tokenizer, JMelConfig(), mel_len=512,
                                   text_len=80)
    assert all(np.array_equal(pinned[k], jpinned[k]) for k in pinned)


def test_wav_batch_loss_equals_the_mel_batch_loss(tmp_path):
    rows = _audio_rows(tmp_path, 3, seed=3)
    ds = TD.CustomDataset(rows)
    mel_cfg = MelConfig()
    mel_batch = TD.collate_batch([ds[i] for i in range(3)], None, "byte")
    wav_batch = TD.collate_wav_batch(ds.wav_batch(range(3)), None, "byte", mel_cfg)
    assert np.array_equal(wav_batch["lens"], mel_batch["lens"])
    assert np.array_equal(wav_batch["text_ids"], mel_batch["text_ids"])
    mel_t = {k: torch.from_numpy(v) for k, v in mel_batch.items()}
    wav_t = {k: torch.from_numpy(v) for k, v in wav_batch.items()}
    got = TS.batch_mel(wav_t, mel_cfg)
    assert got.shape == mel_t["mel"].shape
    valid = torch.arange(got.shape[1])[None] < mel_t["lens"][:, None]
    assert (got - mel_t["mel"]).abs()[valid].max() < 5e-3  # log-mel, near the 1e-5 floor
    model = _model()
    b, n, d = got.shape
    g = torch.Generator().manual_seed(4)
    inj = {"x0": torch.randn(b, n, d, generator=g), "time": torch.rand(b, generator=g),
           "drop_audio": False, "drop_both": False,
           "span_mask": torch.rand(b, n, generator=g) > 0.3}
    losses = [model(m, mel_t["text_ids"], mel_t["lens"], inject=inj).item()
              for m in (mel_t["mel"], got)]
    assert abs(losses[1] - losses[0]) <= 1e-4 * abs(losses[0])
    with pytest.raises(ValueError, match="raw-audio"):
        TD.CustomDataset([{"mel_spec": np.zeros((5, 100)), "text": "x"}],
                         preprocessed_mel=True).wav_batch([0])


def test_trainer_mel_in_graph_follows_the_host_mel_run(tmp_path):
    """Two updates from wav batches (Adafactor, remat "flash") against the
    same run on host mels: the same batches and draws, so the first loss
    agrees within the requantization's reach."""
    rows = _audio_rows(tmp_path, 6, seed=5)
    arch = dataclasses.replace(ARCH, checkpoint_activations=True, remat_policy="flash")
    cfg = dataclasses.replace(MODEL_CFG, arch=arch)
    opt = TS.OptimConfig(optimizer="adafactor", num_warmup_updates=1, total_updates=10,
                         learning_rate=1e-3)
    logs = []
    for in_graph in (False, True):
        ck = tmp_path / f"ck{int(in_graph)}"
        tr = Trainer(cfg, None, opt, ckpt_dir=str(ck), batch_size_per_device=500, max_samples=4,
                     save_per_updates=1000, last_per_updates=1000, seed=3, device="cpu",
                     log_every_updates=1, mel_in_graph=in_graph)
        tr.train(_model(), TD.CustomDataset(rows), epochs=1, resume=False)
        logs.append([json.loads(x) for x in open(ck / "train_log.jsonl")])
    host, graph = logs
    assert len(host) == len(graph) >= 2
    assert [r["valid_frames"] for r in host] == [r["valid_frames"] for r in graph]
    assert [r["frames"] for r in host] == [r["frames"] for r in graph]
    assert abs(graph[0]["loss"] - host[0]["loss"]) <= 1e-4 * abs(host[0]["loss"])
    ckpt = torch.load(tmp_path / "ck1" / "model_last.pt", weights_only=True)
    assert set(ckpt["optimizer_state_dict"]["state"][0]) <= {"step", "v", "v_row", "v_col"}


def test_hf_dataset_items_match_jax():
    rng = np.random.default_rng(6)
    rows = [{"audio": {"array": rng.standard_normal(16_000).astype(np.float32) * 0.1,
                       "sampling_rate": 16_000}, "text": "hello"},
            {"audio": {"array": rng.standard_normal((12_000, 2)) * 0.1, "sampling_rate": 24_000},
             "transcript": "stereo row"},
            {"audio": {"array": list(rng.standard_normal(8_000) * 0.1),
                       "sampling_rate": 22_050}, "text": ""}]
    got, want = TD.HFDataset(rows), JD.HFDataset(rows)
    assert len(got) == len(want) == 3
    for i in range(3):
        assert got.get_frame_len(i) == want.get_frame_len(i)
        a, b = got[i], want[i]
        assert a["text"] == b["text"]
        assert a["mel"].shape == b["mel"].shape
        np.testing.assert_allclose(a["mel"], b["mel"], atol=1e-4)
    sampler = TD.DynamicBatchSampler(got, 200, random_seed=1)
    assert sorted(i for b in sampler for i in b) == [0, 1, 2]


# ------------------------------------------------------ asynchronous saves

def _trained(tmp_path):
    model = _model(1)
    opt = TS.make_optimizer(list(model.parameters()), TS.OptimConfig(num_warmup_updates=1))
    ema = _model(2)
    g = torch.Generator().manual_seed(0)
    opt.step([torch.randn(p.shape, generator=g) for p in model.parameters()])
    return model, ema, opt


def _equal(a, b):
    if torch.is_tensor(a):
        return torch.is_tensor(b) and a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


def test_async_save_writes_the_synchronous_file(tmp_path):
    model, ema, opt = _trained(tmp_path)
    sync, asyn = str(tmp_path / "sync.pt"), str(tmp_path / "async.pt")
    TK.save_train_checkpoint(sync, model, ema, opt.inner.state_dict(), opt.scheduler.state_dict(),
                             4, 2)
    w = TK.CheckpointWriter()
    after = []
    w.save(asyn, TK.train_checkpoint(model, ema, opt.inner.state_dict(),
                                     opt.scheduler.state_dict(), 4, 2), after=lambda: after.append(1))
    with torch.no_grad():  # the snapshot was taken: later in-place updates do not reach the file
        for p in model.parameters():
            p.add_(1.0)
    w.wait()
    assert after == [1]
    a, b = torch.load(sync, weights_only=True), torch.load(asyn, weights_only=True)
    assert _equal(a, b)
    assert not [f for f in os.listdir(tmp_path) if ".tmp" in f]


def test_a_writer_killed_mid_write_leaves_the_previous_file(tmp_path, monkeypatch):
    model, ema, opt = _trained(tmp_path)
    path = str(tmp_path / "model_last.pt")
    w = TK.CheckpointWriter()
    obj = TK.train_checkpoint(model, ema, opt.inner.state_dict(), opt.scheduler.state_dict(), 1, 1)
    w.save(path, obj, block=True)
    before = torch.load(path, weights_only=True)
    real_save = torch.save

    def dies_mid_write(o, f):
        real_save(o, f)
        with open(f, "r+b") as fh:  # half a file, then the process "dies"
            fh.truncate(os.path.getsize(f) // 2)
        raise KeyboardInterrupt("killed mid-write")

    monkeypatch.setattr(torch, "save", dies_mid_write)
    w.save(path, TK.train_checkpoint(model, ema, opt.inner.state_dict(),
                                     opt.scheduler.state_dict(), 2, 2))
    with pytest.raises(KeyboardInterrupt):
        w.wait()
    monkeypatch.setattr(torch, "save", real_save)
    assert _equal(torch.load(path, weights_only=True), before)
    tr = Trainer(MODEL_CFG, None, ckpt_dir=str(tmp_path), device="cpu")
    assert tr._numbered() == []  # the half-written temporary name is never a checkpoint
    assert tr.load_checkpoint()["step"] == 1


# ------------------------------------------------------------------ loggers

def _rows(n, seed=0):
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        frames = int(rng.integers(40, 120))
        rows.append({"mel_spec": rng.standard_normal((frames, 100)).astype(np.float32),
                     "text": " ".join(rng.choice(WORDS, 2)), "duration": frames * 256 / 24_000})
    return rows


def _train_logged(ckpt_dir, logger):
    tr = Trainer(MODEL_CFG, None, TS.OptimConfig(num_warmup_updates=1, total_updates=5),
                 ckpt_dir=str(ckpt_dir), batch_size_per_device=300, max_samples=3,
                 save_per_updates=1000, last_per_updates=1000, seed=1, device="cpu",
                 log_every_updates=1, logger=logger)
    tr.train(_model(), TD.CustomDataset(_rows(6, seed=7), preprocessed_mel=True), epochs=1,
             resume=False)
    return tr, [json.loads(x) for x in open(ckpt_dir / "train_log.jsonl")]


def test_tensorboard_events_hold_the_jsonl_log(tmp_path):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    tr, log = _train_logged(tmp_path / "ck", "tensorboard")
    assert tr.tb_writer_cls is not None and tr.tb_writer is None and len(log) >= 2
    acc = EventAccumulator(str(tmp_path / "ck" / "runs"))
    acc.Reload()
    loss = acc.Scalars("loss")
    assert [e.step for e in loss] == [r["update"] for r in log]
    np.testing.assert_allclose([e.value for e in loss], [r["loss"] for r in log], rtol=1e-6)
    assert {"grad_norm", "step_time_s", "valid_frames"} <= set(acc.Tags()["scalars"])


def test_wandb_gets_every_record_and_a_missing_logger_stays_off(tmp_path, monkeypatch):
    seen = []
    fake = types.ModuleType("wandb")
    fake.run = object()
    fake.log = lambda rec, step=None: seen.append((dict(rec), step))
    monkeypatch.setitem(sys.modules, "wandb", fake)
    tr, log = _train_logged(tmp_path / "ck", "wandb")
    assert tr.wandb is fake
    assert seen == [(r, r["update"]) for r in log]
    monkeypatch.setitem(sys.modules, "wandb", None)  # not installed: import fails
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    for logger in ("wandb", "tensorboard"):
        off = Trainer(MODEL_CFG, None, ckpt_dir=str(tmp_path / logger), device="cpu",
                      logger=logger)
        assert off.wandb is None and off.tb_writer_cls is None
    with pytest.raises(ValueError, match="logger"):
        Trainer(MODEL_CFG, None, ckpt_dir=str(tmp_path / "x"), device="cpu", logger="mlflow")
