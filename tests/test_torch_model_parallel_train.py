"""Training under parallelism over the model (``train/trainer.py``,
``parallel/layout.py``, ``train/cli.py``): one Trainer update on 8 gloo
ranks at data 2 x pipe 2 x model 2 and at pipe 2 x seq 2 x model 2 (the
dp x pp x sp x tp step at 8 ranks, data 1: 16 ranks would not fit the
tests' time), against the port's one-device Trainer on the same batch; its
checkpoint in the one-device layout, which loads into a one-device model
and holds each rank's shards bitwise; and the CLI under a world of 8 with
``--tensor_parallel 2 --pipeline_parallel 2 --pipeline_microbatches 2
--zero1``.

The same 8 ranks take the loss on injected draws at data 2 x pipe 2 x
model 2 and one AdamW and one ZeRO-1 Adafactor update from its gradients,
against JAX's loss, ``jax.grad`` and optimizer chains on its own mesh of
that shape (the loss rtol 2e-5, the gradients and AdamW's first moments
within 1e-4 of each tensor's largest magnitude, the gradient norm rtol
1e-4, Adafactor's parameters atol 1e-6, AdamW's within 2.5 lr, since its
first step moves each element by about lr sign(g)).  fp32.  The clip
threshold is below the gradient norm, so a wrong logical norm (a
replicated tensor counted tp or pp times) moves the update.  AdamW's first
step moves each element by about lr sign(g), so the parameters alone would
pass a wrong gradient: the gate reads the loss (rtol 2e-5), the gradient
norm (rtol 1e-4) and AdamW's first moment per tensor (atol 1e-6 of its
largest one-device value + rtol 1e-4; JAX ``tests/test_train.py:174``
holds the loss at rtol 2e-4), and the parameters within 2.5 lr.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads per test worker)

import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch_parallel_worker as W
from jax.sharding import NamedSharding, PartitionSpec as P

from f5_tts_tpu.models import cfm as JC
from f5_tts_tpu.parallel.mesh import dit_param_specs, shard_opt_state, shard_params
from f5_tts_tpu.parallel.pipeline import make_dit_block_scan, make_pp_mesh, pp_param_specs
from f5_tts_tpu.train import step as JS
from f5_tts_tpu.utils.ckpt import params_from_state
from f5_tts_tpu_torch.models.cfm import CFM
from f5_tts_tpu_torch.train.dataset import CustomDataset
from f5_tts_tpu_torch.train.step import OptimConfig
from f5_tts_tpu_torch.train.trainer import Trainer
from test_torch_pipeline import _named, _rows
from test_torch_tp import MODEL_CFG, _seeded, jax_cfg

LR = 1e-3
OPT = OptimConfig(num_warmup_updates=0, total_updates=10, learning_rate=LR, max_grad_norm=1e-2)
ADAFACTOR = OptimConfig(optimizer="adafactor", num_warmup_updates=0, total_updates=10,
                        learning_rate=1e-2, max_grad_norm=1e-2)


def _init():
    cfm = CFM(MODEL_CFG.arch)
    cfm.transformer.load_state_dict(_seeded(MODEL_CFG.arch, 7).state_dict())
    return cfm.state_dict()


def _loss_case(rng):
    """A global batch of 4 rows (the last a valid = 0 duplicate) with
    injected draws: 2 rows per data rank, 1 per microbatch."""
    b, n = 4, 64
    lens = np.array([64, 37, 50, 37], np.int32)
    text = rng.integers(0, 256, (b, 20)).astype(np.int32)
    text[1, 9:] = -1
    mel = rng.standard_normal((b, n, 100)).astype(np.float32)
    mel[3], text[3] = mel[1], text[1]
    span = np.zeros((b, n), bool)
    for i, (lo, hi) in enumerate([(5, 50), (3, 30), (0, 40), (3, 30)]):
        span[i, lo:hi] = True
    return dict(mel=mel, text_ids=text, lens=lens, valid=np.array([1, 1, 1, 0], np.float32),
                inject=dict(x0=rng.standard_normal((b, n, 100)).astype(np.float32),
                            time=np.array([0.2, 0.5, 0.8, 0.5], np.float32), span_mask=span,
                            drop_audio=False, drop_both=False))


def _to_torch(case):
    return {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else
                {kk: torch.from_numpy(vv) if isinstance(vv, np.ndarray) else vv
                 for kk, vv in v.items()}) for k, v in case.items()}


@pytest.fixture(scope="module")
def train_case(tmp_path_factory):
    case = _loss_case(np.random.default_rng(13))
    inp = dict(train_cfg=MODEL_CFG, init=_init(), rows=_rows(4, 11), opt=OPT,
               cli_rows=_rows(6, 12), adafactor=ADAFACTOR, loss_case=_to_torch(case),
               loss_case_np=case)
    tmp = tmp_path_factory.mktemp("mp_train")
    torch.save(inp, tmp / "in.pt")
    return inp, W.spawn("train", 8, tmp, timeout=400, module="torch_model_parallel_worker")


def _one_device(inp, ckpt_dir, epochs):
    tr = Trainer(MODEL_CFG, None, OPT, ckpt_dir=ckpt_dir, batch_size_per_device=4,
                 batch_size_type="sample", save_per_updates=1000, last_per_updates=1000, seed=3,
                 device="cpu", log_every_updates=1)
    model = CFM(MODEL_CFG.arch)
    model.load_state_dict(inp["init"])
    model, _, _ = tr.train(model, CustomDataset(inp["rows"], preprocessed_mel=True),
                           epochs=epochs, resume=False)
    log = json.loads(open(tr.log_file).read().splitlines()[-1])
    moments = [st["exp_avg"] for _, st in sorted(tr.optimizer.state_dict()["state"].items())]
    return {k: p.detach() for k, p in model.named_parameters()}, moments, log


@pytest.fixture(scope="module")
def one_device(train_case, tmp_path_factory):
    return _one_device(train_case[0], str(tmp_path_factory.mktemp("one")), 1)


def _check_update(r0, one):
    params, moments, log = one
    assert log["grad_norm"] > OPT.max_grad_norm  # the clip acts
    got = json.loads(r0["log"].splitlines()[-1])
    assert got["update"] == log["update"]
    np.testing.assert_allclose(got["loss"], log["loss"], rtol=2e-5)
    np.testing.assert_allclose(got["grad_norm"], log["grad_norm"], rtol=1e-4)
    ckpt = r0["ckpt"]
    full = ckpt["model_state_dict"]
    for k, w in params.items():
        np.testing.assert_allclose(full[k].numpy(), w.numpy(), atol=2.5 * LR, err_msg=k)
    state = ckpt["optimizer_state_dict"]["state"]
    assert sorted(state) == list(range(len(params)))
    for (k, _), m, i in zip(params.items(), moments, range(len(moments))):
        scale = m.abs().max().item()
        np.testing.assert_allclose(state[i]["exp_avg"].numpy(), m.numpy(),
                                   atol=1e-6 * max(scale, 1e-30), rtol=1e-4, err_msg=k)


_JAX: dict = {}


def _jax_update(inp):
    """JAX on its make_pp_mesh(data=2, pipe=2, model=2), the weights placed
    by ``pp_param_specs(dit_param_specs(...))`` and the rows on data: the
    loss on the injected draws through its pipeline at 2 microbatches and
    its gradients, then one step of its AdamW chain and one of its
    Adafactor chain under ZeRO-1 (``shard_opt_state``)."""
    if _JAX:
        return _JAX
    case, cfg = inp["loss_case_np"], jax_cfg("dit")
    state = {k[len("transformer."):]: v.numpy() for k, v in inp["init"].items()
             if k.startswith("transformer.")}
    params = params_from_state(state, cfg)
    mesh = make_pp_mesh(data=2, pipe=2, model=2)
    params = shard_params(params, mesh, pp_param_specs(dit_param_specs(params), cfg.depth, 2))
    rows = NamedSharding(mesh, P("data"))
    put = lambda a: jax.device_put(jnp.asarray(a), rows)  # noqa: E731
    inj = {k: (put(v) if isinstance(v, np.ndarray) else v) for k, v in case["inject"].items()}
    scan = make_dit_block_scan(cfg, mesh, 2, backend="sdpa")

    def loss(p):
        return JC.loss(p, cfg, put(case["mel"]), put(case["text_ids"]), put(case["lens"]),
                       jax.random.PRNGKey(0), backend="sdpa", valid=put(case["valid"]),
                       inject=inj, block_scan=scan)

    with jax.set_mesh(mesh):
        lj, gj = jax.jit(jax.value_and_grad(loss))(params)
        out = dict(loss=float(lj), grads=_named(gj, cfg), norm=float(optax.global_norm(gj)))
        for name, opt in (("adamw", OPT), ("adafactor", ADAFACTOR)):
            tx = JS.make_optimizer(JS.OptimConfig(**dataclasses.asdict(opt)))
            st = tx.init(params)
            if name == "adafactor":
                st = shard_opt_state(st, mesh)
            upd, st = jax.jit(tx.update)(gj, st, params)
            out[name] = dict(params=_named(optax.apply_updates(params, upd), cfg))
            if name == "adamw":
                out[name]["moments"] = _named(optax.tree_utils.tree_get(st, "mu"), cfg)
    _JAX.update(out)
    return _JAX


def _scaled(got, want, atol, err_msg):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got) / scale, want / scale, atol=atol, err_msg=err_msg)


def test_loss_and_first_update_match_jax(train_case):
    """data 2 x pipe 2 x model 2 on injected draws (``loss_case``): the
    loss, the logical gradients and their norm, and the first update of
    AdamW (its first moments) and of ZeRO-1 Adafactor, against JAX's on the
    same mesh (the clip acting in both)."""
    inp, outs = train_case
    want = _jax_update(inp)
    got = outs[0]["loss_case"]
    assert all(o["loss_case"]["loss"] == got["loss"] for o in outs)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=2e-5)
    np.testing.assert_allclose(got["norm"], want["norm"], rtol=1e-4)
    assert want["norm"] > max(OPT.max_grad_norm, ADAFACTOR.max_grad_norm)  # the clips act
    assert set(want["grads"]) == {k[len("transformer."):] for k in got["grads"]}
    for k, w in want["grads"].items():
        _scaled(got["grads"]["transformer." + k], w, 1e-4, k)
    for o in outs:
        ada, adam = o["loss_case"]["adafactor"], o["loss_case"]["adamw"]
        for k, w in want["adamw"]["moments"].items():
            _scaled(adam["moments"]["transformer." + k], w, 1e-4, k)
        for k, w in want["adamw"]["params"].items():
            np.testing.assert_allclose(adam["params"]["transformer." + k].numpy(), w,
                                       atol=2.5 * LR, err_msg=k)
        for k, w in want["adafactor"]["params"].items():
            np.testing.assert_allclose(ada["params"]["transformer." + k].numpy(), w, atol=1e-6,
                                       err_msg=k)


@pytest.mark.parametrize("name", ["dp_pp_tp", "pp_sp_tp"])
def test_trainer_update_matches_one_device(train_case, one_device, name):
    _check_update(train_case[1][0][name], one_device)


def test_resume_under_another_mesh_matches_one_device(train_case, tmp_path_factory):
    """dp_pp_tp's one-device-layout checkpoint (model, EMA, AdamW's moments)
    resumed at pipe 2 x seq 2 x model 2 for the second epoch's update,
    against two updates on one device."""
    inp, outs = train_case
    assert all(o["resume"]["update"] == 2 for o in outs)
    _check_update(outs[0]["resume"], _one_device(inp, str(tmp_path_factory.mktemp("two")), 2))


@pytest.mark.parametrize("name", ["dp_pp_tp", "pp_sp_tp"])
def test_checkpoint_loads_into_one_device_model(train_case, name):
    """The gathered ``model_last.pt`` loads into a one-device ``CFM``
    (strict), its EMA too, and every rank's shards are its slices, bitwise."""
    _, outs = train_case
    ckpt = outs[0][name]["ckpt"]
    model = CFM(MODEL_CFG.arch)
    model.load_state_dict(ckpt["model_state_dict"])
    model.load_state_dict({k[len("ema_model."):]: v for k, v in
                           ckpt["ema_model_state_dict"].items() if k.startswith("ema_model.")})
    n_params = len(list(model.parameters()))
    for o in outs:
        r = o[name]
        assert r["shards_bitwise"] and r["update"] == 1 and r["names"] == n_params
        per_stage = sum(1 for k, _ in model.named_parameters() if ".transformer_blocks." in k) // 2
        assert r["live"] == n_params - per_stage  # the other stage's blocks are placeholders
        for k, shape in r["tp_shapes"].items():
            full = dict(model.named_parameters())[k].shape
            assert math.prod(shape) * 2 == math.prod(full), k


def test_pipeline_refuses_unett_as_jax_cannot_run_it(train_case):
    """JAX's Trainer hands its block scan to UNetT's forward, which takes
    none (a TypeError at the first step); the port refuses when built."""
    _, outs = train_case
    assert all("DiT only" in o["pp_unett"] for o in outs)


def test_cli_builds_the_mesh_and_trainer(train_case):
    """``--tensor_parallel 2 --pipeline_parallel 2`` under a world of 8:
    data = 8 / 4 (JAX ``tests/test_cli.py:228``)."""
    _, outs = train_case
    for o in outs:
        c = o["cli"]
        assert c["mesh"] == (("data", "pipe", "model"), (2, 2, 2))
        assert c["tensor_parallel"] and c["pipeline_microbatches"] == 2 and c["zero1"]
        assert c["exists"]
    rec = json.loads(outs[0]["cli"]["log"].splitlines()[-1])
    assert np.isfinite(rec["loss"])
