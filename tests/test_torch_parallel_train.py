"""Data-parallel and ZeRO-1 training in the port (``train/trainer.py``,
``train/step.py``, ``train/cli.py`` under a mesh), on two gloo ranks
(``tests/torch_parallel_worker.py``), against the port's one-process
``Trainer`` on the global batches and JAX's loss on a ``data = 2`` mesh.

The dataset's sampler batches hold 3 rows (``batch_size_type="sample"``),
so every global batch needs one ``valid = 0`` pad row to split over two
ranks, and its rows have ragged lengths.  Tolerances: the DP and ZeRO-1
parameters (and EMA) atol 1e-6 against the one-process run and against
each other (the gradient sum's order differs); a ZeRO-1 checkpoint resumed
at dp 1 equals, within the same 1e-6, the run that went on at dp 2; JAX's
loss rtol 1e-5 and its gradients atol 1e-4 relative to each tensor's scale
(the tolerances of ``tests/test_torch_train_step.py``'s loss parity).  JAX's
``Trainer`` draws its randomness from ``jax.random``, which the port does
not reproduce, so the JAX side is held at the loss with injected draws.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads per test worker)

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parallel_worker as W

from f5_tts_tpu.models import cfm as JC
from f5_tts_tpu.models.configs import DiTConfig as JDiTConfig
from f5_tts_tpu.parallel.mesh import make_mesh
from f5_tts_tpu.utils.ckpt import params_from_state
from f5_tts_tpu_torch.models.backbones import randomize_zero_init
from f5_tts_tpu_torch.models.cfm import CFM
from f5_tts_tpu_torch.models.configs import DiTConfig, ModelConfig
from f5_tts_tpu_torch.train import dataset as TD
from f5_tts_tpu_torch.train.step import OptimConfig
from f5_tts_tpu_torch.train.trainer import Trainer

ARCH = dict(dim=32, depth=2, heads=2, dim_head=16, ff_mult=2, mel_dim=100,
            text_num_embeds=256, text_dim=16, conv_layers=1, max_pos=512)
MODEL_CFG = ModelConfig(name="tiny", arch=DiTConfig(**ARCH), tokenizer="byte")
OPT = OptimConfig(num_warmup_updates=1, total_updates=20, learning_rate=1e-3)


def _rows(n, seed, lo=40, hi=160):
    rng = np.random.default_rng(seed)
    words = ["hello", "world", "ni3", "hao3", "speech", "voice", "clone"]
    return [{"mel_spec": rng.standard_normal((int(f), 100)).astype(np.float32),
             "text": " ".join(rng.choice(words, int(rng.integers(1, 6)))),
             "duration": int(f) * 256 / 24_000}
            for f in rng.integers(lo, hi, size=n)]


def _loss_case(rng):
    """A padded global batch of 4 rows (the last a valid = 0 duplicate) with
    injected draws."""
    b, n = 4, 64
    lens = np.array([64, 37, 50, 37], np.int32)
    text = rng.integers(0, 256, (b, 20)).astype(np.int32)
    text[1, 9:] = -1
    mel = rng.standard_normal((b, n, 100)).astype(np.float32)
    mel[3], text[3] = mel[1], text[1]
    span = np.zeros((b, n), bool)
    for i, (s, e) in enumerate([(5, 50), (3, 30), (0, 40), (3, 30)]):
        span[i, s:e] = True
    x0 = rng.standard_normal((b, n, 100)).astype(np.float32)
    return dict(mel=mel, text_ids=text, lens=lens, valid=np.array([1, 1, 1, 0], np.float32),
                inject=dict(x0=x0, time=np.array([0.2, 0.5, 0.8, 0.5], np.float32),
                            span_mask=span, drop_audio=False, drop_both=False))


@pytest.fixture(scope="module")
def train_case(tmp_path_factory):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        cfm = CFM(MODEL_CFG.arch)
    randomize_zero_init(cfm.transformer, torch.Generator().manual_seed(1))
    loss_case = _loss_case(np.random.default_rng(2))
    inp = dict(model_cfg=MODEL_CFG, opt=OPT, init=cfm.state_dict(), rows=_rows(10, 4),
               cli_rows=_rows(6, 10),
               loss_case={k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else
                              {kk: torch.from_numpy(vv) if isinstance(vv, np.ndarray) else vv
                               for kk, vv in v.items()})
                          for k, v in loss_case.items()})
    tmp = tmp_path_factory.mktemp("train")
    torch.save(inp, tmp / "in.pt")
    return inp, loss_case, tmp, W.spawn("train", 2, tmp)


def _one_process(inp, ckpt, epochs, resume=False):
    """The one-process run on the global batch."""
    tr = Trainer(MODEL_CFG, None, OPT, ckpt_dir=str(ckpt), batch_size_per_device=3,
                 batch_size_type="sample", save_per_updates=1000, last_per_updates=1000, seed=3,
                 device="cpu", log_every_updates=1)
    model = CFM(MODEL_CFG.arch)
    model.load_state_dict(inp["init"])
    ds = TD.CustomDataset(inp["rows"], preprocessed_mel=True)
    return tr, tr.train(model, ds, epochs=epochs, resume=resume)


def _close(a: dict, b, atol=1e-6):
    items = b.items() if isinstance(b, dict) else b.named_parameters()
    for k, v in items:
        np.testing.assert_allclose(a[k].numpy(), v.detach().numpy(), atol=atol, err_msg=k)


def test_data_parallel_trainer_equals_one_process(train_case, tmp_path):
    inp, _, _, outs = train_case
    tr, (model, ema, update) = _one_process(inp, tmp_path / "one", 2)
    batches = len(TD.SampleBatchSampler(TD.CustomDataset(inp["rows"], preprocessed_mel=True), 3))
    assert batches == 4 and update == 2 * batches
    for o in outs:
        assert o["dp"]["update"] == update and not o["dp"]["zero1"]
        _close(o["dp"]["params"], model)
        _close(o["dp"]["ema"], ema)
    # rank 0 alone logs: the global loss and every rank's valid frames
    one = [json.loads(x) for x in open(tr.log_file)]
    two = [json.loads(x) for x in outs[0]["dp"]["log"].splitlines()]
    assert [r["update"] for r in two] == [r["update"] for r in one]
    for a, b in zip(two, one):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=2e-5)
        assert a["valid_frames"] == b["valid_frames"]
    assert "log" not in outs[1]["dp"]


def test_zero1_equals_data_parallel_and_halves_the_moments(train_case):
    _, _, _, outs = train_case
    for o in outs:
        assert o["zero1"]["zero1"]
        _close(o["zero1"]["params"], o["dp"]["params"])
        _close(o["zero1"]["ema"], o["dp"]["ema"])
        share = o["zero1"]["state_bytes"] / o["dp"]["state_bytes"]
        assert 0.5 <= share < 0.55, share


def test_zero1_checkpoint_resumes_at_dp1(train_case, tmp_path):
    """The ZeRO-1 run cut after its first epoch writes its moments gathered;
    one process resumes it and its second epoch equals the uncut run's."""
    import shutil

    inp, _, tmp, outs = train_case
    ck = tmp_path / "resume"
    shutil.copytree(tmp / "zero1_cut", ck)
    saved = torch.load(ck / "model_last.pt", weights_only=True)
    full = torch.load(tmp / "zero1" / "model_last.pt", weights_only=True)
    for i, st in saved["optimizer_state_dict"]["state"].items():
        assert st["exp_avg"].shape == full["optimizer_state_dict"]["state"][i]["exp_avg"].shape
    _, (model, ema, update) = _one_process(inp, ck, 2, resume=True)
    assert update == outs[0]["zero1"]["update"]
    _close(outs[0]["zero1"]["params"], model)
    _close(outs[0]["zero1"]["ema"], ema)


def test_data_parallel_loss_matches_jax_on_a_data_mesh(train_case):
    """The ranks' loss shares and summed gradients over a padded batch equal
    JAX's ``cfm.loss`` on the global batch with the rows on a data = 2 mesh
    (its denominator: the selected elements of the whole batch)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    inp, case, _, outs = train_case
    jcfg = JDiTConfig(**ARCH)
    state = {k[len("transformer."):]: v.numpy() for k, v in inp["init"].items()
             if k.startswith("transformer.")}
    params = params_from_state(state, jcfg)
    mesh = make_mesh(data=2, model=1)
    rows = NamedSharding(mesh, P("data"))
    put = lambda a: jax.device_put(jnp.asarray(a), rows)  # noqa: E731
    inj = {k: (put(v) if isinstance(v, np.ndarray) else v) for k, v in case["inject"].items()}

    def loss(p):
        return JC.loss(p, jcfg, put(case["mel"]), put(case["text_ids"]), put(case["lens"]),
                       jax.random.PRNGKey(0), backend="sdpa", valid=put(case["valid"]),
                       inject=inj)

    with mesh:
        lj, gj = jax.jit(jax.value_and_grad(loss))(params)
    got = outs[0]["loss_case"]
    np.testing.assert_allclose(got["loss"], float(lj), rtol=1e-5)
    assert got["loss"] == outs[1]["loss_case"]["loss"]
    want = {k: v for k, v in _torch_named(gj, jcfg).items()}
    for k, g in got["grads"].items():
        name = k[len("transformer."):]
        if name not in want:
            continue
        w = want[name]
        scale = max(float(np.abs(w).max()), 1e-6)
        np.testing.assert_allclose(g.numpy() / scale, w / scale, atol=1e-4, err_msg=k)
    assert len(want) >= len(got["grads"]) - 2


def _torch_named(grads, jcfg) -> dict:
    """JAX gradients in the port's state_dict keys and layout."""
    from f5_tts_tpu_torch.utils.ckpt import state_from_jax_params

    np_tree = jax.tree.map(np.asarray, grads)
    return {k[len("transformer."):]: v.numpy() if torch.is_tensor(v) else np.asarray(v)
            for k, v in state_from_jax_params(np_tree, jcfg).items()}


def test_cli_trains_under_a_world_of_two_with_sequence_parallel_and_zero1(train_case):
    """``train.cli`` and ``bench_train`` as ``torchrun`` starts them (the
    group joined, ``WORLD_SIZE`` = 2)."""
    _, _, _, outs = train_case
    assert all(o["bench_train"]["world_size"] == 2 and o["bench_train"]["value"] > 0
               for o in outs)
    assert all(o["cli"]["exists"] for o in outs)
    log = [json.loads(x) for x in outs[0]["cli"]["log"].splitlines()]
    assert log and all(np.isfinite(r["loss"]) for r in log)


def test_sequence_parallel_refuses_unett_as_jax_cannot_run_it(train_case):
    """JAX hands UNetT an activation constraint its forward does not take (a
    TypeError at the first step); the port refuses when the trainer is built."""
    _, _, _, outs = train_case
    assert all("DiT only" in (o["sp_unett"] or "") for o in outs)
