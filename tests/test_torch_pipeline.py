"""The port's GPipe pipeline (``parallel/pipeline.py``): forwards and
gradients against the port's plain loop over the blocks and against the
JAX package, with tensor parallelism, with sequence parallelism on the ring
(pp x sp), through the engine's block-scan hook; and ZeRO-1 with Adafactor
(``train/step.py``) against JAX's optimizer step and the one-device update.

One spawn of 4 gloo ranks (``tests/torch_model_parallel_worker.pipe``)
serves the module; the JAX side runs here on the weights the port seeded
(``params_from_state``).  fp32.  Tolerances: the pipeline's forwards atol
1e-5 + rtol 1e-5 against the plain loop (JAX
``tests/test_pipeline_parallel.py:75, 83``) and atol 5e-5 against JAX's
plain forward and JAX's own pipeline; gradients atol 2e-5 + rtol 1e-4
against the plain loop (JAX :95) and within 1e-4 of each tensor's largest
magnitude against ``jax.grad`` through JAX's pipeline on the same mesh
(pp, pp x tp, pp x sp on JAX's ring, JAX
``tests/test_ring_attention.py:279``); pp x sp atol 2e-5 + rtol 1e-4
against the plain loop; the engine's wavs atol 3e-4; Adafactor's
parameters after one update atol 1e-6 against JAX's chain (one device, and
ZeRO-1 on JAX's data 2 x model 2 mesh) and against the one-device Trainer.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads per test worker)

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch_parallel_worker as W

from f5_tts_tpu.models import configs as JCFG
from f5_tts_tpu.models import dit as JD
from f5_tts_tpu.parallel import sequence as JSP
from f5_tts_tpu.parallel.mesh import dit_param_specs as j_dit_specs
from f5_tts_tpu.parallel.mesh import make_mesh as j_make_mesh
from f5_tts_tpu.parallel.mesh import make_train_mesh as j_train_mesh
from f5_tts_tpu.parallel.mesh import shard_opt_state as j_shard_opt_state
from f5_tts_tpu.parallel.mesh import shard_params as j_shard_params
from f5_tts_tpu.parallel.pipeline import make_dit_block_scan as j_block_scan
from f5_tts_tpu.parallel.pipeline import make_pp_mesh as j_pp_mesh
from f5_tts_tpu.parallel.pipeline import pp_param_specs as j_pp_specs
from f5_tts_tpu.train import step as JS
from f5_tts_tpu.utils.ckpt import params_from_state
from f5_tts_tpu_torch.utils.ckpt import state_from_jax_params
from f5_tts_tpu_torch.infer.engine import EngineOptions, InferenceEngine
from f5_tts_tpu_torch.models import dit as TD
from f5_tts_tpu_torch.models.cfm import CFM
from f5_tts_tpu_torch.models.configs import DiTConfig, ModelConfig
from f5_tts_tpu_torch.models.vocos import Vocos
from f5_tts_tpu_torch.parallel.mesh import backbone_param_specs
from f5_tts_tpu_torch.parallel.pipeline import gpipe_block_scan, pp_param_specs
from f5_tts_tpu_torch.train.step import OptimConfig
from f5_tts_tpu_torch.train.trainer import Trainer
from test_torch_tp import CFGS, MODEL_CFG, _seeded, jax_cfg

CFG = CFGS["dit"]  # depth 4, heads 4
N = 24
# dim 128: the feed-forward and time-MLP weights have two axes >= 128, so
# Adafactor factors them (v_row, v_col); the rest keep a whole v
ADA_CFG = ModelConfig(name="tiny128", arch=DiTConfig(dim=128, depth=2, heads=4, dim_head=8,
                                                      ff_mult=2, text_num_embeds=256,
                                                      text_dim=16, conv_layers=1, max_pos=512),
                      tokenizer="byte")
ADAFACTOR = OptimConfig(optimizer="adafactor", num_warmup_updates=0, total_updates=10,
                        learning_rate=1e-2, max_grad_norm=1e-3)


def _rows(n, seed):
    rng = np.random.default_rng(seed)
    words = ["hello", "world", "speech", "voice", "clone"]
    return [{"mel_spec": rng.standard_normal((int(f), 100)).astype(np.float32),
             "text": " ".join(rng.choice(words, int(rng.integers(1, 6)))),
             "duration": int(f) * 256 / 24_000} for f in rng.integers(40, 160, size=n)]


def _ada_init():
    cfm = CFM(ADA_CFG.arch)
    cfm.transformer.load_state_dict(_seeded(ADA_CFG.arch, 3).state_dict())
    return cfm.state_dict()


def _ada_grads(init, seed):
    """Seeded one-device gradients for every parameter of ``init``."""
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy((rng.standard_normal(tuple(v.shape)) * 1e-2).astype(np.float32))
            for k, v in init.items() if k.startswith("transformer.")}


@pytest.fixture(scope="module")
def pipe_case(tmp_path_factory):
    rng = np.random.default_rng(1)
    model = _seeded(CFG, 0)
    text = torch.from_numpy(rng.integers(0, 256, (4, N)).astype(np.int32))
    text[1, 9:] = -1
    args = (torch.from_numpy(rng.standard_normal((4, N, 100)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((4, N, 100)).astype(np.float32)), text,
            torch.tensor([0.3, 0.7, 0.1, 0.9]))
    mask = torch.arange(N)[None] < torch.tensor([[N], [17], [20], [N]])
    cfm = CFM(MODEL_CFG.arch)
    cfm.transformer.load_state_dict(model.state_dict())
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(1)
        voc = Vocos()
    refs = [rng.standard_normal((int(m), 100)).astype(np.float32) for m in (20, 31)]
    gen = dict(refs=refs, texts=[rng.integers(0, 256, 14).astype(np.int32) for _ in refs],
               durations=[60, 50], seeds=[0, 1])
    inp = dict(dit=dict(cfg=CFG, state=model.state_dict(), args=args, kw=dict(mask=mask)),
               w=torch.from_numpy(rng.standard_normal((4, N, 100)).astype(np.float32)),
               model_cfg=MODEL_CFG, cfm_state=cfm.state_dict(), vocos_state=voc.state_dict(),
               gen=gen, train_cfg=ADA_CFG, init=_ada_init(), rows=_rows(4, 5),
               adafactor=ADAFACTOR)
    inp["ada_grads"] = _ada_grads(inp["init"], 6)
    tmp = tmp_path_factory.mktemp("pipe")
    torch.save(inp, tmp / "in.pt")
    return inp, W.spawn("pipe", 4, tmp, module="torch_model_parallel_worker")


def _plain(inp, backend="auto"):
    model = TD.DiT(CFG)
    model.load_state_dict(inp["dit"]["state"])
    return model, TD.forward_with_text(model, CFG, *inp["dit"]["args"], backend=backend,
                                       **inp["dit"]["kw"])


def _jax_args(inp):
    params = params_from_state({k: v.numpy() for k, v in inp["dit"]["state"].items()},
                               jax_cfg("dit"))
    args = [jnp.asarray(a.numpy()) for a in inp["dit"]["args"]]
    return params, args, jnp.asarray(inp["dit"]["kw"]["mask"].numpy())


def _named(tree, cfg) -> dict:
    """A JAX DiT tree (parameters or gradients) in the port's state-dict
    keys and layout, as numpy."""
    np_tree = jax.tree.map(np.asarray, tree)
    return {k[len("transformer."):]: np.asarray(v)
            for k, v in state_from_jax_params(np_tree, cfg).items()}


_JGRADS: dict = {}


def _jax_grads(inp, name):
    """JAX's gradients of sum(y * w) for the worker's case ``name``: "plain"
    (no mesh), "pp" (JAX's pipeline at (2, 2) on data 2 x pipe 2), "pp_tp"
    (pipe 2 x model 2, the weights split as ``dit_param_specs`` and
    ``pp_param_specs`` place them) and "pp_sp" (pipe 2 x seq 2, the ring
    inside each tick, JAX ``tests/test_ring_attention.py:279``)."""
    if name in _JGRADS:
        return _JGRADS[name]
    cfg = jax_cfg("dit")
    params, args, mask = _jax_args(inp)
    w = jnp.asarray(inp["w"].numpy())
    mesh = {"plain": None, "pp": j_pp_mesh(data=2, pipe=2, model=1),
            "pp_tp": j_pp_mesh(data=1, pipe=2, model=2),
            "pp_sp": j_train_mesh(data=1, pipe=2, seq=2, model=1)}[name]
    kw = {}
    if mesh is not None:
        kw["block_scan"] = j_block_scan(cfg, mesh, 2, backend="sdpa",
                                        ring_sequence="xla" if name == "pp_sp" else None)
    if name == "pp_sp":
        kw["activation_constraint"] = JSP.make_seq_constraint(mesh)
    if name == "pp_tp":
        params = j_shard_params(params, mesh, j_pp_specs(j_dit_specs(params), cfg.depth, 2))

    def loss(p):
        return jnp.sum(JD.forward_with_text(p, cfg, *args, mask=mask, backend="sdpa", **kw) * w)

    if mesh is None:
        g = jax.jit(jax.grad(loss))(params)
    else:
        with jax.set_mesh(mesh):
            g = jax.jit(jax.grad(loss))(params)
    _JGRADS[name] = _named(g, cfg)
    return _JGRADS[name]


def _close_scaled(got, want, atol, err_msg=""):
    """|got - want| within ``atol`` of want's largest magnitude."""
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got) / scale, want / scale, atol=atol, err_msg=err_msg)


_WANT: dict = {}


@pytest.mark.parametrize("pp,M", [(2, 2), (2, 4), (4, 4), (4, 2)])
def test_pipeline_forward_matches_plain_loop_and_jax(pipe_case, pp, M):
    inp, outs = pipe_case
    if not _WANT:  # the plain loop's forward and JAX's, once
        with torch.no_grad():
            _WANT["port"] = _plain(inp)[1]
        params, args, mask = _jax_args(inp)
        _WANT["jax"] = np.asarray(JD.forward_with_text(params, jax_cfg("dit"), *args,
                                                       mask=mask, backend="sdpa"))
    want, jwant = _WANT["port"], _WANT["jax"]
    for o in outs:
        got = o[("fwd", pp, M)]
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got.numpy(), jwant, atol=5e-5)
    assert sorted(o["stage"][pp] for o in outs) == sorted([s for s in range(pp)] * (4 // pp))


def test_pipeline_matches_jax_pipeline(pipe_case):
    """JAX's own GPipe schedule (its shard_map over 2 stages of the 8-device
    CPU mesh) against the port's at (pp, M) = (2, 2)."""
    inp, outs = pipe_case
    params, args, mask = _jax_args(inp)
    mesh = j_pp_mesh(data=1, pipe=2, model=1)
    with mesh:
        jwant = np.asarray(JD.forward_with_text(
            params, jax_cfg("dit"), *args, mask=mask, backend="sdpa",
            block_scan=j_block_scan(jax_cfg("dit"), mesh, 2, backend="sdpa")))
    np.testing.assert_allclose(outs[0][("fwd", 2, 2)].numpy(), jwant, atol=5e-5)


def test_one_stage_is_the_plain_loop(pipe_case):
    """pp = 1 (no pipe axis): the hook runs the blocks in order, bitwise the
    plain loop (JAX ``test_pipeline_parallel.py:165``)."""
    inp, _ = pipe_case
    model, want = _plain(inp)
    from f5_tts_tpu_torch.models import layers as L

    def block_fn(blk, h, te, mk, rope):
        return L.dit_block(blk, h, te, CFG.heads, mask=mk, rope_freqs=rope)

    def scan(blocks, h, t_emb, mask, rope):
        return gpipe_block_scan(block_fn, blocks, h, t_emb, mask, rope, mesh=None, n_micro=2)

    got = TD.forward_with_text(model, CFG, *inp["dit"]["args"], block_scan=scan,
                               **inp["dit"]["kw"])
    assert torch.equal(got, want)


def _check_grads(o, want, jwant, stages, tp_rank=None, atol=2e-5):
    """This rank's gradients: its stage's blocks and every non-block tensor
    (whole on every stage), tensor-parallel ones as slices; against the
    port's plain loop (``want``) and JAX's (``jwant``)."""
    owner = pp_param_specs(want, CFG.depth, 2)
    specs = backbone_param_specs(want) if tp_rank is not None else {}
    assert set(o["grads"]) == {k for k, s in owner.items() if s in (None, stages)}
    assert set(o["grads"]) <= set(jwant)
    for k, g in o["grads"].items():
        w, jw = want[k], torch.from_numpy(np.array(jwant[k]))
        if hasattr(specs.get(k), "dim"):
            per = w.shape[specs[k].dim] // 2
            w, jw = (t.narrow(specs[k].dim, tp_rank * per, per) for t in (w, jw))
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=atol, rtol=1e-4, err_msg=k)
        _close_scaled(g.numpy(), jw.numpy(), 1e-4, err_msg=k)


def _plain_grads(inp):
    model, y = _plain(inp, backend="train_auto")
    names, params = zip(*model.named_parameters())
    return y, dict(zip(names, torch.autograd.grad((y * inp["w"]).sum(), params)))


def test_plain_gradients_match_jax(pipe_case):
    """The port's plain loop, the reference of the cases below, against
    ``jax.grad`` of JAX's plain forward."""
    inp, _ = pipe_case
    _, want = _plain_grads(inp)
    jwant = _jax_grads(inp, "plain")
    assert set(want) == set(jwant)
    for k, g in want.items():
        _close_scaled(g.numpy(), jwant[k], 1e-4, err_msg=k)


@pytest.mark.parametrize("name", ["pp", "pp_tp"])
def test_pipeline_gradients_match_plain_loop(pipe_case, name):
    """Against the port's plain loop and ``jax.grad`` through JAX's own
    pipeline on the same mesh (JAX ``tests/test_pipeline_parallel.py:95``)."""
    inp, outs = pipe_case
    y, want = _plain_grads(inp)
    jwant = _jax_grads(inp, name)
    for rank, o in enumerate(outs):
        np.testing.assert_allclose(o[name]["y"].numpy(), y.detach().numpy(), atol=1e-5,
                                   rtol=1e-5)
        if name == "pp":  # make_pp_mesh(data=2, pipe=2): rank = 2 data + stage
            _check_grads(o[name], want, jwant, rank % 2)
        else:  # make_pp_mesh(data=1, pipe=2, model=2): rank = 2 stage + model
            _check_grads(o[name], want, jwant, rank // 2, tp_rank=rank % 2)


def test_pipeline_times_sequence_parallel_on_the_ring(pipe_case):
    """pp 2 x sp 2 (make_train_mesh(pipe=2, seq=2): rank = 2 stage + seq):
    the seq hook cuts the frames, each tick runs ring attention; against
    the plain loop and ``jax.grad`` through JAX's pp x sp on its ring."""
    inp, outs = pipe_case
    y, want = _plain_grads(inp)
    jwant = dict(_jax_grads(inp, "pp_sp"))
    # JAX's pp x sp doubles this one gradient (its own plain forward's is
    # half of it; ROADMAP C.4): there the port is held to JAX's plain one
    k = "text_embed.text_blocks.0.dwconv.weight"
    jplain = _jax_grads(inp, "plain")[k]
    _close_scaled(jwant[k], 2 * jplain, 1e-4, err_msg=k)
    jwant[k] = jplain
    for rank, o in enumerate(outs):
        np.testing.assert_allclose(o["pp_sp"]["y"].numpy(), y.detach().numpy(), atol=2e-5,
                                   rtol=1e-4)
        _check_grads(o["pp_sp"], want, jwant, rank // 2)


def test_engine_block_scan_hook_matches_plain_engine(pipe_case):
    inp, outs = pipe_case
    cfm = CFM(MODEL_CFG.arch)
    cfm.load_state_dict(inp["cfm_state"])
    voc = Vocos()
    voc.load_state_dict(inp["vocos_state"])
    eng = InferenceEngine(cfm, MODEL_CFG, vocoder=voc, buckets=(64, 128),
                          options=EngineOptions(nfe_step=2))
    g = inp["gen"]
    mels, wavs = eng.generate_batch(g["refs"], g["texts"], g["durations"], seeds=g["seeds"])[:2]
    for o in outs:
        assert o["engine_scan_eager"]
        got_mels, got_wavs = o["engine_scan"]
        np.testing.assert_allclose(got_mels, mels, atol=5e-5)
        for a, b in zip(got_wavs, wavs):
            np.testing.assert_allclose(a, b, atol=3e-4)


def _jcfg(arch):
    names = {f.name for f in dataclasses.fields(JCFG.DiTConfig)}
    return JCFG.DiTConfig(**{k: v for k, v in dataclasses.asdict(arch).items() if k in names})


def _backbone_np(state: dict) -> dict:
    return {k[len("transformer."):]: v.numpy() for k, v in state.items()
            if k.startswith("transformer.")}


def _jax_ada_step(inp, mesh, tp):
    """One step of JAX's optimizer chain (clip, ``optax.adafactor``) on
    ``inp["ada_grads"]``: on ``mesh`` with the state placed by
    ``shard_opt_state`` (ZeRO-1) and, with ``tp``, the weights split by
    ``dit_param_specs``; without a mesh on one device."""
    cfg = _jcfg(ADA_CFG.arch)
    params = params_from_state(_backbone_np(inp["init"]), cfg)
    grads = params_from_state(_backbone_np(inp["ada_grads"]), cfg)
    tx = JS.make_optimizer(JS.OptimConfig(**dataclasses.asdict(ADAFACTOR)))
    if mesh is None:
        upd, _ = jax.jit(tx.update)(grads, tx.init(params), params)
    else:
        if tp:
            params = j_shard_params(params, mesh, j_dit_specs(params))
        state = j_shard_opt_state(tx.init(params), mesh)
        with jax.set_mesh(mesh):
            upd, _ = jax.jit(tx.update)(grads, state, params)
    return _named(optax.apply_updates(params, upd), cfg)


@pytest.mark.parametrize("name", ["one", "ada_step", "ada_step_tp"])
def test_adafactor_step_matches_jax(pipe_case, name):
    """One Adafactor update (the clip acting) from the same gradients: the
    port on one device, and ZeRO-1 at data 2 (with ``ada_step_tp`` the
    weights also split over model 2), against JAX's chain on one device and
    on its make_mesh(data=2, model=2) with ``shard_opt_state``.  JAX stacks
    the blocks, so each block tensor's rms spans its stack."""
    from f5_tts_tpu_torch.train.step import make_optimizer
    from f5_tts_tpu_torch.utils.ckpt import stacked_leaf

    inp, outs = pipe_case
    if name == "one":
        model = CFM(ADA_CFG.arch)
        model.load_state_dict(inp["init"])
        names, params = zip(*model.named_parameters())
        opt = make_optimizer(list(params), ADAFACTOR,
                             stacks=[stacked_leaf(n, ADA_CFG.arch) for n in names])
        assert opt.step([inp["ada_grads"][n].clone() for n in names])
        got = [{n: p.detach() for n, p in zip(names, params)}]
        want = _jax_ada_step(inp, None, False)
    else:
        got = [o[name]["params"] for o in outs]
        assert all({"v_row", "v_col"} <= set(o[name]["sharded"]) for o in outs)
        want = _jax_ada_step(inp, j_make_mesh(data=2, model=2), name.endswith("_tp"))
    moved = 0
    for params in got:
        for k, w in want.items():
            np.testing.assert_allclose(params["transformer." + k].numpy(), w, atol=1e-6,
                                       err_msg=k)
            moved += int(not np.array_equal(w, inp["init"]["transformer." + k].numpy()))
    assert moved > 0


@pytest.fixture(scope="module")
def adafactor_one(pipe_case, tmp_path_factory):
    inp, _ = pipe_case
    tr = Trainer(ADA_CFG, None, ADAFACTOR, ckpt_dir=str(tmp_path_factory.mktemp("one")),
                 batch_size_per_device=4, batch_size_type="sample", save_per_updates=1000,
                 last_per_updates=1000, seed=3, device="cpu", log_every_updates=1)
    model = CFM(ADA_CFG.arch)
    model.load_state_dict(inp["init"])
    from f5_tts_tpu_torch.train.dataset import CustomDataset

    model, _, _ = tr.train(model, CustomDataset(inp["rows"], preprocessed_mel=True), epochs=1,
                           resume=False)
    log = json.loads(open(tr.log_file).read().splitlines()[-1])
    return {k: p.detach() for k, p in model.named_parameters()}, tr.optimizer.state_bytes(), log


@pytest.mark.parametrize("name", ["zero1_adafactor", "zero1_adafactor_tp"])
def test_zero1_adafactor_matches_unsharded_update(pipe_case, adafactor_one, name):
    """make_mesh(data=2, model=2): ZeRO-1 over data 2, Adafactor's
    statistics in rows; with ``tensor_parallel`` the weights also split over
    model (Adafactor gathers each slice)."""
    inp, outs = pipe_case
    want, one_bytes, log = adafactor_one
    assert log["grad_norm"] > ADAFACTOR.max_grad_norm  # the clip acts
    init = inp["init"]
    moved = 0
    for o in outs:
        r = o[name]
        assert {"v_row", "v_col"} <= set(r["sharded"])
        assert r["state_bytes"] < one_bytes
        for k, w in want.items():
            np.testing.assert_allclose(r["params"][k].numpy(), w.numpy(), atol=1e-6, err_msg=k)
            moved += int(not torch.equal(w, init[k]))
    assert moved > 0
    got = json.loads(outs[0][name]["log"].splitlines()[-1])
    np.testing.assert_allclose(got["loss"], log["loss"], rtol=1e-6)
    np.testing.assert_allclose(got["grad_norm"], log["grad_norm"], rtol=1e-5)
