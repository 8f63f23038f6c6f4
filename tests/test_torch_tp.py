"""The port's tensor parallelism (``parallel/tensor.py``, ``parallel/mesh.
shard_params``, ``BatchServer(tensor_parallel=True)``) and Picard over a
mesh (``cfm.sample(time_parallel_mesh=...)``,
``InferenceEngine.enable_time_parallel``), against the JAX package and the
port on one device.

One spawn of 4 gloo ranks (``tests/torch_model_parallel_worker.tp``)
serves the module; the JAX side runs here with the same weights, carried
into JAX by its own ``*_params_from_state``.  fp32 throughout.
Tolerances: the tensor-parallel forwards atol 5e-5 against JAX and against
the port unsharded (JAX ``tests/test_serve.py:127, 189``), bitwise equal
across the ranks of a mesh (the all-reduce leaves every rank the same
sum); the loss gradients at tp 2 atol 2e-5 + rtol 1e-4 against each
tensor's slice of the unsharded gradients (JAX
``tests/test_pipeline_parallel.py:95``'s) and within 1e-4 of the largest
magnitude of JAX's ``jax.grad`` through its tensor-parallel forward; the served wavs atol 3e-4 and
mels 5e-5 against ``mesh=None`` at batch 1, a data rank's rows per engine
call (JAX ``test_serve.py:231``), dense and W8A8; Picard over a mesh atol
3e-4 against the one-device Picard and against JAX's (JAX
``tests/test_time_parallel.py:204, 254, 282``).
"""

import torch_threads  # noqa: F401  (first: caps torch's threads per test worker)

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parallel_worker as W

from f5_tts_tpu.models import cfm as JC
from f5_tts_tpu.models import configs as JCFG
from f5_tts_tpu.models import dit as JD
from f5_tts_tpu.models import mmdit as JMM
from f5_tts_tpu.models import unett as JU
from f5_tts_tpu.utils.ckpt import params_from_state
from f5_tts_tpu_torch.infer.engine import EngineOptions, InferenceEngine
from f5_tts_tpu_torch.infer.serve import BatchServer
from f5_tts_tpu_torch.models import cfm as TC
from f5_tts_tpu_torch.models.backbones import build_backbone, get_backbone, randomize_zero_init
from f5_tts_tpu_torch.models.configs import DiTConfig, MMDiTConfig, ModelConfig, UNetTConfig
from f5_tts_tpu_torch.models.vocos import Vocos

N, NT = 24, 24
SMALL = dict(dim=32, heads=4, dim_head=8, ff_mult=2, mel_dim=100, text_num_embeds=256)
CFGS = {
    "dit": DiTConfig(depth=4, text_dim=16, conv_layers=1, max_pos=512, **SMALL),
    "dit_pe1": DiTConfig(depth=2, text_dim=16, conv_layers=1, max_pos=512, pe_attn_head=1,
                         **SMALL),
    "unett": UNetTConfig(depth=2, text_dim=16, max_pos=512, **SMALL),
    "mmdit": MMDiTConfig(depth=2, max_pos=512, text_max_pos=64, **SMALL),
}
JAX = {"dit": (JD, JCFG.DiTConfig), "dit_pe1": (JD, JCFG.DiTConfig),
       "unett": (JU, JCFG.UNetTConfig), "mmdit": (JMM, JCFG.MMDiTConfig)}
MODEL_CFG = ModelConfig(name="tiny", arch=CFGS["dit"], tokenizer="byte")


def jax_cfg(name):
    cls = JAX[name][1]
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in dataclasses.asdict(CFGS[name]).items() if k in names})


def _seeded(cfg, seed):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = build_backbone(cfg).eval()
    randomize_zero_init(model, torch.Generator().manual_seed(50 + seed))
    return model


def _args(rng):
    x = torch.from_numpy(rng.standard_normal((2, N, 100)).astype(np.float32))
    cond = torch.from_numpy(rng.standard_normal((2, N, 100)).astype(np.float32))
    text = torch.from_numpy(rng.integers(0, 256, (2, NT)).astype(np.int32))
    text[1, 9:] = -1
    time = torch.tensor([0.3, 0.7])
    mask = torch.arange(N)[None] < torch.tensor([[N], [17]])
    return x, cond, text, time, mask


def _kw(name):
    return {"attn_mask_enabled": True} if name == "mmdit" else {}


@pytest.fixture(scope="module")
def tp_case(tmp_path_factory):
    rng = np.random.default_rng(0)
    backbones = {}
    for i, (name, cfg) in enumerate(CFGS.items()):
        x, cond, text, time, mask = _args(rng)
        backbones[name] = dict(cfg=cfg, state=_seeded(cfg, i).state_dict(),
                               args=(x, cond, text, time), kw=dict(mask=mask, **_kw(name)))
    cfm = TC.CFM(MODEL_CFG.arch)
    cfm.transformer.load_state_dict(backbones["dit"]["state"])
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(1)
        voc = Vocos()
    reqs = [dict(ref_mel=rng.standard_normal((int(m), 100)).astype(np.float32),
                 text_ids=rng.integers(0, 256, int(t)).astype(np.int32), duration=int(d), seed=i)
            for i, (m, t, d) in enumerate(((20, 14, 60), (31, 20, 90)))]
    n = 48
    text = np.full((1, n), -1, np.int32)
    text[0, :11] = rng.integers(0, 256, 11)
    picard = dict(args=(torch.from_numpy(rng.standard_normal((1, n, 100)).astype(np.float32)),
                        torch.from_numpy(text), torch.tensor([40]),
                        torch.from_numpy(rng.standard_normal((1, n, 100)).astype(np.float32))),
                  lens=torch.tensor([12]))
    gen = dict(refs=[r["ref_mel"] for r in reqs], texts=[r["text_ids"] for r in reqs],
               durations=[60, 90], seeds=[0, 1])
    inp = dict(backbones=backbones, w=torch.from_numpy(rng.standard_normal((2, N, 100))
                                                       .astype(np.float32)),
               model_cfg=MODEL_CFG, cfm_state=cfm.state_dict(), vocos_state=voc.state_dict(),
               requests=reqs, picard=picard, gen=gen)
    tmp = tmp_path_factory.mktemp("tp")
    torch.save(inp, tmp / "in.pt")
    return inp, W.spawn("tp", 4, tmp, module="torch_model_parallel_worker")


def _port(case):
    model = build_backbone(case["cfg"])
    model.load_state_dict(case["state"])
    return model.eval()


def _port_forward(case, model, **kw):
    return get_backbone(case["cfg"]).forward_with_text(model, case["cfg"], *case["args"],
                                                       **case["kw"], **kw)


_WANT: dict = {}


def _wants(case, name):
    """(the port's unsharded forward, JAX's), once per backbone."""
    if name not in _WANT:
        with torch.no_grad():
            want = _port_forward(case, _port(case)).numpy()
        module, _ = JAX[name]
        state = {k: v.numpy() for k, v in case["state"].items()}
        jargs = [jnp.asarray(a.numpy()) for a in case["args"]]
        jkw = {k: (jnp.asarray(v.numpy()) if torch.is_tensor(v) else v)
               for k, v in case["kw"].items()}
        jwant = module.forward_with_text(params_from_state(state, jax_cfg(name)), jax_cfg(name),
                                         *jargs, backend="sdpa", **jkw)
        _WANT[name] = want, np.asarray(jwant)
    return _WANT[name]


@pytest.mark.parametrize("name", list(CFGS))
@pytest.mark.parametrize("tp", [2, 4])
def test_tp_forward_matches_jax_and_unsharded(tp_case, name, tp):
    inp, outs = tp_case
    want, jwant = _wants(inp["backbones"][name], name)
    got = [o[(name, tp)] for o in outs]
    for g in got[1:]:
        assert torch.equal(g, got[0])  # every rank holds the same output, bitwise
    np.testing.assert_allclose(got[0].numpy(), want, atol=5e-5)
    np.testing.assert_allclose(got[0].numpy(), jwant, atol=5e-5)


def _jax_tp_grads(case, w):
    """``jax.grad`` of sum(y * w) through JAX's DiT forward with the weights
    split over model 2 as ``dit_param_specs`` places them, on its
    make_mesh(data=2, model=2), in the port's keys and layout."""
    import jax

    from f5_tts_tpu.parallel.mesh import dit_param_specs, make_mesh, shard_params
    from f5_tts_tpu_torch.utils.ckpt import state_from_jax_params

    cfg = jax_cfg("dit")
    mesh = make_mesh(data=2, model=2)
    params = params_from_state({k: v.numpy() for k, v in case["state"].items()}, cfg)
    params = shard_params(params, mesh, dit_param_specs(params))
    args = [jnp.asarray(a.numpy()) for a in case["args"]]
    mask, wj = jnp.asarray(case["kw"]["mask"].numpy()), jnp.asarray(w.numpy())

    def loss(p):
        return jnp.sum(JD.forward_with_text(p, cfg, *args, mask=mask, backend="sdpa") * wj)

    with jax.set_mesh(mesh):
        g = jax.jit(jax.grad(loss))(params)
    return {k[len("transformer."):]: np.array(v) for k, v in
            state_from_jax_params(jax.tree.map(np.asarray, g), cfg).items()}


def test_tp_gradients_are_slices_of_the_unsharded(tp_case):
    """Against each tensor's slice of the port's unsharded gradients and of
    ``jax.grad`` through JAX's tensor-parallel forward."""
    from f5_tts_tpu_torch.parallel.mesh import backbone_param_specs

    inp, outs = tp_case
    case = inp["backbones"]["dit"]
    model = _port(case)
    y = _port_forward(case, model, backend="train_auto")
    names, params = zip(*model.named_parameters())
    want = dict(zip(names, torch.autograd.grad((y * inp["w"]).sum(), params)))
    jwant = _jax_tp_grads(case, inp["w"])
    assert set(jwant) == set(want)
    specs = backbone_param_specs(model)
    sharded = 0
    for rank, o in enumerate(outs):
        r = rank % 2  # make_mesh(data=2, model=2): the model coordinate
        assert set(o["grads"]) == set(want)
        for k, g in o["grads"].items():
            w, jw = want[k], torch.from_numpy(jwant[k])
            if hasattr(specs[k], "dim"):
                per = w.shape[specs[k].dim] // 2
                w, jw = (t.narrow(specs[k].dim, r * per, per) for t in (w, jw))
                sharded += 1
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-5, rtol=1e-4, err_msg=k)
            scale = max(jw.abs().max().item(), 1e-30)
            np.testing.assert_allclose(g.numpy() / scale, jw.numpy() / scale, atol=1e-4,
                                       err_msg=k)
    # 4 ranks x 4 blocks x 10: q, k, v and ff in (weight, bias), to_out and ff out (weight)
    assert sharded == 4 * 4 * 10


def _plain_serve(inp, quantize):
    cfm = TC.CFM(MODEL_CFG.arch)
    cfm.load_state_dict(inp["cfm_state"])
    voc = Vocos()
    voc.load_state_dict(inp["vocos_state"])
    eng = InferenceEngine(cfm, MODEL_CFG, vocoder=voc, buckets=(64, 128),
                          options=EngineOptions(nfe_step=2, quantize=quantize))
    from f5_tts_tpu_torch.infer.serve import Request

    srv = BatchServer(eng, batch_size=1)
    wavs, _ = srv.run([Request(**r) for r in inp["requests"]], fetch_mel=True)
    return wavs, [srv.mels[i] for i in range(len(wavs))]


@pytest.mark.parametrize("kind", ["dense", "w8a8"])
def test_batch_server_tensor_parallel_matches_mesh_none(tp_case, kind):
    inp, outs = tp_case
    assert outs[0]["tp_eager"]  # its calls all-reduce: eager, never captured
    for o in outs:
        plain, tp_ = o[(kind, "plain")], o[(kind, "tp")]
        for a, b in zip(tp_["wavs"], plain["wavs"]):
            np.testing.assert_allclose(a, b, atol=3e-4)
        for a, b in zip(tp_["mels"], plain["mels"]):  # a data rank's mels pad to the longest
            np.testing.assert_allclose(a[:len(b)], b, atol=5e-5)
            assert not a[len(b):].any()
    if kind == "dense":  # the rank's mesh=None is the parent's one-device server
        wavs, mels = _plain_serve(inp, False)
        for a, b in zip(outs[0][(kind, "plain")]["mels"], mels):
            np.testing.assert_array_equal(a, b)


def _picard(inp, tables, window=4):
    cfm = TC.CFM(MODEL_CFG.arch)
    cfm.load_state_dict(inp["cfm_state"])
    opts = TC.SampleOptions(steps=8, time_parallel_window=window, picard_tol=0.0,
                            precompute_adaln=tables)
    p = inp["picard"]
    return TC.sample(cfm.transformer.eval(), MODEL_CFG.arch, *p["args"], lens=p["lens"],
                     opts=opts)


_PICARD: dict = {}


def _picard_wants(inp, tables):
    """(the port's one-device Picard, JAX's), once per ``tables``."""
    if tables not in _PICARD:
        p = inp["picard"]
        state = {k[len("transformer."):]: v.numpy() for k, v in inp["cfm_state"].items()}
        jcfg = jax_cfg("dit")
        jwant = JC.sample(params_from_state(state, jcfg), jcfg,
                          *[jnp.asarray(a.numpy()) for a in p["args"]],
                          lens=jnp.asarray(p["lens"].numpy()), backend="sdpa",
                          opts=JC.SampleOptions(steps=8, time_parallel_window=4, picard_tol=0.0,
                                                precompute_adaln=tables))
        _PICARD[tables] = _picard(inp, tables).numpy(), np.asarray(jwant)
    return _PICARD[tables]


@pytest.mark.parametrize("tables", [False, True])
@pytest.mark.parametrize("dp", [2, 4])
def test_picard_over_a_mesh_matches_one_device_and_jax(tp_case, dp, tables):
    inp, outs = tp_case
    want, jwant = _picard_wants(inp, tables)
    for o in outs:
        got = o[("picard", dp, tables)].numpy()
        np.testing.assert_allclose(got, want, atol=3e-4)
        np.testing.assert_allclose(got, jwant, atol=3e-4)


def test_picard_refuses_rows_that_do_not_divide(tp_case):
    _, outs = tp_case
    assert all("must divide over the data axis (4)" in o["picard_refusal"] for o in outs)
    assert all("time_parallel_window" in o["no_window"] for o in outs)


@pytest.mark.parametrize("key", ["picard_engine", "picard_tp"])
def test_picard_engine_over_a_mesh_matches_plain_engine(tp_case, key):
    """Through ``enable_time_parallel`` at data 4, and at data 2 x model 2
    with the backbone tensor-parallel (JAX ``test_time_parallel.py:254,
    282``)."""
    inp, outs = tp_case
    cfm = TC.CFM(MODEL_CFG.arch)
    cfm.load_state_dict(inp["cfm_state"])
    voc = Vocos()
    voc.load_state_dict(inp["vocos_state"])
    eng = InferenceEngine(cfm, MODEL_CFG, vocoder=voc, buckets=(64, 128),
                          options=EngineOptions(nfe_step=4, time_parallel_window=4,
                                                picard_tol=0.0))
    g = inp["gen"]
    mels, wavs = eng.generate_batch(g["refs"], g["texts"], g["durations"], seeds=g["seeds"])[:2]
    for o in outs:
        got_mels, got_wavs = o[key]
        np.testing.assert_allclose(got_mels, mels, atol=3e-4)
        for a, b in zip(got_wavs, wavs):
            np.testing.assert_allclose(a, b, atol=3e-4)
