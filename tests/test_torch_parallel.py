"""The port's parallelism over the data (``f5_tts_tpu_torch/parallel/``):
ring attention, sequence-parallel DiT and train step, mesh serving, the
chunked and callable attention backends, the per-tap ConvPositionEmbedding
and the sharding rules, against the JAX package and the port unsharded.

Multi-rank checks spawn 2 or 4 gloo processes (``tests/torch_parallel_worker.py``),
one spawn per module-scoped fixture serving several tests; the JAX side
runs here, on the 8-device CPU mesh of ``tests/conftest.py``.  Tolerances
(fp32): ring attention atol 2e-5 / rtol 1e-4 on valid query rows, its
gradients atol 5e-5 / rtol 1e-3 (JAX ``tests/test_ring_attention.py``);
the chunked and callable backends 2e-5; the sequence-parallel DiT forward
1e-5 (JAX ``tests/test_sequence_parallel.py``); the train step's loss rtol
2e-5, its summed gradients atol 1e-6 + rtol 1e-4 and the updated
parameters atol 1e-6 against the port unsharded; serving mel 2e-6 and wav
2e-4 at data 2, wav 3e-4 at seq 2 (JAX ``tests/test_serve.py``).
"""

import torch_threads  # noqa: F401  (first: caps torch's threads per test worker)

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parallel_worker as W
from torch.distributed.tensor import Replicate, Shard

from f5_tts_tpu.models import dit as JD
from f5_tts_tpu.ops.attention import chunked_attention as j_chunked
from f5_tts_tpu.ops.attention import sdpa as j_sdpa
from f5_tts_tpu.parallel import mesh as JM
from f5_tts_tpu.parallel import sequence as JS
from f5_tts_tpu.parallel.ring import make_ring_attention as j_ring
from f5_tts_tpu.utils.ckpt import params_from_state
from f5_tts_tpu_torch.models import dit as TD
from f5_tts_tpu_torch.models import layers as TL
from f5_tts_tpu_torch.models.backbones import randomize_zero_init
from f5_tts_tpu_torch.models.cfm import CFM
from f5_tts_tpu_torch.models.configs import MODEL_CONFIGS, DiTConfig
from f5_tts_tpu_torch.ops.attention import attention, chunked_attention, sdpa
from f5_tts_tpu_torch.parallel import mesh as TM
from f5_tts_tpu_torch.parallel.ring import ring_attention_in_process
from f5_tts_tpu_torch.train import cli as TCLI

N = 32  # frames of the ring cases: 8 per rank at sp 4


def _np(t):
    return t.detach().numpy()


# ------------------------------------------------------------------ ring


@pytest.fixture(scope="module")
def ring_case(tmp_path_factory):
    """Ring inputs (rows: a full row, one whose length 5 is below n / sp so
    its valid keys lie on rank 0 alone, and a fully padded one) and the four
    ranks' results."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((3, 2, N, 64)).astype(np.float32))
               for _ in range(3))
    inp = dict(q=q, k=k, v=v, lens=torch.tensor([N, 5, 0], dtype=torch.int32),
               w=torch.from_numpy(rng.standard_normal((3, 2, N, 64)).astype(np.float32)),
               wl=torch.from_numpy(rng.standard_normal((3, 2, N)).astype(np.float32)))
    tmp = tmp_path_factory.mktemp("ring")
    torch.save(inp, tmp / "in.pt")
    return inp, W.spawn("ring", 4, tmp)


def _assemble(outs, key, sp, field, i=None):
    """The full-frame tensor of one seq group's shards (ranks 0 .. sp-1)."""
    parts = sorted((o[key]["my"], o[key][field] if i is None else o[key][field][i])
                   for o in outs[:sp])
    return torch.cat([p for _, p in parts], dim=2)


def _mask(lens, masked):
    lens = lens if masked else torch.full_like(lens, N)
    return torch.arange(N)[None] < lens[:, None]


_JAX_RING: dict = {}


def _jax_ring_grads(inp, sp, masked):
    """JAX's ring (the xla block) on a seq mesh: o and the o-loss's grads
    (computed once per case)."""
    if (sp, masked) not in _JAX_RING:
        _JAX_RING[sp, masked] = _jax_ring(inp, sp, masked)
    return _JAX_RING[sp, masked]


def _jax_ring(inp, sp, masked):
    mask = jnp.asarray(_np(_mask(inp["lens"], masked)))
    mesh = JS.make_sp_mesh(data=1, seq=sp, model=1)
    ring = j_ring(mesh)
    q, k, v = (jnp.asarray(_np(inp[x])) for x in "qkv")
    w = jnp.asarray(_np(inp["w"])) * mask[:, None, :, None]

    def loss(q, k, v):
        return jnp.sum(ring(q, k, v, mask) * w)

    o = jax.jit(lambda q, k, v: ring(q, k, v, mask))(q, k, v)
    return np.asarray(o), [np.asarray(g) for g in jax.jit(jax.grad(loss, (0, 1, 2)))(q, k, v)]


def _plain_reference(inp, masked, lse: bool):
    """Unsharded torch autograd: o = sdpa, L = masked logsumexp (no kernel
    code: the independent check of the logsumexp cotangent's sign)."""
    q, k, v = (inp[x].clone().requires_grad_(True) for x in "qkv")
    mask = _mask(inp["lens"], masked)
    o = sdpa(q, k, v, mask)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * 64 ** -0.5
    L = torch.logsumexp(torch.where(mask[:, None, None, :], s, -1e30), dim=-1)
    keep = mask.float()
    loss = (o * inp["w"] * keep[:, None, :, None]).sum()
    if lse:
        loss = loss + (L * inp["wl"] * keep[:, None, :]).sum()
    return o, L, torch.autograd.grad(loss, (q, k, v))


CASES = [(sp, impl, masked) for sp in (2, 4) for impl in ("xla", "flash")
         for masked in (True, False)]


@pytest.mark.parametrize("sp,impl,masked", CASES)
def test_ring_forward_matches_jax_ring_and_sdpa(ring_case, sp, impl, masked):
    inp, outs = ring_case
    o = _np(_assemble(outs, (sp, impl, masked, False), sp, "o"))
    keep = _np(_mask(inp["lens"], masked))[:, None, :, None]
    jo, _ = _jax_ring_grads(inp, sp, masked)
    ref, L_ref, _ = _plain_reference(inp, masked, False)
    np.testing.assert_allclose(o * keep, jo * keep, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(o * keep, _np(ref) * keep, atol=2e-5, rtol=1e-4)
    L = _np(_assemble(outs, (sp, impl, masked, False), sp, "L"))
    np.testing.assert_allclose(L * keep[..., 0], _np(L_ref) * keep[..., 0], atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("sp,impl,masked", CASES)
def test_ring_gradients_match_jax_ring_and_sdpa(ring_case, sp, impl, masked):
    inp, outs = ring_case
    _, jg = _jax_ring_grads(inp, sp, masked)
    _, _, tg = _plain_reference(inp, masked, False)
    for i in range(3):
        g = _np(_assemble(outs, (sp, impl, masked, False), sp, "grads", i))
        np.testing.assert_allclose(g, jg[i], atol=5e-5, rtol=1e-3)
        np.testing.assert_allclose(g, _np(tg[i]), atol=5e-5, rtol=1e-3)


@pytest.mark.parametrize("sp,impl,masked", CASES)
def test_ring_gradients_through_the_logsumexp(ring_case, sp, impl, masked):
    """A loss that reads the ring's logsumexp: the flash block hands kernels
    D and E (their plain versions here) a non-zero logsumexp cotangent."""
    inp, outs = ring_case
    _, _, tg = _plain_reference(inp, masked, True)
    for i in range(3):
        g = _np(_assemble(outs, (sp, impl, masked, True), sp, "grads", i))
        np.testing.assert_allclose(g, _np(tg[i]), atol=5e-5, rtol=1e-3)


@pytest.mark.parametrize("sp", [2, 4])
def test_ring_backend_is_an_attention_callable(ring_case, sp):
    inp, outs = ring_case
    o = _np(_assemble(outs, (sp, "backend"), sp, "o"))
    keep = _np(_mask(inp["lens"], True))[:, None, :, None]
    ref = _np(sdpa(inp["q"], inp["k"], inp["v"], _mask(inp["lens"], True)))
    np.testing.assert_allclose(o * keep, ref * keep, atol=2e-5, rtol=1e-4)


def test_mesh_layouts_on_four_ranks(ring_case):
    """The data x seq mesh's placements, row slices and ZeRO-1 shards, as
    JAX's P(data, seq, None) / P(data) / zero1_state_specs lay them out."""
    _, outs = ring_case
    for rank, o in enumerate(outs):
        lay = o["layout"]
        dr = rank // 2  # mesh [data 2, seq 2]: data outer
        assert lay["activation"] == (Shard(0), Shard(1), Replicate())
        assert lay["batch"] == (Shard(0), Replicate(), Replicate())
        assert lay["data"] == (dr, 2) and lay["rows"] == (4 * dr, 4)
        assert lay["world_rows"] == (2 * rank, 2)
        assert torch.equal(lay["state"]["m"], torch.arange(8.0).reshape(4, 2)[2 * dr:2 * dr + 2])
        assert lay["state"]["n"].shape == (3,) and lay["state"]["count"].shape == ()
        assert lay["dims"] == (("data", "model"), (2, 2), ("data", "seq", "model"))


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_ring_in_process_equals_the_unsharded_attention(ring_case, impl):
    """The per-shard body with the rotation as an index (the form the card
    runs): o, L and the gradients of a loss reading both."""
    inp, _ = ring_case
    q, k, v = (inp[x].clone().requires_grad_(True) for x in "qkv")
    o, L = ring_attention_in_process(q, k, v, inp["lens"], 4, impl, return_lse=True)
    ref, L_ref, tg = _plain_reference(inp, True, True)
    keep = _mask(inp["lens"], True).float()
    loss = (o * inp["w"] * keep[:, None, :, None]).sum() + (L * inp["wl"] * keep[:, None]).sum()
    g = torch.autograd.grad(loss, (q, k, v))
    np.testing.assert_allclose(_np(o * keep[:, None, :, None]),
                               _np(ref * keep[:, None, :, None]), atol=2e-5, rtol=1e-4)
    for a, b in zip(g, tg):
        np.testing.assert_allclose(_np(a), _np(b), atol=5e-5, rtol=1e-3)


# ------------------------------------------------------ attention backends


def test_chunked_and_callable_backends_match_jax():
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((2, 2, 1024, 16)).astype(np.float32) for _ in range(3))
    mask = np.arange(1024)[None] < np.array([1024, 700])[:, None]
    tq, tk, tv, tm = (torch.from_numpy(a) for a in (q, k, v, mask))
    for n in (1024, 1000):  # 1000 is not a multiple of the chunk: sdpa, as JAX
        got = attention(tq[:, :, :n], tk[:, :, :n], tv[:, :, :n], tm[:, :n], backend="chunked")
        want = j_chunked(*(jnp.asarray(a[:, :, :n]) for a in (q, k, v)), jnp.asarray(mask[:, :n]))
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-5)
    seen = []

    def backend(q, k, v, m):
        seen.append(m.shape)
        return sdpa(q, k, v, m)

    got = attention(tq, tk, tv, tm, backend=backend)
    np.testing.assert_allclose(_np(got), np.asarray(j_sdpa(*map(jnp.asarray, (q, k, v, mask)))),
                               atol=2e-5)
    assert seen == [(2, 1024)]


def test_chunked_backend_is_differentiable():
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 1024, 16)).astype(np.float32))
               .requires_grad_(True) for _ in range(3))
    mask = torch.arange(1024)[None] < 900
    g1 = torch.autograd.grad(chunked_attention(q, k, v, mask).square().sum(), (q, k, v))
    g2 = torch.autograd.grad(sdpa(q, k, v, mask).square().sum(), (q, k, v))
    for a, b in zip(g1, g2):
        np.testing.assert_allclose(_np(a), _np(b), atol=5e-5, rtol=1e-3)


# ---------------------------------------------------- conv pos taps, specs


def test_conv_pos_embed_taps_matches_jax():
    from f5_tts_tpu.models import layers as JL

    rng = np.random.default_rng(6)
    cp = TL.ConvPositionEmbedding(64)
    with torch.no_grad():
        for p in cp.parameters():
            p.copy_(torch.from_numpy(0.2 * rng.standard_normal(p.shape).astype(np.float32)))
    x = rng.standard_normal((2, 40, 64)).astype(np.float32)
    mask = np.arange(40)[None] < np.array([40, 23])[:, None]
    conv = {nm: {"kernel": jnp.asarray(np.transpose(_np(c.weight), (2, 1, 0))),
                 "bias": jnp.asarray(_np(c.bias))}
            for nm, c in (("conv1", cp.conv1d[0]), ("conv2", cp.conv1d[2]))}
    want = np.asarray(JL.conv_pos_embed_taps(conv, jnp.asarray(x), jnp.asarray(mask)))
    got = TL.conv_pos_embed_taps(cp, torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(_np(got), want, atol=1e-5)
    # one function: kernel B (and its plain version) reads the taps already
    assert TL.conv_pos_embed_taps is TL.conv_pos_embed


def _jax_spec_by_key(tcfg, jcfg):
    """JAX's backbone_param_specs mapped onto the port's state_dict keys:
    every tensor gets a distinct constant, so each JAX leaf (stacked or not)
    names the keys it came from."""
    model = CFM(tcfg).transformer
    state = {k: np.full(v.shape, float(i + 1), np.float32)
             for i, (k, v) in enumerate(model.state_dict().items())}
    keys = list(state)
    params = params_from_state(state, jcfg)
    specs = JM.backbone_param_specs(params)
    out = {}
    for leaf, spec in zip(jax.tree.leaves(params), jax.tree.leaves(
            specs, is_leaf=lambda x: isinstance(x, JM.P))):
        leaf = np.asarray(leaf)
        for val in np.unique(leaf):
            key = keys[int(val) - 1]
            nd = state[key].ndim
            axes = list(spec)
            if leaf.ndim > nd and len(axes) == leaf.ndim:  # the stacked depth axis in front
                axes = axes[1:]
            if JM.MODEL_AXIS not in axes:
                out[key] = Replicate()
            elif nd == 1:
                out[key] = Shard(0)
            else:  # a JAX [in, out] kernel is torch's [out, in]: the axis flips
                out[key] = Shard(1 - axes.index(JM.MODEL_AXIS))
    return out, keys


@pytest.mark.parametrize("name", ["F5TTS_Tiny", "E2TTS_Base", "F5TTS_MMDiT_Base"])
def test_backbone_param_specs_equal_jax_leaf_by_leaf(name):
    from f5_tts_tpu.models.configs import MODEL_CONFIGS as JMODEL_CONFIGS

    # narrow and shallow: the rules do not depend on widths
    cfgs = []
    for c in (MODEL_CONFIGS[name].arch, JMODEL_CONFIGS[name].arch):
        small = dict(dim=64, depth=4, heads=2, dim_head=32, text_num_embeds=50)
        if getattr(c, "text_dim", None):
            small["text_dim"] = 16
        cfgs.append(dataclasses.replace(c, **small))
    tcfg, jcfg = cfgs
    want, keys = _jax_spec_by_key(tcfg, jcfg)
    got = TM.backbone_param_specs(CFM(tcfg).transformer)
    assert set(want) == set(keys) == set(got)
    assert got == want
    assert any(isinstance(s, Shard) and s.dim == 1 for s in got.values())
    assert TM.dit_param_specs is TM.backbone_param_specs


def test_zero1_state_specs_follow_jax_rule():
    ts = [torch.zeros(4, 3), torch.zeros(3, 4), torch.zeros(()), torch.zeros(6), torch.zeros(0, 2)]
    specs = TM.zero1_state_specs(ts, dp=2)
    assert specs == [Shard(0), Replicate(), Replicate(), Shard(0), Replicate()]
    t = torch.arange(12.0).reshape(6, 2)
    assert torch.equal(TM.shard_rows(t, 1, 2), t[3:])


# ------------------------------------------------------ sequence-parallel DiT


CFG = dict(dim=64, depth=2, heads=4, dim_head=16, ff_mult=2, mel_dim=8,
           text_num_embeds=40, text_dim=24, conv_layers=1, max_pos=128)


@pytest.fixture(scope="module")
def sp_case(tmp_path_factory):
    """JAX ``tests/test_sequence_parallel.py``'s setting (b 4, n 32), the
    port's seeded DiT with its zero-initialized projections randomized, and
    the four ranks' results on a data 2 x seq 2 mesh."""
    from f5_tts_tpu.models.configs import DiTConfig as JDiTConfig

    cfg = DiTConfig(**CFG)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        cfm = CFM(cfg)
    randomize_zero_init(cfm.transformer, torch.Generator().manual_seed(1))
    rng = np.random.default_rng(0)
    b, n, nt = 4, 32, 8
    x = rng.standard_normal((b, n, 8)).astype(np.float32)
    cond = rng.standard_normal((b, n, 8)).astype(np.float32)
    text_ids = rng.integers(0, 40, (b, nt)).astype(np.int32)
    time = rng.uniform(0.1, 0.9, (b,)).astype(np.float32)
    lens = rng.integers(n // 2, n + 1, (b,)).astype(np.int32)
    lens[1] = 5  # a row shorter than one shard
    mask = np.arange(n)[None] < lens[:, None]
    with torch.no_grad():
        te = TD.text_embedding(cfm.transformer, cfg, torch.from_numpy(text_ids), n,
                               lens=torch.from_numpy(lens))
    inp = dict(cfg=cfg, state=cfm.transformer.state_dict(), x=torch.from_numpy(x),
               cond=torch.from_numpy(cond), te=te, time=torch.from_numpy(time),
               mask=torch.from_numpy(mask), mel=torch.from_numpy(
                   rng.standard_normal((b, n, 8)).astype(np.float32)),
               text_ids=torch.from_numpy(text_ids), lens=torch.from_numpy(lens))
    tmp = tmp_path_factory.mktemp("dit_sp")
    torch.save(inp, tmp / "in.pt")
    jcfg = JDiTConfig(**CFG)
    jparams = params_from_state({k: _np(v) for k, v in inp["state"].items()}, jcfg)
    return inp, cfm, jcfg, jparams, W.spawn("dit_sp", 4, tmp)


def test_sequence_parallel_dit_forward_matches_jax_and_the_port_unsharded(sp_case):
    inp, cfm, jcfg, jparams, outs = sp_case
    x, cond, te, time, mask = (inp[k] for k in ("x", "cond", "te", "time", "mask"))
    with torch.no_grad():
        ref = TD.forward(cfm.transformer, inp["cfg"], x, cond, te, time, mask=mask,
                         backend="sdpa")
    want = jax.jit(functools.partial(JD.forward, cfg=jcfg, backend="sdpa"))(
        jparams, x=jnp.asarray(_np(x)), cond=jnp.asarray(_np(cond)), text_emb=jnp.asarray(_np(te)),
        time=jnp.asarray(_np(time)), mask=jnp.asarray(_np(mask)))
    got = torch.cat([o["forward"] for o in (outs[0], outs[2])])  # data ranks 0 and 1
    assert [o["rows"] for o in outs] == [(0, 2), (0, 2), (2, 4), (2, 4)]
    assert torch.equal(outs[0]["forward"], outs[1]["forward"])  # seq ranks agree
    np.testing.assert_allclose(_np(got), _np(ref), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("layout", ["dp2_sp2", "sp2"])
def test_sequence_parallel_train_step_matches_the_port_unsharded(sp_case, layout):
    """One ``train_step`` (ring attention, seq hook, global denominator,
    gradients summed over data x seq) against the one-process step on the
    whole batch: loss rtol 2e-5, gradients atol 1e-6 + rtol 1e-4, the
    updated parameters atol 1e-6."""
    import copy

    from f5_tts_tpu_torch.train.step import OptimConfig, make_optimizer, train_step

    inp, cfm0, _, _, outs = sp_case
    cfm = CFM(inp["cfg"])
    cfm.transformer.load_state_dict(inp["state"])
    opt_cfg = OptimConfig(num_warmup_updates=0, total_updates=10, learning_rate=1e-4)
    opt = make_optimizer(list(cfm.parameters()), opt_cfg)
    grads = {}
    orig = opt.step

    def keep(gs):
        grads.update({k: g.clone() for (k, _), g in zip(cfm.named_parameters(), gs)})
        return orig(gs)

    opt.step = keep
    batch = {k: inp[k] for k in ("mel", "text_ids", "lens")}
    _, met = train_step(cfm, opt, copy.deepcopy(cfm), 0, batch, 7, opt_cfg, backend="sdpa")
    for o in outs:
        got = o[layout]
        np.testing.assert_allclose(got["loss"], met["loss"].item(), rtol=2e-5)
        np.testing.assert_allclose(got["grad_norm"], met["grad_norm"].item(), rtol=2e-5)
        for k, g in grads.items():
            np.testing.assert_allclose(_np(got["grads"][k]), _np(g), atol=1e-6, rtol=1e-4,
                                       err_msg=k)
        for k, p in cfm.named_parameters():
            np.testing.assert_allclose(_np(got["params"][k]), _np(p), atol=1e-6, err_msg=k)


# ------------------------------------------------------------------ serving


@pytest.fixture(scope="module")
def serve_case(tmp_path_factory):
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(5):
        reqs.append(dict(
            ref_mel=rng.standard_normal((40 + int(rng.integers(0, 30)), 100)).astype(np.float32),
            text_ids=rng.integers(0, 200, size=20 + int(rng.integers(0, 20))).astype(np.int32),
            duration=int(rng.integers(120, 250)), seed=i))
    tmp = tmp_path_factory.mktemp("serve")
    torch.save({"requests": reqs}, tmp / "in.pt")
    return W.spawn("serve", 2, tmp)


@pytest.mark.parametrize("layout,mel_tol,wav_tol", [("data2", 2e-6, 2e-4), ("seq2", None, 3e-4)])
def test_batch_server_over_a_mesh_matches_mesh_none(serve_case, layout, mel_tol, wav_tol):
    for out in serve_case:  # every rank returns every request
        plain, got = out["plain"], out[layout]
        assert len(got["wavs"]) == len(plain["wavs"]) == 5 and got["n_lat"] == 3
        for a, b in zip(got["wavs"], plain["wavs"]):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, atol=wav_tol)
        if mel_tol is not None:
            for a, b in zip(got["mels"], plain["mels"]):
                np.testing.assert_allclose(a, b, atol=mel_tol)
    assert not any(serve_case[0][k]["taps"] for k in ("plain", "data2", "seq2"))
    assert serve_case[0]["seq2"]["hooks"] and not serve_case[0]["data2"]["hooks"]
    # overlap 2: two batches at once over data, one at a time under the ring
    assert [o[layout]["in_flight"] for o in serve_case] == [1 if layout == "seq2" else 2] * 2


def test_batch_server_refuses_tensor_parallel_and_a_foreign_mesh():
    """Tensor-parallel serving without a model axis leaves the engine whole
    (JAX shards only over a model axis above 1; the sharded case is in
    test_torch_tp.py); Picard over a mesh refuses an engine without a
    window, as JAX asserts; a mesh is a DeviceMesh."""
    from f5_tts_tpu_torch.infer.api import F5TTS
    from f5_tts_tpu_torch.infer.serve import BatchServer

    eng = F5TTS(model="F5TTS_Tiny", init_random=True, device="cpu", nfe_step=2).engine
    BatchServer(eng, tensor_parallel=True)
    assert not eng.tensor_parallel and not eng._collective()
    with pytest.raises(ValueError, match="time_parallel_window"):
        eng.enable_time_parallel(object())
    with pytest.raises(TypeError, match="DeviceMesh"):
        BatchServer(eng, mesh=object())


# ---------------------------------------------------------------------- CLI


def test_cli_parallel_flags(monkeypatch):
    """``--tensor_parallel``, ``--pipeline_parallel`` and
    ``--sequence_parallel`` need a world their product divides (the
    multi-rank runs are in test_torch_parallel_train.py and
    test_torch_model_parallel_train.py)."""
    for flags in (["--tensor_parallel", "2"], ["--pipeline_parallel", "2"],
                  ["--tensor_parallel", "2", "--pipeline_parallel", "2",
                   "--pipeline_microbatches", "4"]):
        with pytest.raises(SystemExit, match="torchrun"):
            TCLI.main(flags)
    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(SystemExit, match="torchrun"):
        TCLI.main(["--sequence_parallel", "2", "--zero1"])
