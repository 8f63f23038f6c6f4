"""Port W8A8 serving (ops/quant.py, the quantized branch of layers.linear,
the backbone walk, EngineOptions.quantize) against the JAX package.

Inputs come from numpy seeds, fp32 unless a test says bf16; the JAX Pallas
``int8_matmul`` runs in interpret mode, as tests/test_quant.py runs it.

- ``quantize_rows`` / ``quantize_cols`` give JAX's int8 values and scales
  bit for bit in fp32 and in bf16, against JAX run op by op.  Under
  ``jax.jit`` on the CPU, XLA does not round a bf16 intermediate that only
  feeds an fp32 convert: the jitted JAX scale leaves as fp32 amax / 127,
  unrounded, where the eager JAX and the port round it to bf16 first (they
  differ by less than one bf16 step in nearly every row); the int8 values
  still agree in all but at most 0.1% of the entries, by one step.
- ``int8_matmul_plain`` equals JAX's kernel on the same int8 inputs (rtol
  1e-6: the int32 sum is exact on both sides).
- The serving linear's plain version (``linear_w8a8_plain``, what kernel
  G's serving instance computes in one launch on the card) is JAX
  ``layers.linear`` on a ``kernel_q`` tree bit for bit, in bf16 and fp32,
  at ragged shapes, with an all-zero row and values whose quotient by the
  scale sits on a rounding half; a numpy emulation of the kernel's
  quantize arithmetic (true fp32 division, rounding to x's dtype, then
  rint) is JAX ``quantize_rows`` bit for bit.
- The quantized weights are JAX's ``kernel_q`` leaves, name for name and
  value for value, for DiT and MMDiT; UNetT raises ``ValueError`` (JAX a
  ``KeyError``).
- One W8A8 forward of a tiny DiT and a tiny MMDiT with carried-over
  weights, JAX run op by op: every int8 activation is JAX's, and the
  output is JAX's to 1e-5, while the quantization moves it by at least ten
  times that.
- The W8A8 engine's mel (NFE 4, the noise JAX draws) is the jitted JAX
  engine's to a relative L2 error of 1e-3; over a sampling trajectory one
  activation quantized to the other side of a rounding boundary spreads
  (``test_w8a8_engine_matches_jax`` says how far).
"""

import torch_threads  # noqa: F401  (first: caps torch's threads per test worker)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5_tts_tpu.infer import engine as JE
from f5_tts_tpu.models import dit as JD
from f5_tts_tpu.models import layers as JL
from f5_tts_tpu.models import mmdit as JM
from f5_tts_tpu.models.configs import ModelConfig as JModelConfig
from f5_tts_tpu.ops import quant as JQ
from f5_tts_tpu_torch.infer import engine as TE
from f5_tts_tpu_torch.models import dit as TD
from f5_tts_tpu_torch.models import mmdit as TM
from f5_tts_tpu_torch.models.cfm import CFM
from f5_tts_tpu_torch.models.configs import MODEL_CONFIGS
from f5_tts_tpu_torch.models.configs import ModelConfig as TModelConfig
from f5_tts_tpu_torch.ops import quant as TQ
from f5_tts_tpu_torch.utils import ckpt as TK
from tests import test_torch_mmdit as TMM
from tests.test_dit import SMALL as DIT_SMALL
from tests.test_dit import make_params
from tests.test_mmdit import SMALL as MMDIT_SMALL
from tests.test_torch_dit import port_cfg as dit_port_cfg

MEL_REL_L2 = 1e-3  # port vs the jitted JAX, W8A8 engine mel, fp32


@pytest.fixture(autouse=True)
def _interpret():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _rows(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * rng.uniform(0.1, 10.0, (shape[0], 1))).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_and_cols_match_jax(dtype):
    x = jnp.asarray(_rows(0, (96, 320))).astype(dtype)
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(getattr(torch, dtype))
    for jf, tf in ((JQ.quantize_rows, TQ.quantize_rows), (JQ.quantize_cols, TQ.quantize_cols)):
        qj, sj = jf(x)
        qt, st = tf(xt)
        assert qt.dtype == torch.int8 and st.dtype == torch.float32
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_quantize_rows_bf16_against_jitted_jax():
    x = jnp.asarray(_rows(1, (512, 1024))).astype(jnp.bfloat16)
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
    qj, sj = jax.jit(JQ.quantize_rows)(x)
    qt, st = TQ.quantize_rows(xt)
    diff = np.abs(qt.numpy().astype(np.int32) - np.asarray(qj).astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    # one bf16 step of the scale: the jitted scale is unrounded
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=2**-8)


@pytest.mark.parametrize("m,k,n", [(256, 512, 256), (96, 192, 80)])
def test_int8_matmul_plain_matches_jax(m, k, n):
    rng = np.random.default_rng(m + k + n)
    x_q = rng.integers(-127, 128, (m, k)).astype(np.int8)
    w_q = rng.integers(-127, 128, (k, n)).astype(np.int8)
    xs = rng.uniform(1e-3, 1e-1, (m, 1)).astype(np.float32)
    ws = rng.uniform(1e-3, 1e-1, (1, n)).astype(np.float32)
    want = np.asarray(JQ.int8_matmul(jnp.asarray(x_q), jnp.asarray(xs), jnp.asarray(w_q),
                                     jnp.asarray(ws)))
    got = TQ.int8_matmul(torch.from_numpy(x_q), torch.from_numpy(xs),
                         torch.from_numpy(np.ascontiguousarray(w_q.T)), torch.from_numpy(ws[0]))
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("m,k,n", [(256, 512, 256), (96, 192, 80)])
def test_quantized_linear_matches_dense(m, k, n):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    got = TQ.quantized_linear(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    want = x @ w
    err = np.abs(got - want).mean() / np.abs(want).mean()
    assert err < 2e-2, err  # W8A8 quantization noise envelope (tests/test_quant.py)


def test_int8_matmul_refuses_what_the_kernel_does_not_take():
    x_q = torch.zeros((4, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="k = "):
        TQ._check(torch.zeros((1, TQ.K_MAX + 1), dtype=torch.int8), torch.ones((1, 1)),
                  torch.zeros((1, TQ.K_MAX + 1), dtype=torch.int8), torch.ones((1,)))
    with pytest.raises(TypeError):
        TQ.int8_matmul_cuda(x_q.float(), torch.ones((4, 1)), x_q, torch.ones((4,)))
    with pytest.raises(ValueError, match="w_scale"):
        TQ.int8_matmul_cuda(x_q, torch.ones((4, 1)), x_q, torch.ones((1, 4)))


def _rows_with_edges(seed, m, k, dtype):
    """_rows at [m, k] in dtype, with an all-zero row and a row whose
    scale is exactly 2 and whose values are 2 (j + 0.5): their quotients
    by the scale are halves, which round to even."""
    x = _rows(seed, (m, k))
    x[min(1, m - 1)] = 0.0
    if m > 2:
        j = np.arange(k) % 127 - 63.0
        x[2] = 2.0 * (j + 0.5)
        x[2, 0] = 254.0  # the row max: scale = 254 / 127 = 2
    return jnp.asarray(x).astype(dtype)


def _emulated_quantize_rows(x32, dtype):
    """Kernel G's quantize arithmetic in numpy: the row max, the scale
    max(amax, 1e-8) / 127 and x / scale by true fp32 division, each rounded
    to x's dtype, then rint (half to even) and the clip."""
    to = (lambda a: a.astype(jnp.bfloat16).astype(np.float32)) if dtype == "bfloat16" else (
        lambda a: a)
    amax = np.abs(x32).max(axis=-1, keepdims=True)
    scale = to(to(np.maximum(amax, np.float32(1e-8))) / np.float32(127.0))
    q = np.clip(np.rint(to(x32 / scale)), -127, 127).astype(np.int8)
    return q, scale


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_quantize_arithmetic_matches_jax(dtype):
    x = _rows_with_edges(7, 64, 384, dtype)
    x32 = np.asarray(x.astype(jnp.float32))
    q, scale = _emulated_quantize_rows(x32, dtype)
    qj, sj = JQ.quantize_rows(x)
    np.testing.assert_array_equal(q, np.asarray(qj))
    np.testing.assert_array_equal(scale, np.asarray(sj))
    assert scale[1, 0] == np.float32(_emulated_quantize_rows(np.zeros((1, 1), np.float32),
                                                             dtype)[1][0, 0])
    assert scale[2, 0] == 2.0 and (q[2, 1:6] == np.rint(np.arange(1, 6) - 63.0 + 0.5)).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,n", [((96, 192), 80), ((37, 200), 72), ((2, 19, 64), 48)])
def test_linear_w8a8_plain_matches_jax_linear_bitwise(dtype, shape, n):
    """The serving linear (JAX layers.linear's kernel_q branch): quantize,
    int8 product, cast, bias, in x's dtype, bit for bit."""
    m, k = int(np.prod(shape[:-1])), shape[-1]
    x = _rows_with_edges(m + k, m, k, dtype).reshape(shape)
    rng = np.random.default_rng(n)
    w_q = rng.integers(-127, 128, (k, n)).astype(np.int8)
    ws = rng.uniform(1e-3, 1e-1, (1, n)).astype(np.float32)
    bias = jnp.asarray(rng.standard_normal(n).astype(np.float32) * 0.1).astype(dtype)
    want = np.asarray(JL.linear({"kernel_q": jnp.asarray(w_q), "w_scale": jnp.asarray(ws),
                                 "bias": bias}, x).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    got = TQ.linear_w8a8(torch.from_numpy(np.array(x.astype(jnp.float32))).to(tdt),
                         torch.from_numpy(np.ascontiguousarray(w_q.T)), torch.from_numpy(ws[0]),
                         torch.from_numpy(np.array(bias.astype(jnp.float32))).to(tdt))
    assert got.dtype == tdt and tuple(got.shape) == (*shape[:-1], n)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_split_k_keeps_every_split_long_and_none_empty():
    sms = 132
    for m, k, n in [(1024, 1024, 3072), (1024, 1024, 1024), (1024, 1024, 4096),
                    (1024, 4096, 1024), (1, 1024, 3072), (1, 4096, 1024), (4096, 1024, 3072),
                    (37, 1000, 200), (128, 65536, 256)]:
        s = TQ.split_k(m, n, k, sms)
        steps = -(-k // TQ.TILE_K)
        per = -(-steps // s)
        assert 1 <= s <= TQ.SPLIT_MAX and (s - 1) * per < steps  # no empty split
        assert s == 1 or (per >= TQ.SPLIT_MIN_STEPS and TQ._tiles(m, n) * s <= sms)
    assert TQ.split_k(1024, 1024, 4096, sms) == 2 and TQ.split_k(1024, 3072, 1024, sms) == 1


def test_linear_w8a8_dispatch_and_refusals():
    x = torch.ones((3, 8), dtype=torch.bfloat16)
    w_q, ws = TQ.quantize_weight(torch.ones((4, 8)))
    assert torch.equal(TQ.linear_w8a8(x, w_q, ws), TQ.linear_w8a8_plain(x, w_q, ws))
    with pytest.raises(ValueError, match="no implementation"):
        TQ.linear_w8a8(x.to("meta"), w_q.to("meta"), ws.to("meta"))
    with pytest.raises(TypeError, match="bf16 or fp32"):
        TQ.linear_w8a8_cuda(x.half(), w_q, ws)
    with pytest.raises(ValueError, match="w_q"):
        TQ.linear_w8a8_cuda(x, w_q.float(), ws)
    with pytest.raises(ValueError, match="bias"):
        TQ.linear_w8a8_cuda(x, w_q, ws, torch.zeros(4))
    with pytest.raises(ValueError, match="k = "):
        TQ.linear_w8a8_cuda(torch.zeros((1, TQ.K_MAX + 1), dtype=torch.bfloat16),
                            torch.zeros((1, TQ.K_MAX + 1), dtype=torch.int8), torch.ones(1))


def _dit_carried(seed=0):
    """(JAX params, port CFM) of tests/test_dit.py's SMALL, same weights."""
    params = make_params(DIT_SMALL, seed=seed)
    model = CFM(dit_port_cfg(DIT_SMALL)).eval().requires_grad_(False)
    TK.load_into(model, TK.state_from_jax_params(jax.tree.map(np.asarray, params), DIT_SMALL))
    return params, model


# JAX tree path of a kernel_q leaf (stacked over the blocks) -> port weight suffix
_JAX_TO_PORT = {("attn", "to_qkv"): "attn.qkv_weight", ("attn", "to_out"): "attn.to_out.0.weight",
                ("ff", "in"): "ff.ff.0.0.weight", ("ff", "out"): "ff.ff.2.weight",
                **{("attn", f"to_{c}"): f"attn.to_{c}.weight" for c in "qkv"}}


def _jax_kernel_q(params):
    """{port name: (int8 [k, n], scale [1, n])} of every kernel_q leaf."""
    out = {}
    for path, lin in (((grp, key), v) for grp, sub in params["blocks"].items()
                      if isinstance(sub, dict) for key, v in sub.items()):
        if isinstance(lin, dict) and "kernel_q" in lin:
            for i in range(lin["kernel_q"].shape[0]):
                out[f"transformer_blocks.{i}.{_JAX_TO_PORT[path]}"] = (
                    np.asarray(lin["kernel_q"][i]), np.asarray(lin["w_scale"][i]))
    return out


def _port_quantized(model):
    """{name: (int8 [n, k], scale [n])} of every module holding W8A8 buffers."""
    out = {}
    for name, mod in model.named_modules():
        for wq, ws, suffix in (("weight_q", "w_scale", "weight"),
                               ("qkv_weight_q", "qkv_w_scale", "qkv_weight")):
            if getattr(mod, wq, None) is not None:
                out[f"{name}.{suffix}"] = (getattr(mod, wq).numpy(), getattr(mod, ws).numpy())
    return out


@pytest.mark.parametrize("family", ["dit", "mmdit"])
def test_quantized_linears_are_jax_kernel_q_leaves(family):
    if family == "dit":
        params, cfm = _dit_carried()
        params = JD.fuse_for_inference(params)
        TD.fuse_for_inference(cfm.transformer)
        arch = dit_port_cfg(DIT_SMALL)
    else:
        params, cfm = TMM.carried(MMDIT_SMALL)
        arch = TMM.port_cfg(MMDIT_SMALL)
    want = _jax_kernel_q(JQ.quantize_dit_blocks(params))
    names = TQ.quantize_dit_blocks(cfm.transformer, arch)
    got = _port_quantized(cfm.transformer)
    assert sorted(names) == sorted(got) == sorted(want)
    # DiT: qkv, out, ff in, ff out in every block; MMDiT: q, k, v, out in all but the last
    assert len(want) == 4 * (arch.depth if family == "dit" else arch.depth - 1)
    for name, (wq, ws) in want.items():
        np.testing.assert_array_equal(got[name][0], wq.T)
        np.testing.assert_array_equal(got[name][1], ws[0])
    # the state dict keeps the reference keys and no W8A8 buffer
    assert not any(k.endswith(("_q", "w_scale")) for k in cfm.state_dict())


def test_unett_refuses_quantization_as_jax_cannot():
    with pytest.raises(KeyError):  # the JAX fault: quantize_dit_blocks reads params["blocks"]
        JQ.quantize_dit_blocks({"first": {}, "second": {}})
    cfg = MODEL_CONFIGS["E2TTS_Small"]
    with torch.device("meta"):
        model = CFM(cfg.arch)
    with pytest.raises(ValueError, match="no counterpart"):
        TQ.quantize_dit_blocks(model.transformer, cfg.arch)


def _inputs(mel_dim, n=32, seed=5):
    rng = np.random.default_rng(seed)
    b = 2
    cond = rng.standard_normal((b, n, mel_dim)).astype(np.float32)
    lens = np.array([9, 6], np.int32)
    cond[np.arange(n)[None, :] >= lens[:, None]] = 0
    text = np.full((b, n), -1, np.int32)
    text[0, :14] = rng.integers(0, 30, 14)
    text[1, :9] = rng.integers(0, 30, 9)
    duration = np.array([28, 20], np.int32)
    seeds = np.array([3, 4], np.int32)
    noise = np.stack([np.asarray(jax.random.normal(jax.random.PRNGKey(int(s)), (n, mel_dim)))
                      for s in seeds])
    return cond, text, lens, duration, seeds, noise


def _engine_mels(jparams, jarch, cfm, tarch, quantize):
    """(JAX mel, port mel) of one W8A8 or dense engine call, mel-conditioned,
    NFE 4, fp32, the same noise on both sides."""
    cond, text, lens, duration, seeds, noise = _inputs(jarch.mel_dim)
    jcfg, tcfg = JModelConfig(name="small", arch=jarch), TModelConfig(name="small", arch=tarch)
    jeng = JE.InferenceEngine(jparams, jcfg, options=JE.EngineOptions(nfe_step=4,
                                                                      quantize=quantize))
    want, _ = JE._sample_and_decode(jeng.dit_params, None, jcfg, jeng.options, jnp.asarray(cond),
                                    jnp.asarray(text), jnp.asarray(lens), jnp.asarray(duration),
                                    jnp.asarray(seeds), decode=False)
    teng = TE.InferenceEngine(cfm, tcfg, options=TE.EngineOptions(nfe_step=4, quantize=quantize))
    got, _ = TE.sample_and_decode(teng.model.transformer, None, tcfg, teng.options,
                                  *(torch.from_numpy(a) for a in (cond, text, lens, duration,
                                                                  noise)), decode=False)
    return np.asarray(want), got.numpy()


def _carried(family, seed):
    """(JAX params, port CFM, JAX arch, port arch) of a tiny DiT or MMDiT."""
    if family == "dit":
        return (*_dit_carried(seed), DIT_SMALL, dit_port_cfg(DIT_SMALL))
    return (*TMM.carried(MMDIT_SMALL, seed=seed), MMDIT_SMALL, TMM.port_cfg(MMDIT_SMALL))


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("family", ["dit", "mmdit"])
def test_w8a8_forward_matches_eager_jax(family, monkeypatch):
    """One W8A8 forward, the JAX function run op by op: every int8
    activation is JAX's (the same fp32 arithmetic up to summation order),
    and the output is JAX's to 1e-5 while the quantization moves it by at
    least ten times that."""
    jparams, cfm, jarch, tarch = _carried(family, 2)
    jmod, tmod = (JD, TD) if family == "dit" else (JM, TM)
    rng = np.random.default_rng(4)
    b, n = 2, 24
    x, cond = (rng.standard_normal((b, n, jarch.mel_dim)).astype(np.float32) for _ in range(2))
    text = rng.integers(0, jarch.text_num_embeds, (b, n)).astype(np.int32)
    text[1, 9:] = -1
    time = np.array([0.3, 0.6], np.float32)
    model = cfm.transformer
    dense = tmod.forward_with_text(model, tarch, *(torch.from_numpy(a) for a in (x, cond, text,
                                                                                 time))).numpy()
    if family == "dit":
        jparams = JD.fuse_for_inference(jparams)
        TD.fuse_for_inference(model)
    jq = JQ.quantize_dit_blocks(jparams)
    TQ.quantize_dit_blocks(model, tarch)
    seen = {"jax": [], "port": []}
    for side, mod in (("jax", JQ), ("port", TQ)):
        inner = mod.quantize_rows
        monkeypatch.setattr(mod, "quantize_rows", lambda t, inner=inner, side=side: (
            lambda q: seen[side].append(np.asarray(q[0])) or q)(inner(t)))
    with jax.disable_jit():
        want = np.asarray(jmod.forward_with_text(jq, jarch, *(jnp.asarray(a) for a in (
            x, cond, text, time)), backend="sdpa"))
    got = tmod.forward_with_text(model, tarch, *(torch.from_numpy(a) for a in (x, cond, text,
                                                                               time))).numpy()
    assert len(seen["jax"]) == len(seen["port"]) == 4 * (jarch.depth - (family == "mmdit"))
    for qj, qt in zip(seen["jax"], seen["port"]):
        np.testing.assert_array_equal(qt, qj)
    port_vs_jax, quant_vs_dense = _rel(got, want), _rel(got, dense)
    assert port_vs_jax <= 1e-5, port_vs_jax
    assert quant_vs_dense >= 10 * port_vs_jax, (quant_vs_dense, port_vs_jax)


@pytest.mark.parametrize("family", ["dit", "mmdit"])
def test_w8a8_engine_matches_jax(family):
    """The W8A8 engine (fuse, quantize, NFE 4 sampling, fp32) against the
    jitted JAX engine.  Relative L2 1e-3: the two quantize the same fp32
    activations, but an activation within ~1e-7 of an int8 rounding
    boundary can land on either side (XLA also rewrites the division by
    127 as a product by its reciprocal, which moves some scales by one
    ulp); that one step then moves the next layers' activations by ~1e-4,
    and the flips spread (measured on the tiny DiT: a flip in the first
    quantized linear of the first step; the mels then differ by 3.5e-4
    against 9.7e-4 between the port's W8A8 and dense engines).  So the
    quantization is held against the dense engines' port-vs-JAX
    difference, not against this one."""
    jparams, cfm, jarch, tarch = _carried(family, 1)
    dense_j, dense_t = _engine_mels(jparams, jarch, cfm, tarch, quantize=False)
    want, got = _engine_mels(jparams, jarch, cfm, tarch, quantize=True)
    assert any(getattr(m, "weight_q", None) is not None for m in cfm.modules())
    port_vs_jax, quant_vs_dense = _rel(got, want), _rel(got, dense_t)
    assert port_vs_jax <= MEL_REL_L2, port_vs_jax
    assert quant_vs_dense >= 10 * _rel(dense_t, dense_j) and quant_vs_dense > port_vs_jax, (
        quant_vs_dense, port_vs_jax)
    # the quantized model is the quantized engine's: a second engine refuses it
    with pytest.raises(ValueError, match="its own model"):
        TE.InferenceEngine(cfm, TModelConfig(name="small", arch=tarch))


def test_engine_options_take_quantize_and_still_refuse_later_fields(monkeypatch):
    """The time-parallel window is ported (it reaches the sampler's
    options); so are the mesh-serving convpos taps, and the engine's hooks
    (a pipeline block scan, the seq hook, Picard's mesh) reach the sampler."""
    assert TE.EngineOptions(quantize=True).quantize
    opts = TE.EngineOptions(time_parallel_window=2, picard_tol=0.0).sample_opts()
    assert (opts.time_parallel_window, opts.picard_tol) == (2, 0.0)
    assert TE.EngineOptions(convpos_taps=True).convpos_taps
    seen = {}
    monkeypatch.setattr(TE.cfm, "sample", lambda *a, **k: seen.update(k))
    hooks = (object(), object(), object())
    TE.sample_and_decode(None, None, MODEL_CONFIGS["F5TTS_Tiny"], TE.EngineOptions(),
                         torch.zeros(1), None, None, None, torch.zeros(1), decode=False,
                         hooks=hooks)
    assert (seen["block_scan"], seen["activation_constraint"],
            seen["time_parallel_mesh"]) == hooks
    assert dataclasses.replace(TE.EngineOptions(quantize=True), nfe_step=8).quantize
