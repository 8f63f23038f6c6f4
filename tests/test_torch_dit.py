"""Port DiT (models/layers.py, models/dit.py, utils/ckpt.py) against the JAX
package with carried-over weights.

The JAX parameters come from ``tests/test_dit.py``'s ``make_params`` (AdaLN
gates and ``proj_out`` randomized: zero gates would make the comparison
vacuous) and reach the port through ``state_from_jax_params``.  Everything
runs in fp32 on the CPU: the JAX side through its plain XLA paths
(``backend="sdpa"``, the XLA grouped convs), the port through the plain
versions of its kernels.  Tolerance atol 1e-4: the same fp32 math summed in
another order across a few layers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5_tts_tpu.models import dit as JD
from f5_tts_tpu.models import layers as JL
from f5_tts_tpu.utils.ckpt import dit_params_to_state
from f5_tts_tpu_torch.models import dit as TD
from f5_tts_tpu_torch.models import layers as TL
from f5_tts_tpu_torch.models.cfm import CFM
from f5_tts_tpu_torch.models.configs import DiTConfig as TorchDiTConfig
from f5_tts_tpu_torch.utils import ckpt as TC
from tests.test_dit import SMALL, make_params

ATOL = 1e-4


def port_cfg(cfg):
    names = {f.name for f in dataclasses.fields(TorchDiTConfig)}
    return TorchDiTConfig(**{k: v for k, v in dataclasses.asdict(cfg).items() if k in names})


def carried(cfg, seed=0):
    params = make_params(cfg, seed=seed)
    params_np = jax.tree.map(np.asarray, params)
    model = CFM(port_cfg(cfg)).eval().requires_grad_(False)
    TC.load_into(model, TC.state_from_jax_params(params_np, cfg))
    return params, model.transformer


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(cfg, b=2, n=32, nt=12, seed=11):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n, cfg.mel_dim)).astype(np.float32)
    cond = rng.standard_normal((b, n, cfg.mel_dim)).astype(np.float32)
    text = rng.integers(0, cfg.text_num_embeds, (b, nt)).astype(np.int32)
    text[1, 8:] = -1
    time = np.array([0.3, 0.7], np.float32)
    lens = np.array([n, n - 10], np.int32)
    mask = np.arange(n)[None, :] < lens[:, None]
    return x, cond, text, time, lens, mask


INPUTS = _inputs(SMALL)


@pytest.fixture(scope="module")
def small():
    """(JAX params, port DiT) of SMALL with the same weights."""
    return carried(SMALL)


def _block(small, i):
    params, model = small
    return jax.tree.map(lambda a: a[i], params["blocks"]), model.transformer_blocks[i]


@pytest.mark.parametrize("with_mod", [False, True])
def test_dit_block_matches_jax(small, with_mod):
    x, _, _, time, lens, mask = INPUTS
    rng = np.random.default_rng(3)
    h = rng.standard_normal((2, 32, SMALL.dim)).astype(np.float32)
    jp, tp = _block(small, 1)
    rope_np = np.asarray(JD.rotary_freqs(SMALL.max_pos, SMALL.dim_head)[:32])
    t_emb = rng.standard_normal((2, SMALL.dim)).astype(np.float32)
    mod = rng.standard_normal((6 * SMALL.dim,)).astype(np.float32) * 0.3 if with_mod else None
    want = np.asarray(JL.dit_block(jp, jnp.asarray(h), jnp.asarray(t_emb), SMALL.heads,
                                   mask=jnp.asarray(mask), rope_freqs=jnp.asarray(rope_np),
                                   backend="sdpa",
                                   mod=None if mod is None else jnp.asarray(mod)))
    got = TL.dit_block(tp, _t(h), _t(t_emb), SMALL.heads, mask=_t(mask), rope_freqs=_t(rope_np),
                       mod=None if mod is None else _t(mod)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("pe_attn_head", [None, 1])
def test_mha_matches_jax(small, pe_attn_head):
    _, _, _, _, _, mask = INPUTS
    h = np.random.default_rng(4).standard_normal((2, 32, SMALL.dim)).astype(np.float32)
    jp, tp = _block(small, 2)
    rope_np = np.asarray(JD.rotary_freqs(SMALL.max_pos, SMALL.dim_head)[:32])
    want = np.asarray(JL.mha(jp["attn"], jnp.asarray(h), SMALL.heads, mask=jnp.asarray(mask),
                             rope_freqs=jnp.asarray(rope_np), pe_attn_head=pe_attn_head,
                             backend="sdpa"))
    got = TL.mha(tp.attn, _t(h), SMALL.heads, mask=_t(mask), rope_freqs=_t(rope_np),
                 pe_attn_head=pe_attn_head).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert np.all(got[1, 22:] == 0)  # output re-masked


def test_convnext_v2_matches_jax(small):
    params, model = small
    x = np.random.default_rng(5).standard_normal((2, 20, SMALL.text_dim)).astype(np.float32)
    want = np.asarray(JL.convnext_v2(params["text_embed"]["blocks"][1], jnp.asarray(x)))
    got = TL.convnext_v2(model.text_embed.text_blocks[1], _t(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("upsample", [False, True])
@pytest.mark.parametrize("drop_text", [False, True])
def test_text_embedding_matches_jax(small, upsample, drop_text):
    params, model = small
    cfg = dataclasses.replace(SMALL, text_embedding_average_upsampling=upsample)
    _, _, text, _, lens, _ = INPUTS
    want = np.asarray(JD.text_embedding(params, cfg, jnp.asarray(text), 32, lens=jnp.asarray(lens),
                                        drop_text=drop_text))
    got = TD.text_embedding(model, port_cfg(cfg), _t(text), 32, lens=_t(lens),
                            drop_text=drop_text).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("use_mask", [False, True])
def test_forward_matches_jax(small, use_mask):
    params, model = small
    x, cond, text, time, lens, mask = INPUTS
    te = JD.text_embedding(params, SMALL, jnp.asarray(text), 32, lens=jnp.asarray(lens))
    m = jnp.asarray(mask) if use_mask else None
    want = np.asarray(JD.forward(params, SMALL, jnp.asarray(x), jnp.asarray(cond), te,
                                 jnp.asarray(time), mask=m, backend="sdpa"))
    got = TD.forward(model, port_cfg(SMALL), _t(x), _t(cond), _t(te), _t(time),
                     mask=_t(mask) if use_mask else None).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_forward_cfg_and_precompute_adaln_match_jax(small):
    params, model = small
    x, cond, text, _, lens, mask = INPUTS
    pc = port_cfg(SMALL)
    te_c = JD.text_embedding(params, SMALL, jnp.asarray(text), 32, lens=jnp.asarray(lens))
    te_u = JD.text_embedding(params, SMALL, jnp.asarray(text), 32, lens=jnp.asarray(lens),
                             drop_text=True)
    times = np.array([0.1, 0.45], np.float32)
    jm, jf = JD.precompute_adaln(params, SMALL, jnp.asarray(times))
    tm, tf = TD.precompute_adaln(model, pc, _t(times))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=ATOL)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=ATOL)
    t = jnp.float32(0.45)
    want = JD.forward_cfg(params, SMALL, jnp.asarray(x), jnp.asarray(cond), te_c, te_u, t,
                          mask=jnp.asarray(mask), backend="sdpa", adaln_mods=(jm[1], jf[1]))
    got = TD.forward_cfg(model, pc, _t(x), _t(cond), _t(te_c), _t(te_u), torch.tensor(0.45),
                         mask=_t(mask), adaln_mods=(tm[1], tf[1]))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


def test_fused_qkv_keeps_outputs_and_state_dict():
    x, cond, text, time, lens, mask = INPUTS
    _, model = carried(SMALL, seed=1)
    te = TD.text_embedding(model, port_cfg(SMALL), _t(text), 32, lens=_t(lens))
    args = (_t(x), _t(cond), te, _t(time))
    keys = set(model.state_dict())
    before = TD.forward(model, port_cfg(SMALL), *args, mask=_t(mask))
    TD.fuse_for_inference(model)
    after = TD.forward(model, port_cfg(SMALL), *args, mask=_t(mask))
    torch.testing.assert_close(after, before, atol=1e-5, rtol=1e-5)
    assert set(model.state_dict()) == keys


def test_state_from_jax_params_agrees_with_jax_dit_params_to_state(small):
    params, model = small
    want = dit_params_to_state(params, SMALL, prefix="transformer.")
    got = TC.state_from_jax_params(jax.tree.map(np.asarray, params), SMALL)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    # and every reference name is one the port's module holds
    assert set(got) == set(CFM(port_cfg(SMALL)).state_dict())


@pytest.mark.parametrize("fmt", ["safetensors", "pt"])
def test_load_reference_named_checkpoint(small, tmp_path, fmt):
    params, ref = small
    state = {"ema_model." + k: torch.from_numpy(np.array(v))
             for k, v in TC.state_from_jax_params(jax.tree.map(np.asarray, params), SMALL).items()}
    state["ema_model.initted"] = torch.tensor(True)
    state["ema_model.step"] = torch.tensor(10)
    state["ema_model.mel_spec.mel_stft.window"] = torch.ones(4)
    path = str(tmp_path / f"model.{fmt}")
    if fmt == "safetensors":
        from safetensors.torch import save_file

        save_file(state, path)
    else:
        raw = {k[len("ema_model."):]: torch.zeros_like(v) for k, v in state.items()}
        torch.save({"ema_model_state_dict": state, "model_state_dict": raw}, path)
    model = CFM(port_cfg(SMALL))
    TC.load_dit_state(model, TC.load_torch_state(path, use_ema=True))
    for k, v in ref.state_dict().items():
        torch.testing.assert_close(model.transformer.state_dict()[k], v, atol=0, rtol=0)
    if fmt == "pt":
        TC.load_dit_state(model, TC.load_torch_state(path, use_ema=False))
        assert all(torch.all(v == 0) for v in model.state_dict().values())
