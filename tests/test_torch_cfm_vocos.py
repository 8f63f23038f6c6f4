"""Port sampler (models/cfm.py) and vocoder (models/vocos.py) against the
JAX package, with carried-over weights and injected noise (the two RNGs
differ by design), fp32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5_tts_tpu.models import cfm as JC
from f5_tts_tpu.models import vocos as JV
from f5_tts_tpu_torch.models import cfm as TC
from f5_tts_tpu_torch.models import vocos as TV
from f5_tts_tpu_torch.utils.ckpt import load_into, vocos_state_from_jax_params
from tests.test_dit import SMALL
from tests.test_torch_dit import carried, port_cfg


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("steps", [16, 32])
def test_timestep_schedule_equals_jax(steps):
    np.testing.assert_array_equal(TC.timestep_schedule(steps), JC.timestep_schedule(steps))


@pytest.mark.parametrize("case", ["euler", "midpoint", "edit_mask", "no_ref_audio"])
def test_sample_matches_jax(case):
    """NFE 16, EPSS + sway, CFG 2.  Mel MAE < 1e-4: fp32 on both sides; the
    16-step ODE accumulates the per-forward reassociation differences."""
    params, model = carried(SMALL, seed=2)
    rng = np.random.default_rng(17)
    b, n, nt, d = 2, 64, 12, SMALL.mel_dim
    cond = rng.standard_normal((b, n, d)).astype(np.float32)
    lens = np.array([16, 20], np.int32)
    cond[0, 16:] = 0.0
    cond[1, 20:] = 0.0
    text = rng.integers(0, SMALL.text_num_embeds, (b, nt)).astype(np.int32)
    text[1, 9:] = -1
    duration = np.array([60, 50], np.int32)
    noise = rng.standard_normal((b, n, d)).astype(np.float32)
    edit = None
    if case == "edit_mask":
        edit = np.ones((b, n), bool)
        edit[:, 5:9] = False
    ode = "midpoint" if case == "midpoint" else "euler"
    jopts = JC.SampleOptions(steps=16, cfg_strength=2.0, sway_sampling_coef=-1.0, ode_method=ode)
    topts = TC.SampleOptions(steps=16, cfg_strength=2.0, sway_sampling_coef=-1.0, ode_method=ode)
    no_ref = case == "no_ref_audio"
    want = np.asarray(JC.sample(params, SMALL, jnp.asarray(cond), jnp.asarray(text),
                                jnp.asarray(duration), jnp.asarray(noise), lens=jnp.asarray(lens),
                                opts=jopts, backend="sdpa", no_ref_audio=no_ref,
                                edit_mask=None if edit is None else jnp.asarray(edit)))
    got = TC.sample(model, port_cfg(SMALL), _t(cond), _t(text), _t(duration), _t(noise),
                    lens=_t(lens), opts=topts, no_ref_audio=no_ref,
                    edit_mask=None if edit is None else _t(edit)).numpy()
    mae = np.abs(got - want).mean()
    assert mae < 1e-4, mae
    assert np.all(got[1, 50:] == 0)


def test_time_parallel_window_raises():
    _, model = carried(SMALL)
    z = torch.zeros((1, 8, SMALL.mel_dim))
    with pytest.raises(NotImplementedError, match="Picard"):
        TC.sample(model, port_cfg(SMALL), z, torch.zeros((1, 2), dtype=torch.int32),
                  torch.tensor([8]), z, opts=TC.SampleOptions(time_parallel_window=4))


@pytest.mark.parametrize("with_lens", [False, True])
def test_vocos_decode_matches_jax(with_lens):
    """Default VocosConfig, n=32.  atol 1e-4 and rtol 1e-4: fp32 on both
    sides, 8 ConvNeXt blocks and an ISTFT summed in another order; past the
    last valid frame of a masked row the envelope division leaves samples in
    the hundreds (random weights), where only the relative bound is
    meaningful."""
    cfg_j, cfg_t = JV.VocosConfig(), TV.VocosConfig()
    params = JV.init(jax.random.PRNGKey(1), cfg_j)
    voc = TV.Vocos(cfg_t).eval()
    load_into(voc, vocos_state_from_jax_params(jax.tree.map(np.asarray, params)))
    mel = np.random.default_rng(3).standard_normal((2, 32, 100)).astype(np.float32) - 4.0
    lens = np.array([32, 21], np.int32) if with_lens else None
    want = np.asarray(JV.decode(params, jnp.asarray(mel), cfg_j,
                                lens=None if lens is None else jnp.asarray(lens)))
    got = TV.decode(voc, _t(mel), lens=None if lens is None else _t(lens)).numpy()
    assert got.shape == want.shape == (2, 31 * 256)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
