"""The port's BigVGAN (models/bigvgan.py) and its loader against the JAX
package, piece by piece and as a whole decode on a narrow config, fp32 on
the CPU.  The weights are made in numpy as a reference-keyed, weight-normed
state dict and carried into JAX with its own ``bigvgan_params_from_state``."""

import torch_threads  # noqa: F401  (first: caps torch's threads per test worker)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5_tts_tpu.models import bigvgan as JB
from f5_tts_tpu.utils.ckpt import bigvgan_params_from_state
from f5_tts_tpu_torch.models import bigvgan as TB
from f5_tts_tpu_torch.utils import ckpt as TK

# a narrow BigVGAN: the published structure (two upsample stages, AMP blocks
# of kernels 3 and 7 over dilations 1, 3, 5, SnakeBeta with log scale) at 32
# channels
NARROW = dict(num_mels=100, upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
              upsample_initial_channel=32, resblock_kernel_sizes=(3, 7),
              resblock_dilation_sizes=((1, 3, 5), (1, 3, 5)))
# decode, fp32 on both sides: XLA's and oneDNN's convs sum in other orders,
# and the residual stream carries the differences through two stages (1.6e-7
# measured at a peak of 0.16)
ATOL = 2e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_cfg():
    return JB.BigVGANConfig(**NARROW)


def _port_cfg():
    return TB.BigVGANConfig(**NARROW)


def weight_normed_state(cfg, seed: int, scale: float = 1.0) -> dict:
    """A reference-keyed generator state dict with weight-normed convs
    (``weight_g`` / ``weight_v``), random SnakeBeta parameters and the
    release's resample filter buffers, as numpy arrays."""
    rng = np.random.default_rng(seed)
    state = {}

    def wn(name, shape, bias=True):
        v = rng.standard_normal(shape).astype(np.float32)
        state[f"{name}.weight_v"] = v
        state[f"{name}.weight_g"] = (scale * rng.uniform(0.5, 1.5, (shape[0], 1, 1))
                                     ).astype(np.float32)
        if bias:
            n_out = shape[1] if name.startswith("ups.") else shape[0]
            state[f"{name}.bias"] = (0.1 * rng.standard_normal(n_out)).astype(np.float32)

    def snake(name, ch):
        state[f"{name}.act.alpha"] = (0.3 * rng.standard_normal(ch)).astype(np.float32)
        state[f"{name}.act.beta"] = (0.3 * rng.standard_normal(ch)).astype(np.float32)
        state[f"{name}.upsample.filter"] = JB.kaiser_sinc_filter1d(0.25, 0.3, 12)[None, None]
        state[f"{name}.downsample.lowpass.filter"] = state[f"{name}.upsample.filter"].copy()

    ch = cfg.upsample_initial_channel
    wn("conv_pre", (ch, cfg.num_mels, 7))
    n_res = len(cfg.resblock_kernel_sizes)
    for i, k in enumerate(cfg.upsample_kernel_sizes):
        wn(f"ups.{i}.0", (ch, ch // 2, k))  # ConvTranspose1d [in, out, k]
        ch //= 2
        for j, (rk, dil) in enumerate(zip(cfg.resblock_kernel_sizes,
                                          cfg.resblock_dilation_sizes)):
            r = f"resblocks.{i * n_res + j}"
            for m in range(len(dil)):
                wn(f"{r}.convs1.{m}", (ch, ch, rk))
                wn(f"{r}.convs2.{m}", (ch, ch, rk))
            for m in range(2 * len(dil)):
                snake(f"{r}.activations.{m}", ch)
    snake("activation_post", ch)
    wn("conv_post", (1, ch, 7), bias=cfg.use_bias_at_final)
    return state


def carried(seed: int = 0, scale: float = 1.0):
    """(JAX params, port module) with the same weights."""
    state = weight_normed_state(_port_cfg(), seed, scale)
    params = bigvgan_params_from_state(state, _jax_cfg())
    voc = TK.load_bigvgan_state(TB.BigVGAN(_port_cfg()), state).eval()
    return params, voc


@pytest.mark.parametrize("cutoff,half_width,k", [(0.25, 0.3, 12), (0.1, 0.05, 9),
                                                 (0.4, 0.02, 16), (0.0, 0.3, 12)])
def test_kaiser_sinc_filter_equals_jax(cutoff, half_width, k):
    np.testing.assert_array_equal(TB.kaiser_sinc_filter1d(cutoff, half_width, k),
                                  JB.kaiser_sinc_filter1d(cutoff, half_width, k))


@pytest.mark.parametrize("n", [1, 7, 64])
def test_upsample_and_downsample_match_jax(n):
    """Exactly 2n samples up and n down; atol 1e-6 (a 12-tap fp32 sum)."""
    x = np.random.default_rng(n).standard_normal((2, n, 6)).astype(np.float32)  # [b, n, c]
    act = TB.Activation1d(6)
    up, down = JB._aa_filters()
    want_up = np.asarray(JB._upsample2(jnp.asarray(x), up))
    got_up = TB.upsample2(_t(x).transpose(1, 2), act.up_filter).transpose(1, 2).numpy()
    assert got_up.shape == want_up.shape == (2, 2 * n, 6)
    np.testing.assert_allclose(got_up, want_up, atol=1e-6)
    want_dn = np.asarray(JB._downsample2(jnp.asarray(want_up), down))
    got_dn = TB.downsample2(_t(want_up).transpose(1, 2), act.down_filter).transpose(1, 2).numpy()
    assert got_dn.shape == want_dn.shape == (2, n, 6)
    np.testing.assert_allclose(got_dn, want_dn, atol=1e-6)
    # the grouped filters are built once, per channel, dense (no stride-0 expand)
    assert act.up_filter.shape == (6, 1, 12) and act.up_filter.is_contiguous()
    assert "up_filter" not in act.state_dict()


@pytest.mark.parametrize("logscale", [True, False])
def test_snake_beta_matches_jax(logscale):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 40, 5)).astype(np.float32)
    alpha, beta = rng.uniform(0.2, 1.5, (2, 5)).astype(np.float32)
    want = np.asarray(JB._snake_beta(jnp.asarray(x), jnp.asarray(alpha), jnp.asarray(beta),
                                     logscale))
    got = TB.snake_beta(_t(x).transpose(1, 2), _t(alpha), _t(beta), logscale).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_activation_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 33, 8)).astype(np.float32)
    act = TB.Activation1d(8)
    with torch.no_grad():
        act.act.alpha.copy_(_t(0.3 * rng.standard_normal(8).astype(np.float32)))
        act.act.beta.copy_(_t(0.3 * rng.standard_normal(8).astype(np.float32)))
    want = np.asarray(JB.activation1d(jnp.asarray(x), jnp.asarray(act.act.alpha.detach().numpy()),
                                      jnp.asarray(act.act.beta.detach().numpy()), True))
    with torch.no_grad():
        got = act(_t(x).transpose(1, 2)).transpose(1, 2).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("stride,k", [(4, 8), (2, 4)])
def test_conv_transpose_matches_jax(stride, k):
    """The upsample stage: n * stride samples out; atol 1e-4 over 16-in sums."""
    params, voc = carried(seed=1)
    i = 0 if stride == 4 else 1
    up = voc.ups[i][0]
    x = np.random.default_rng(5).standard_normal((2, 12, up.in_channels)).astype(np.float32)
    want = np.asarray(JB.conv_transpose1d(params["ups"][i], jnp.asarray(x), stride, k))
    with torch.no_grad():
        got = up(_t(x).transpose(1, 2)).transpose(1, 2).numpy()
    assert got.shape == want.shape == (2, 12 * stride, up.out_channels)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("j", [0, 1])
def test_amp_block_matches_jax(j):
    params, voc = carried(seed=2)
    cfg = _jax_cfg()
    ch = voc.resblocks[j].convs1[0].in_channels
    x = np.random.default_rng(6).standard_normal((1, 50, ch)).astype(np.float32)
    want = np.asarray(JB.amp_block(params["resblocks"][0][j], jnp.asarray(x),
                                   cfg.resblock_kernel_sizes[j], cfg.resblock_dilation_sizes[j],
                                   True))
    with torch.no_grad():
        got = voc.resblocks[j](_t(x).transpose(1, 2)).transpose(1, 2).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("n", [9, 40])
def test_decode_matches_jax(n):
    """[b, n, 100] -> [b, 8 n] (the narrow config's hop); the weights scaled
    so the waveform stays inside the clamp, where a difference would show."""
    params, voc = carried(seed=3, scale=0.5)
    mel = np.random.default_rng(7).standard_normal((2, n, 100)).astype(np.float32) - 3.0
    want = np.asarray(JB.decode(params, jnp.asarray(mel), _jax_cfg()))
    got = TB.decode(voc, _t(mel)).numpy()
    assert got.shape == want.shape == (2, n * 8)
    assert 0.05 < np.abs(want).max() < 1.0  # not clamped, not silent
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_loader_fuses_weight_norm_like_jax():
    """Every fused conv weight (g v / |v| over all axes but the first, also
    for the transposed convs' [in, out, k]) equals JAX's, through
    ``bigvgan_state_from_jax_params`` and back; the release's filter buffers
    are ignored; a missing key raises."""
    cfg = _port_cfg()
    state = weight_normed_state(cfg, seed=8)
    params = bigvgan_params_from_state(state, _jax_cfg())
    voc = TK.load_bigvgan_state(TB.BigVGAN(cfg), state)
    back = TK.bigvgan_state_from_jax_params(params, cfg)
    own = voc.state_dict()
    assert set(back) == set(own)
    for k, v in own.items():
        np.testing.assert_allclose(v.numpy(), back[k], rtol=1e-6, atol=1e-7, err_msg=k)
    del state["resblocks.1.convs2.2.weight_v"]
    with pytest.raises(KeyError):
        TK.load_bigvgan_state(TB.BigVGAN(cfg), state)


@pytest.mark.parametrize("suffix", [".pt", ".safetensors"])
def test_release_file_layout_loads(tmp_path, suffix):
    """BigVGAN's own ``bigvgan_generator.pt`` keeps the state dict under
    ``"generator"``; ``load_torch_state`` unwraps it (a ``.safetensors``
    file holds the bare dict)."""
    cfg = _port_cfg()
    state = {k: torch.from_numpy(v) for k, v in weight_normed_state(cfg, seed=9).items()}
    path = str(tmp_path / f"bigvgan_generator{suffix}")
    if suffix == ".pt":
        torch.save({"generator": state}, path)
    else:
        from safetensors.torch import save_file

        save_file({k: v.contiguous() for k, v in state.items()}, path)
    voc = TK.load_bigvgan_state(TB.BigVGAN(cfg), TK.load_torch_state(path, use_ema=False))
    ref = TK.load_bigvgan_state(TB.BigVGAN(cfg), state)
    for k, v in ref.state_dict().items():
        assert torch.equal(voc.state_dict()[k], v), k


def test_published_widths():
    """The default config is the 24 kHz, 100-band, 256x release: its
    parameter count, from the shapes alone (no weights are built)."""
    cfg = TB.BigVGANConfig()
    with torch.device("meta"):
        voc = TB.BigVGAN(cfg)
    n = sum(p.numel() for p in voc.parameters())
    assert np.prod(cfg.upsample_rates) == 256 and 110e6 < n < 115e6, n
    assert len(TB.activations(voc)) == 109
