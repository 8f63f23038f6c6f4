"""Port ops (rope, abs-pos, stft / istft, log-mel) against the JAX package.

Inputs come from numpy with a seed and go through both implementations in
fp32 on the CPU.  Tolerance atol 1e-5: the same fp32 formulas, differing
only in summation order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5_tts_tpu.ops import mel as JM
from f5_tts_tpu.ops import rope as JR
from f5_tts_tpu.ops import stft as JS
from f5_tts_tpu_torch.audio.io import load_wav
from f5_tts_tpu_torch.ops import mel as TM
from f5_tts_tpu_torch.ops import rope as TR
from f5_tts_tpu_torch.ops import stft as TS

ATOL = 1e-5
RNG = np.random.default_rng(21)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_rope_tables_and_apply_match_jax():
    np.testing.assert_array_equal(TR.rotary_freqs(256, 64), JR.rotary_freqs(256, 64))
    np.testing.assert_array_equal(TR.abs_pos_table(256, 32), JR.abs_pos_table(256, 32))
    x = RNG.standard_normal((2, 4, 256, 64)).astype(np.float32)
    f = TR.rotary_freqs(256, 64)
    got = TR.apply_rotary(_t(x), _t(f)).numpy()
    want = np.asarray(JR.apply_rotary(jnp.asarray(x), jnp.asarray(f)))
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_rotate_half_is_interleaved():
    x = torch.arange(6.0).reshape(1, 6)
    assert TR.rotate_half_interleaved(x).tolist() == [[-1.0, 0.0, -3.0, 2.0, -5.0, 4.0]]


@pytest.mark.parametrize("win_length", [512, 400])
def test_stft_bases_and_framing_match_jax(win_length):
    """The port's DFT bases over its framing give JAX's stft_magnitude
    (a window shorter than n_fft is zero-padded symmetrically, as torch's)."""
    x = RNG.standard_normal((2, 4000)).astype(np.float32)
    padded = np.pad(x, ((0, 0), (256, 256)), mode="reflect")
    cos_m, sin_m = TS.stft_basis(512, win_length, torch.device("cpu"), torch.float32)
    frames = TS.frame_signal(_t(padded), 512, 128)
    got = torch.sqrt((frames @ cos_m) ** 2 + (frames @ sin_m) ** 2).numpy()
    cfg_j = JS.STFTConfig(n_fft=512, hop_length=128, win_length=win_length, center=True)
    want = np.asarray(JS.stft_magnitude(jnp.asarray(x), cfg_j))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)  # magnitudes up to ~60


def test_log_mel_prepadded_on_example_wav_matches_jax():
    wav, sr = load_wav("examples/assets/basic_ref_en.wav")
    wav = wav[: sr // 2]
    cfg_t, cfg_j = TM.MelConfig(), JM.MelConfig()
    pad = TM.stft_pad_amount(cfg_t)
    assert pad == JM.stft_pad_amount(cfg_j)
    n_ref = TM.num_frames(len(wav), cfg_t)
    assert n_ref == JM.num_frames(len(wav), cfg_j)
    padded = np.pad(np.pad(wav, pad, mode="reflect"), (0, 3000))[None]
    got = TM.log_mel_prepadded(_t(padded), cfg_t).numpy()
    want = np.asarray(JM.log_mel_prepadded(jnp.asarray(padded), cfg_j))
    # rtol 5e-5: the fp32 DFT sums in another order, and low-energy bins
    # lose relative precision to cancellation before the log (values ~ -4)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=5e-5)
    # the true-length prefix equals the centered spectrogram of the clip
    exact = np.asarray(JM.log_mel_spectrogram(jnp.asarray(wav[None]), cfg_j))
    np.testing.assert_allclose(got[:, :n_ref], exact, atol=ATOL, rtol=5e-5)


def test_mel_filterbank_matches_jax_and_bigvgan_is_refused():
    np.testing.assert_allclose(TM.mel_filterbank(24000, 1024, 100),
                               JM.mel_filterbank(24000, 1024, 100), atol=1e-7)
    with pytest.raises(NotImplementedError, match="bigvgan"):
        TM.MelConfig(mel_spec_type="bigvgan")


@pytest.mark.parametrize("with_lens", [False, True])
def test_istft_matches_jax(with_lens):
    b, n, nf = 2, 24, 129
    re = RNG.standard_normal((b, n, nf)).astype(np.float32)
    im = RNG.standard_normal((b, n, nf)).astype(np.float32)
    cfg_t = TS.STFTConfig(n_fft=256, hop_length=64, win_length=256)
    cfg_j = JS.STFTConfig(n_fft=256, hop_length=64, win_length=256, center=True)
    lens = np.array([24, 15], np.int32) if with_lens else None
    got = TS.istft(_t(re), _t(im), cfg_t, frame_lens=None if lens is None else _t(lens)).numpy()
    want = np.asarray(JS.istft(jnp.asarray(re), jnp.asarray(im), cfg_j,
                               frame_lens=None if lens is None else jnp.asarray(lens)))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-5)


def test_istft_matches_torch_istft():
    b, n, nf = 1, 20, 129
    spec = (RNG.standard_normal((b, nf, n)) + 1j * RNG.standard_normal((b, nf, n))).astype(np.complex64)
    cfg = TS.STFTConfig(n_fft=256, hop_length=64, win_length=256)
    got = TS.istft(_t(spec.real.transpose(0, 2, 1).copy()), _t(spec.imag.transpose(0, 2, 1).copy()),
                   cfg).numpy()
    want = torch.istft(_t(spec), 256, 64, 256, torch.hann_window(256), center=True).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_istft_frame_lens_equals_exact_length_decode():
    """A padded batch with frame_lens decodes each row as its exact-length
    input would: padded frames are zeroed and left out of the envelope."""
    b, n, nf = 2, 30, 129
    re = RNG.standard_normal((b, n, nf)).astype(np.float32)
    im = RNG.standard_normal((b, n, nf)).astype(np.float32)
    cfg = TS.STFTConfig(n_fft=256, hop_length=64, win_length=256)
    lens = torch.tensor([30, 17])
    padded = TS.istft(_t(re), _t(im), cfg, frame_lens=lens).numpy()
    for i, ln in enumerate(lens.tolist()):
        exact = TS.istft(_t(re[i : i + 1, :ln]), _t(im[i : i + 1, :ln]), cfg).numpy()[0]
        np.testing.assert_allclose(padded[i, : len(exact)], exact, atol=ATOL)
        np.testing.assert_array_equal(padded[i, len(exact) + 128 :], 0.0)
