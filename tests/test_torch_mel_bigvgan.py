"""The port's bigvgan mel front end (ops/mel.py: slaney filterbank,
non-centered STFT with a (n_fft - hop)//2 reflect pad, eps 1e-9 under the
magnitude) against the JAX package, over several clip lengths, fp32 on the
CPU; then the consumers that take a ``MelConfig``: the engine's ref mel
and the training dataset."""

import torch_threads  # noqa: F401  (first: caps torch's threads per test worker)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5_tts_tpu.ops import mel as JM
from f5_tts_tpu_torch.audio.io import load_wav
from f5_tts_tpu_torch.ops import mel as TM

JCFG = JM.MelConfig(mel_spec_type="bigvgan")
TCFG = TM.MelConfig(mel_spec_type="bigvgan")
# log-mel, fp32: the DFT sums in another order, and low-energy bins lose
# relative precision to cancellation before the log (tests/test_torch_ops.py)
ATOL, RTOL = 1e-5, 5e-5
LENGTHS = (256, 1000, 4095, 12_000)


def _clip(n: int) -> np.ndarray:
    wav, sr = load_wav("examples/assets/basic_ref_en.wav")
    return wav[sr // 4: sr // 4 + n].astype(np.float32)


@pytest.mark.parametrize("n", LENGTHS)
def test_pad_and_frame_counts_equal_jax(n):
    assert TM.stft_pad_amount(TCFG) == JM.stft_pad_amount(JCFG) == (1024 - 256) // 2
    assert TM.num_frames(n, TCFG) == JM.num_frames(n, JCFG)
    assert TM.num_frames(n, TCFG) == TM.log_mel_np(_clip(n), TCFG).shape[1]


@pytest.mark.parametrize("n", LENGTHS)
def test_log_mel_np_matches_jax(n):
    wav = _clip(n)
    got = TM.log_mel_np(wav, TCFG)
    want = JM.log_mel_np(wav, JCFG)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    # and JAX's device mel of the same clip
    np.testing.assert_allclose(got, np.asarray(JM.log_mel_spectrogram(jnp.asarray(wav[None]),
                                                                      JCFG)),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("n", LENGTHS)
def test_log_mel_prepadded_matches_jax(n):
    """Host reflect pad, then zeros to a bucket: the true-length prefix is
    the clip's mel."""
    wav = _clip(n)
    pad = TM.stft_pad_amount(TCFG)
    padded = np.pad(np.pad(wav, pad, mode="reflect"), (0, 3000))[None]
    got = TM.log_mel_prepadded(torch.from_numpy(padded), TCFG).numpy()
    want = np.asarray(JM.log_mel_prepadded(jnp.asarray(padded), JCFG))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    k = TM.num_frames(n, TCFG)
    np.testing.assert_allclose(got[:, :k], TM.log_mel_np(wav, TCFG), atol=ATOL, rtol=RTOL)


def test_engine_ref_mel_and_dataset_take_bigvgan_mels(tmp_path):
    """The engine's ref mel (bucketed, non-centered) and the dataset's mel
    of raw-audio rows equal JAX's ``log_mel_np`` of the clip."""
    import dataclasses

    from f5_tts_tpu_torch.audio.io import save_wav
    from f5_tts_tpu_torch.infer.engine import InferenceEngine
    from f5_tts_tpu_torch.models.cfm import CFM
    from f5_tts_tpu_torch.models.configs import MODEL_CONFIGS
    from f5_tts_tpu_torch.train.dataset import CustomDataset

    cfg = dataclasses.replace(MODEL_CONFIGS["F5TTS_Tiny"], mel=TCFG)
    eng = InferenceEngine(CFM(cfg.arch), cfg)
    assert eng.vocoder_type == "bigvgan"
    wav = _clip(9000)
    want = JM.log_mel_np(wav, JCFG)[0]
    np.testing.assert_allclose(eng.ref_mel(wav), want, atol=ATOL, rtol=RTOL)
    path = str(tmp_path / "clip.wav")
    save_wav(path, wav, 24_000)
    ds = CustomDataset([{"audio_path": path, "text": "hi", "duration": 9000 / 24_000}],
                       mel_cfg=TCFG)
    want = JM.log_mel_np(load_wav(path)[0], JCFG)[0]  # of the clip as written
    np.testing.assert_allclose(ds[0]["mel"], want, atol=ATOL, rtol=RTOL)
