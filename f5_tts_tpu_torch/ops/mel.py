"""Log-mel spectrogram extraction: the Vocos and the BigVGAN front ends.

JAX counterpart: ``f5_tts_tpu/ops/mel.py`` (the mel scales and
``mel_filterbank`` :26-87, ``MelConfig`` :90-108, ``_fbank_for`` :111-118,
``log_mel_prepadded`` :137-162, ``log_mel_np`` :165-186, ``stft_pad_amount``
and ``num_frames`` :189-197).  Both match the reference exactly
(src/f5_tts/model/modules.py:35-151):

- ``vocos``: torchaudio's MelSpectrogram(power=1, center=True, norm=None,
  mel_scale="htk"), then clamp(1e-5).log();
- ``bigvgan``: librosa's slaney-scale, slaney-norm filterbank over a
  non-centered STFT with a manual (n_fft - hop)//2 reflect pad, magnitude
  sqrt(re^2 + im^2 + 1e-9), then clamp(1e-5).log().

The STFT is the matmul formulation of ``ops/stft.py``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from f5_tts_tpu_torch.ops.stft import (STFTConfig, _padded_window, dft_matrices, frame_signal,
                                       stft_basis)

MEL_SPEC_TYPES = ("vocos", "bigvgan")


def _hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def _mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


_F_SP = 200.0 / 3.0  # slaney: linear below 1 kHz, logarithmic above
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def _hz_to_mel_slaney(f):
    f = np.asarray(f, dtype=np.float64)
    return np.where(f >= _MIN_LOG_HZ,
                    _MIN_LOG_MEL + np.log(np.maximum(f, 1e-10) / _MIN_LOG_HZ) / _LOGSTEP,
                    f / _F_SP)


def _mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    return np.where(m >= _MIN_LOG_MEL, _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL)),
                    m * _F_SP)


def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int, f_min: float = 0.0,
                   f_max: float | None = None, mel_scale: str = "htk",
                   norm: str | None = None) -> np.ndarray:
    """Triangular mel filterbank [n_freqs, n_mels] fp32.  ``mel_scale="htk"``,
    ``norm=None``: torchaudio ``melscale_fbanks`` defaults (Vocos);
    ``"slaney"`` / ``"slaney"``: librosa ``filters.mel`` defaults (BigVGAN)."""
    if f_max is None:
        f_max = sample_rate / 2.0
    n_freqs = n_fft // 2 + 1
    all_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    hz2mel, mel2hz = ((_hz_to_mel_htk, _mel_to_hz_htk) if mel_scale == "htk"
                      else (_hz_to_mel_slaney, _mel_to_hz_slaney))
    f_pts = mel2hz(np.linspace(hz2mel(f_min), hz2mel(f_max), n_mels + 2))
    f_diff = np.diff(f_pts)
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[None, :-1]
    up = slopes[:, 2:] / f_diff[None, 1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    if norm == "slaney":
        fb = fb * (2.0 / (f_pts[2:] - f_pts[:-2]))[None, :]
    return fb.astype(np.float32)


@dataclass(frozen=True)
class MelConfig:
    """Defaults = the reference MelSpec defaults."""

    n_fft: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    n_mel_channels: int = 100
    target_sample_rate: int = 24_000
    mel_spec_type: str = "vocos"  # "vocos" | "bigvgan"

    def __post_init__(self):
        if self.mel_spec_type not in MEL_SPEC_TYPES:
            raise ValueError(f"mel_spec_type must be one of {MEL_SPEC_TYPES}, "
                             f"got {self.mel_spec_type!r}")

    @property
    def stft(self) -> STFTConfig:
        return STFTConfig(n_fft=self.n_fft, hop_length=self.hop_length,
                          win_length=self.win_length, center=self.mel_spec_type == "vocos")

    @property
    def eps(self) -> float:
        """Added under the magnitude's sqrt (BigVGAN's 1e-9, modules.py:72)."""
        return 0.0 if self.mel_spec_type == "vocos" else 1e-9


@functools.lru_cache(maxsize=None)
def _fbank_np(cfg: MelConfig) -> np.ndarray:
    scale = "htk" if cfg.mel_spec_type == "vocos" else "slaney"
    return mel_filterbank(cfg.target_sample_rate, cfg.n_fft, cfg.n_mel_channels,
                          mel_scale=scale, norm=None if scale == "htk" else "slaney")


@functools.lru_cache(maxsize=None)  # CUDA graphs read these by address: never evicted
def _fbank(cfg: MelConfig, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    return torch.as_tensor(_fbank_np(cfg), device=device, dtype=dtype)


def log_mel_prepadded(wav_padded: torch.Tensor, cfg: MelConfig = MelConfig()) -> torch.Tensor:
    """[b, S] -> [b, n_frames, n_mels] log-mel of a waveform the host already
    reflect-padded by ``stft_pad_amount`` and zero-extended to a bucket
    length; the first ``num_frames(true_len)`` frames equal the log-mel of
    the true-length waveform."""
    if wav_padded.ndim == 1:
        wav_padded = wav_padded[None]
    s = cfg.stft
    cos_m, sin_m = stft_basis(s.n_fft, s.win_length, wav_padded.device, wav_padded.dtype)
    frames = frame_signal(wav_padded, s.n_fft, s.hop_length)
    re = frames @ cos_m
    im = -(frames @ sin_m)
    mag = torch.sqrt(re * re + im * im + cfg.eps)
    mel = mag @ _fbank(cfg, wav_padded.device, wav_padded.dtype)
    return torch.log(torch.clamp(mel, min=1e-5))


def log_mel_np(wav: np.ndarray, cfg: MelConfig = MelConfig()) -> np.ndarray:
    """Host-side numpy log-mel [b, n_frames, n_mels] of a (batch of)
    waveform(s), reflect-padded as the config's STFT pads: the dataset's mel
    for raw-audio rows (same math as ``log_mel_prepadded``)."""
    if wav.ndim == 1:
        wav = wav[None]
    s = cfg.stft
    x = np.pad(wav, ((0, 0), (s.pad, s.pad)), mode="reflect")
    n_frames = 1 + (x.shape[-1] - s.n_fft) // s.hop_length
    idx = np.arange(n_frames)[:, None] * s.hop_length + np.arange(s.n_fft)[None, :]
    frames = x[:, idx]
    cos_m, sin_m = dft_matrices(s.n_fft, _padded_window(s.n_fft, s.win_length))
    re = frames @ cos_m
    im = -(frames @ sin_m)
    mel = np.sqrt(re * re + im * im + cfg.eps) @ _fbank_np(cfg)
    return np.log(np.clip(mel, 1e-5, None)).astype(np.float32)


def stft_pad_amount(cfg: MelConfig = MelConfig()) -> int:
    """Host-side reflect-pad amount matching this config's centering."""
    return cfg.stft.pad


def num_frames(num_samples: int, cfg: MelConfig = MelConfig()) -> int:
    """Frame count of the STFT of ``num_samples`` samples."""
    return 1 + (num_samples + 2 * stft_pad_amount(cfg) - cfg.n_fft) // cfg.hop_length
