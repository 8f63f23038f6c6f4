"""Log-mel spectrogram extraction (the Vocos front end).

JAX counterpart: ``f5_tts_tpu/ops/mel.py`` (``MelConfig`` :90-108,
``log_mel_prepadded`` :137-162, ``log_mel_np`` :165-186, ``stft_pad_amount``,
``num_frames``).  The
Vocos mel is torchaudio's MelSpectrogram(power=1, center=True, norm=None,
mel_scale="htk") then clamp(1e-5).log(): an htk filterbank built in numpy
over the matmul STFT of ``ops/stft.py``.  The BigVGAN (slaney, uncentered)
front end comes with the BigVGAN vocoder; ``MelConfig`` rejects it until
then.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from f5_tts_tpu_torch.ops.stft import (STFTConfig, _padded_window, dft_matrices, frame_signal,
                                       stft_basis)


def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int) -> np.ndarray:
    """Triangular htk mel filterbank [n_freqs, n_mels], no norm
    (torchaudio ``melscale_fbanks`` defaults)."""
    n_freqs = n_fft // 2 + 1
    all_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    m_max = 2595.0 * np.log10(1.0 + (sample_rate / 2.0) / 700.0)
    f_pts = 700.0 * (10.0 ** (np.linspace(0.0, m_max, n_mels + 2) / 2595.0) - 1.0)
    f_diff = np.diff(f_pts)
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[None, :-1]
    up = slopes[:, 2:] / f_diff[None, 1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


@dataclass(frozen=True)
class MelConfig:
    """Defaults = the reference MelSpec defaults."""

    n_fft: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    n_mel_channels: int = 100
    target_sample_rate: int = 24_000
    mel_spec_type: str = "vocos"

    def __post_init__(self):
        if self.mel_spec_type != "vocos":
            raise NotImplementedError(f"the {self.mel_spec_type} mel front end is not ported "
                                      "yet; see ROADMAP.md")

    @property
    def stft(self) -> STFTConfig:
        return STFTConfig(n_fft=self.n_fft, hop_length=self.hop_length,
                          win_length=self.win_length)


@functools.lru_cache(maxsize=None)  # CUDA graphs read these by address: never evicted
def _fbank(cfg: MelConfig, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    fb = mel_filterbank(cfg.target_sample_rate, cfg.n_fft, cfg.n_mel_channels)
    return torch.as_tensor(fb, device=device, dtype=dtype)


def log_mel_prepadded(wav_padded: torch.Tensor, cfg: MelConfig = MelConfig()) -> torch.Tensor:
    """[b, S] -> [b, n_frames, n_mels] log-mel of a waveform the host already
    reflect-padded by ``stft_pad_amount`` and zero-extended to a bucket
    length; the first ``num_frames(true_len)`` frames equal the centered
    log-mel of the true-length waveform."""
    if wav_padded.ndim == 1:
        wav_padded = wav_padded[None]
    s = cfg.stft
    cos_m, sin_m = stft_basis(s.n_fft, s.win_length, wav_padded.device, wav_padded.dtype)
    frames = frame_signal(wav_padded, s.n_fft, s.hop_length)
    re = frames @ cos_m
    im = -(frames @ sin_m)
    mel = torch.sqrt(re * re + im * im) @ _fbank(cfg, wav_padded.device, wav_padded.dtype)
    return torch.log(torch.clamp(mel, min=1e-5))


def log_mel_np(wav: np.ndarray, cfg: MelConfig = MelConfig()) -> np.ndarray:
    """Host-side numpy log-mel [b, n_frames, n_mels] of a (batch of)
    waveform(s), centered STFT with reflect padding: the dataset's mel for
    raw-audio rows (same math as ``log_mel_prepadded``)."""
    if wav.ndim == 1:
        wav = wav[None]
    s = cfg.stft
    pad = stft_pad_amount(cfg)
    x = np.pad(wav, ((0, 0), (pad, pad)), mode="reflect")
    n_frames = 1 + (x.shape[-1] - s.n_fft) // s.hop_length
    idx = np.arange(n_frames)[:, None] * s.hop_length + np.arange(s.n_fft)[None, :]
    frames = x[:, idx]
    cos_m, sin_m = dft_matrices(s.n_fft, _padded_window(s.n_fft, s.win_length))
    re = frames @ cos_m
    im = -(frames @ sin_m)
    mel = np.sqrt(re * re + im * im) @ mel_filterbank(cfg.target_sample_rate, s.n_fft,
                                                      cfg.n_mel_channels)
    return np.log(np.clip(mel, 1e-5, None)).astype(np.float32)


def stft_pad_amount(cfg: MelConfig = MelConfig()) -> int:
    """Host-side reflect-pad amount of the centered STFT."""
    return cfg.n_fft // 2


def num_frames(num_samples: int, cfg: MelConfig = MelConfig()) -> int:
    """Frame count of the centered STFT of ``num_samples`` samples."""
    return 1 + num_samples // cfg.hop_length
