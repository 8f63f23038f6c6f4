"""STFT / ISTFT as matmuls against DFT bases.

JAX counterpart: ``f5_tts_tpu/ops/stft.py``.  Framing + windowed DFT is a
[frames, n_fft] x [n_fft, n_freq] product per (cos, sin) pair with the window
folded into the bases; the inverse is the transposed product followed by an
overlap-add.  ``istft`` matches ``torch.istft(center=True)``, and its
``frame_lens`` option (which ``torch.istft`` lacks) zeroes padded frames AND
leaves them out of the window envelope, so a bucket-padded batch decodes
exactly like each row's exact-length input.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann window, identical to ``torch.hann_window(win_length)``."""
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * n / win_length))).astype(np.float32)


def dft_matrices(n_fft: int, window: np.ndarray):
    """(cos_mat, sin_mat), each [n_fft, n_fft//2 + 1] fp32: ``re = f @ cos_mat``,
    ``im = -(f @ sin_mat)`` equals ``torch.fft.rfft(f * window)``."""
    k = np.arange(n_fft // 2 + 1, dtype=np.float64)
    n = np.arange(n_fft, dtype=np.float64)
    ang = 2.0 * np.pi * np.outer(n, k) / n_fft
    w = window.astype(np.float64)[:, None]
    return (np.cos(ang) * w).astype(np.float32), (np.sin(ang) * w).astype(np.float32)


def frame_signal(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """[b, T] -> [b, n_frames, n_fft] with n_frames = 1 + (T - n_fft)//hop."""
    return x.unfold(-1, n_fft, hop)


@dataclass(frozen=True)
class STFTConfig:
    """Centered (torch ``center=True``) STFT geometry."""

    n_fft: int = 1024
    hop_length: int = 256
    win_length: int = 1024


def _padded_window(n_fft: int, win_length: int) -> np.ndarray:
    w = hann_window(win_length)
    if win_length < n_fft:  # torch pads the window symmetrically to n_fft
        lp = (n_fft - win_length) // 2
        w = np.pad(w, (lp, n_fft - win_length - lp))
    return w


@functools.lru_cache(maxsize=16)
def stft_basis(n_fft: int, win_length: int, device: torch.device, dtype: torch.dtype):
    """Analysis bases (cos, sin) [n_fft, n_freq] as tensors on ``device``."""
    cos_m, sin_m = dft_matrices(n_fft, _padded_window(n_fft, win_length))
    return (torch.as_tensor(cos_m, device=device, dtype=dtype),
            torch.as_tensor(sin_m, device=device, dtype=dtype))


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """[b, n_frames, n_fft] -> [b, (n_frames-1)*hop + n_fft] overlap-add.

    Chunk j (of n_fft//hop hop-sized chunks) of frame t lands at output block
    t + j: a shift-and-sum with no scatter."""
    b, n_frames, n_fft = frames.shape
    out_len = (n_frames - 1) * hop + n_fft
    if n_fft % hop != 0:  # zero-pad each frame to the next hop multiple
        pad = hop - n_fft % hop
        frames = F.pad(frames, (0, pad))
        n_fft = n_fft + pad
    r = n_fft // hop
    chunks = frames.reshape(b, n_frames, r, hop)
    out = frames.new_zeros((b, n_frames + r - 1, hop))
    for j in range(r):
        out[:, j : j + n_frames] += chunks[:, :, j]
    return out.reshape(b, -1)[:, :out_len]


@functools.lru_cache(maxsize=16)
def istft_basis(n_fft: int, win_length: int, device: torch.device, dtype: torch.dtype):
    """Inverse rFFT bases (cos [n_freq, n_fft], sin [n_freq, n_fft]) with the
    synthesis window folded in, and the squared window [n_fft]."""
    n_freq = n_fft // 2 + 1
    k = np.arange(n_freq, dtype=np.float64)
    n = np.arange(n_fft, dtype=np.float64)
    ang = 2.0 * np.pi * np.outer(k, n) / n_fft
    # irfft(X)[n] = (1/N) sum_k w_k (re_k cos - im_k sin), w_k = 2 except DC/Nyquist
    scale = np.full((n_freq, 1), 2.0 / n_fft)
    scale[0] = 1.0 / n_fft
    if n_fft % 2 == 0:
        scale[-1] = 1.0 / n_fft
    w = _padded_window(n_fft, win_length).astype(np.float64)
    cos_b = np.cos(ang) * scale * w
    sin_b = -np.sin(ang) * scale * w
    return tuple(torch.as_tensor(a.astype(np.float32), device=device, dtype=dtype)
                 for a in (cos_b, sin_b, w * w))


def istft(re: torch.Tensor, im: torch.Tensor, cfg: STFTConfig,
          frame_lens: torch.Tensor | None = None) -> torch.Tensor:
    """Inverse STFT matching ``torch.istft(center=True)``.

    re/im: [b, n_frames, n_freq] -> waveform [b, (n_frames-1)*hop].  ``frame_lens`` ([b]
    int) keeps only the first N frames of each row: the rest are zeroed and
    excluded from the envelope normalization.
    """
    cos_b, sin_b, wsq = istft_basis(cfg.n_fft, cfg.win_length, re.device, re.dtype)
    frames = re @ cos_b + im @ sin_b
    n_frames = re.shape[1]
    if frame_lens is not None:
        valid = (torch.arange(n_frames, device=re.device)[None, :]
                 < frame_lens.to(re.device)[:, None]).to(re.dtype)
        frames = frames * valid[..., None]
        env = overlap_add(valid[..., None] * wsq[None, None, :], cfg.hop_length)
    else:
        env = overlap_add(wsq.expand(1, n_frames, cfg.n_fft), cfg.hop_length)
    y = overlap_add(frames, cfg.hop_length)
    y = y / torch.clamp(env, min=1e-11)
    half = cfg.n_fft // 2
    return y[:, half:-half]
