"""Rotary position embeddings (interleaved layout) and the [cos || sin]
absolute table of the text encoder.

JAX counterpart: ``f5_tts_tpu/ops/rope.py``.  The rotary table is
INTERLEAVED ([f0, f0, f1, f1, ...]) and rotates pairs (x0, x1) -> (-x1, x0)
(x_transformers layout), not NeoX halves.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=16)
def rotary_freqs(max_len: int, dim: int, theta: float = 10000.0) -> np.ndarray:
    """Interleaved rotary angle table [max_len, dim]: [f0, f0, f1, f1, ...]."""
    inv_freq = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    freqs = np.outer(np.arange(max_len, dtype=np.float64), inv_freq)  # [n, dim/2]
    return np.repeat(freqs, 2, axis=-1).astype(np.float32)  # [n, dim]


def rotate_half_interleaved(x: torch.Tensor) -> torch.Tensor:
    """(x0, x1, x2, x3, ...) -> (-x1, x0, -x3, x2, ...) over the last axis."""
    x2 = x.reshape(*x.shape[:-1], x.shape[-1] // 2, 2)
    a, b = x2[..., 0], x2[..., 1]
    return torch.stack((-b, a), dim=-1).reshape(x.shape)


def apply_rotary(t: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """t: [..., n, d]; freqs: [n, d] interleaved angles (fp32)."""
    cos = torch.cos(freqs).to(t.dtype)
    sin = torch.sin(freqs).to(t.dtype)
    return t * cos + rotate_half_interleaved(t) * sin


@functools.lru_cache(maxsize=16)
def abs_pos_table(max_len: int, dim: int, theta: float = 10000.0) -> np.ndarray:
    """[cos || sin] absolute position table [max_len, dim]."""
    inv_freq = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64)[: dim // 2] / dim))
    freqs = np.outer(np.arange(max_len, dtype=np.float64), inv_freq)
    return np.concatenate([np.cos(freqs), np.sin(freqs)], axis=-1).astype(np.float32)
