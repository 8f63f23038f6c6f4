"""Roofline bounds of the port's kernels: a frozen copy of ``chip_smoke.py``'s
arithmetic.  A bound is max(operations / 989 TFLOP/s, bytes / 3.35 TB/s),
each input byte read once and each output byte written once, at the call's
shape and its rows' valid key counts.

- A (serving attention forward, ``ops/flash_attention.py``), q, k, v and o
  [b, h, n, dh] bf16: 4 h n kv dh per row with kv valid keys; 4 bf16
  tensors and the int32 lengths.
- B (``ops/fused_convpos.py``, two grouped k=31 convolutions over d
  channels in 64-channel groups): 2 * 2 k 64 d per valid frame; x and y
  [b, n, d] bf16, two weight tensors and biases, the lengths.
- C, D, E (training forward with the log-sum-exp, dq, dk/dv): 4, 6 and 8
  h n kv dh per row; C moves 4 bf16 tensors and an fp32 [b, h, n], D 5 and
  two, E 6 and two, plus the lengths.
"""

from __future__ import annotations

from types import SimpleNamespace

PEAK_BF16 = 989e12
HBM_BPS = 3.35e12


def bound_s(flops: float, nbytes: float, peak: float = PEAK_BF16) -> float:
    return max(flops / peak, nbytes / HBM_BPS)


def attention_fwd(b: int, h: int, n: int, dh: int, kvs) -> float:
    """Kernel A's bound (seconds) for one call; ``kvs``: each row's valid keys."""
    flops = sum(4.0 * h * n * kv * dh for kv in kvs)
    return bound_s(flops, 4.0 * b * h * n * dh * 2 + 4 * b)


def convpos(b: int, n: int, d: int, lens, k: int = 31) -> float:
    """Kernel B's bound for one call (``lens``: each row's valid frames)."""
    flops = sum(2 * 2.0 * k * 64 * d * ln for ln in lens)
    return bound_s(flops, 2.0 * b * n * d * 2 + 2 * (d * 64 * k + d) * 2 + 4 * b)


def train_attention(b: int, h: int, n: int, dh: int, kvs) -> SimpleNamespace:
    """Kernels C, D and E's bounds for one call each."""
    flops = {name: sum(c * h * n * kv * dh for kv in kvs) for name, c in
             (("C", 4.0), ("D", 6.0), ("E", 8.0))}
    t16, t32 = b * h * n * dh * 2.0, b * h * n * 4.0
    nbytes = {"C": 4 * t16 + t32, "D": 5 * t16 + 2 * t32, "E": 6 * t16 + 2 * t32}
    return SimpleNamespace(**{k: bound_s(flops[k], nbytes[k] + 4 * b) for k in flops})
