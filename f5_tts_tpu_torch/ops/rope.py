"""Rotary position embeddings (interleaved layout), the [cos || sin]
absolute table of the text encoder, and the serving kernel from the fused
qkv projection to rotated, head-major q, k, v.

JAX counterpart: ``f5_tts_tpu/ops/rope.py``.  The rotary table is
INTERLEAVED ([f0, f0, f1, f1, ...]) and rotates pairs (x0, x1) -> (-x1, x0)
(x_transformers layout), not NeoX halves.

``rope_qkv`` takes the fused projection's output qkv [b, n, 3 h 64] and
returns q, k, v, each [b, h, n, 64] and contiguous: q and k rotated on
their first ``rot_heads`` heads, v as it is.  It is a dispatcher op: for a
CPU tensor the plain composition that ``models/layers.py`` ``mha`` runs
without it (``rope_qkv_plain``: ``head_major`` and ``rotate_heads``, which
``mha`` shares, so bitwise), for a CUDA tensor the kernel
``csrc/rope_qkv.cu``, and a fake implementation for ``torch.export``.  It
reads bf16 cos and sin tables (``cos_sin_tables``), made once per rope
table, which the backbones slice and pass down beside the angles.  It
replaces no TPU kernel: XLA fuses this glue on the TPU, and eager PyTorch
ran it as some 19 launches of strided and broadcast elementwise kernels.
The kernel rounds once, where the plain composition rounds each product
and the sum to bf16 (``rope_qkv_cuda``).  ``rope_qkv_takes`` is the half
of ``mha``'s gate that reads the op's input.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from f5_tts_tpu_torch.ops.cuda_build import CudaKernel
from f5_tts_tpu_torch.ops.cuda_build import no_meta as _no_meta
from f5_tts_tpu_torch.ops.flash_attention import HEAD_DIM  # the width both kernels take


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


def rotate(t: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """t: [..., n, d]; cos, sin: [n, d] in t's dtype."""
    return t * cos + rotate_half_interleaved(t) * sin


def apply_rotary(t: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """t: [..., n, d]; freqs: [n, d] interleaved angles (fp32)."""
    return rotate(t, torch.cos(freqs).to(t.dtype), torch.sin(freqs).to(t.dtype))


@functools.lru_cache(maxsize=16)
def abs_pos_table(max_len: int, dim: int, theta: float = 10000.0) -> np.ndarray:
    """[cos || sin] absolute position table [max_len, dim]."""
    inv_freq = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64)[: dim // 2] / dim))
    freqs = np.outer(np.arange(max_len, dtype=np.float64), inv_freq)
    return np.concatenate([np.cos(freqs), np.sin(freqs)], axis=-1).astype(np.float32)


@functools.lru_cache(maxsize=None)  # CUDA graphs read these by address: never evicted
def device_table(kind: str, max_len: int, dim: int, device: torch.device) -> torch.Tensor:
    """``rotary_freqs`` (kind "rope") or ``abs_pos_table`` (kind "abs") as an
    fp32 tensor on ``device``, built once per (kind, length, dim, device)."""
    fn = rotary_freqs if kind == "rope" else abs_pos_table
    return torch.as_tensor(fn(max_len, dim), device=device)


@functools.lru_cache(maxsize=None)  # CUDA graphs read these by address: never evicted
def cos_sin_tables(max_len: int, dim: int, device: torch.device,
                   dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """The cosine and sine of ``device_table("rope", max_len, dim, device)``
    rounded to ``dtype``, as ``apply_rotary`` rounds them: the tables
    ``rope_qkv`` reads.  The backbones slice rows [0, n) of both beside
    the angle table's."""
    freqs = device_table("rope", max_len, dim, device)
    return torch.cos(freqs).to(dtype), torch.sin(freqs).to(dtype)


def head_major(t: torch.Tensor, heads: int) -> torch.Tensor:
    """[b, n, h d] -> a [b, h, n, d] view."""
    b, n, _ = t.shape
    return t.reshape(b, n, heads, -1).transpose(1, 2)


def rotate_heads(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                 rot_heads: int) -> tuple[torch.Tensor, torch.Tensor]:
    """q, k [b, h, n, d] with their first ``rot_heads`` heads rotated in
    their dtype (three roundings): every head (``pe_attn_head`` None), or
    the leading ones."""
    if rot_heads == q.shape[1]:
        return rotate(q, cos, sin), rotate(k, cos, sin)
    if rot_heads == 0:
        return q, k
    return (torch.cat([rotate(q[:, :rot_heads], cos, sin), q[:, rot_heads:]], dim=1),
            torch.cat([rotate(k[:, :rot_heads], cos, sin), k[:, rot_heads:]], dim=1))


# ---------------------------------------------------------------------------
# qkv -> rotated, head-major q, k, v


def rope_qkv_takes(qkv: torch.Tensor, heads: int, backend) -> bool:
    """Whether ``mha`` sends the fused projection's output ``qkv`` to
    ``rope_qkv``, as far as the output shows it: a bf16 CUDA tensor, 64-wide
    heads, q, k, v going on to kernel A (``backend`` "auto" or "flash"),
    and no gradient to carry.  The caller checks the rest (no tensor
    parallelism, no qk-norm, the rotary tables given)."""
    return (qkv.is_cuda and qkv.dtype == torch.bfloat16 and qkv.ndim == 3
            and qkv.shape[-1] == 3 * heads * HEAD_DIM
            and backend in ("auto", "flash")
            and not (torch.is_grad_enabled() and qkv.requires_grad))


def rope_qkv_plain(qkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, heads: int,
                   rot_heads: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The composition ``mha`` runs without the op: chunk, ``head_major``,
    ``rotate_heads``, then contiguous."""
    q, k, v = (head_major(t, heads) for t in qkv.chunk(3, dim=-1))
    q, k = rotate_heads(q, k, cos, sin, rot_heads)
    return q.contiguous(), k.contiguous(), v.contiguous()


KERNEL = CudaKernel(  # (qkv, cos, sin, q, k, v, b, n, heads, rot_heads, stream)
    "rope_qkv", "rope_qkv.cu",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
)


def rope_qkv_cuda(qkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, heads: int,
                  rot_heads: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the kernel on PyTorch's current stream.  Each output element
    is ``t cos + rotate_half_interleaved(t) sin`` taken in fp32 (the
    products of bf16 values are exact there) and rounded to bf16 once."""
    if qkv.ndim != 3 or qkv.dtype != torch.bfloat16 or not qkv.is_cuda:
        raise TypeError(f"rope_qkv kernel takes a bf16 CUDA qkv [b, n, 3 h {HEAD_DIM}], got "
                        f"{qkv.dtype} {tuple(qkv.shape)} on {qkv.device}")
    b, n, width = qkv.shape
    if width != 3 * heads * HEAD_DIM or not 0 <= rot_heads <= heads:
        raise ValueError(f"rope_qkv kernel takes {HEAD_DIM}-wide heads: qkv width {width}, "
                         f"heads {heads}, rot_heads {rot_heads}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("rope_qkv kernel needs a contiguous, 16-byte aligned qkv")
    for name, t in (("cos", cos), ("sin", sin)):
        if (tuple(t.shape) != (n, HEAD_DIM) or t.dtype != torch.bfloat16
                or t.device != qkv.device or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name} must be a contiguous bf16 [{n}, {HEAD_DIM}] on {qkv.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if qkv.numel() // 8 >= 2 ** 31:
        raise ValueError(f"rope_qkv kernel takes fewer than 2^34 elements, got {qkv.numel()}")
    out = [qkv.new_empty((b, heads, n, HEAD_DIM)) for _ in range(3)]
    if b and n and heads:
        KERNEL.launch(qkv.data_ptr(), cos.data_ptr(), sin.data_ptr(),
                      *(o.data_ptr() for o in out), b, n, heads, rot_heads,
                      torch.cuda.current_stream(qkv.device).cuda_stream)
    return tuple(out)


@torch.library.custom_op("f5_tts_tpu_torch::rope_qkv", mutates_args=(), device_types="cpu")
def rope_qkv(qkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, heads: int,
             rot_heads: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """qkv [b, n, 3 h d] -> q, k, v [b, h, n, d], q and k rotated on their
    first ``rot_heads`` heads by the tables ``cos``, ``sin`` [n, d] in
    qkv's dtype (``cos_sin_tables``'s rows).  A dispatcher op: the plain
    composition is its CPU implementation, the kernel its CUDA one, and any
    other device has none and raises.  ``torch.export`` keeps it as one
    opaque node."""
    return rope_qkv_plain(qkv, cos, sin, heads, rot_heads)


@rope_qkv.register_kernel("cuda")
def _(qkv, cos, sin, heads, rot_heads):
    return rope_qkv_cuda(qkv, cos, sin, heads, rot_heads)


@rope_qkv.register_fake
def _(qkv, cos, sin, heads, rot_heads):
    _no_meta("rope_qkv", qkv)
    b, n, width = qkv.shape
    return tuple(qkv.new_empty((b, heads, n, width // (3 * heads))) for _ in range(3))

