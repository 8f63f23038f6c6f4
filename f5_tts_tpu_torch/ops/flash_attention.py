"""Masked flash attention (forward): the CUDA kernel and its plain version.

JAX counterpart: ``f5_tts_tpu/ops/flash_attention.py::_kernel`` (:150-191),
called through ``_flash`` (:195-229) and ``flash_attention`` (:543-556).
The kernel is ``csrc/flash_attention.cu``; its header says what bounds it on
the H100 and how its blocking departs from the TPU kernel's.

Semantics: non-causal attention over q, k, v [b, h, n, 64]; key columns are
valid only in [0, lens[b]); a query row with no valid key gives 0.  The
kernel takes bf16 (the serving dtype) or fp32 tensors and, like the TPU
kernel, rounds q (prescaled by scale*log2 e), k, v and the probabilities to
bf16 for its tensor-core products, accumulating in fp32.

Dispatch is by device: a CPU tensor runs ``flash_attention_plain``; a CUDA
tensor launches the kernel, and anything the kernel does not take raises.
There is no length gate: any n works.
"""

from __future__ import annotations

import ctypes

import torch

from f5_tts_tpu_torch.ops.cuda_build import CudaKernel

LOG2E = 1.4426950408889634
HEAD_DIM = 64  # the kernel's head width (every F5-TTS config)

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = CudaKernel(
    "flash_attention_fwd", "flash_attention.cu",
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _P],
)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          lens: torch.Tensor) -> torch.Tensor:
    """Exact fp32 attention with the kernel's key mask and zero-row rule."""
    n = q.shape[2]
    scale = q.shape[-1] ** -0.5
    qf, kf, vf = q.float(), k.float(), v.float()
    s = (qf @ kf.transpose(-1, -2)) * scale
    valid = torch.arange(n, device=q.device)[None, :] < lens.to(q.device)[:, None]  # [b, n]
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))  # rows with no valid key
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    return ((p @ vf) / torch.clamp(l, min=1e-30)).to(q.dtype)


def _check(q, k, v, lens):
    if not (q.shape == k.shape == v.shape) or q.ndim != 4:
        raise ValueError(f"q, k, v must share one [b, h, n, dh] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, n, dh = q.shape
    if dh != HEAD_DIM:
        raise ValueError(f"flash_attention kernel takes head dim {HEAD_DIM}, got {dh}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes fp32 or bf16 q/k/v of one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention kernel needs a contiguous, 16-byte aligned {name}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if lens.shape != (b,) or lens.dtype != torch.int32 or lens.device != q.device:
        raise ValueError(f"lens must be int32 [{b}] on {q.device}, got "
                         f"{lens.dtype} {tuple(lens.shape)} on {lens.device}")
    if b * h > 65535:
        raise ValueError(f"b*h = {b * h} exceeds the kernel grid's 65535")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lens: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream."""
    _check(q, k, v, lens)
    b, h, n, dh = q.shape
    out = torch.empty_like(q)
    if n == 0 or b == 0 or h == 0:
        return out
    qscale = float(dh) ** -0.5 * LOG2E
    stream = torch.cuda.current_stream(q.device).cuda_stream
    KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), out.data_ptr(),
                  b, h, n, dh, _DTYPE_CODE[q.dtype], qscale, stream)
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    lens: torch.Tensor) -> torch.Tensor:
    """Device dispatch: plain version for CPU tensors, the kernel for CUDA."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, lens)
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, lens)
    raise ValueError(f"flash_attention: no implementation for device {q.device}")

