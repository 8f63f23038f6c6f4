"""Fused ConvPositionEmbedding (forward): the CUDA kernel and its plain version.

JAX counterpart: ``f5_tts_tpu/ops/fused_convpos.py::_kernel`` (:37-83),
called through ``_conv_pos_fused`` (:87-119) and ``conv_pos_fused``
(:168-173).  The kernel is ``csrc/fused_convpos.cu``; its header says what
bounds it on the H100 and how its blocking departs from the TPU kernel's.

The function: for x [b, n, d] and a prefix mask of lengths ``lens``,
``mask -> grouped conv1d(k=31, same, bias) -> Mish -> mask -> grouped
conv1d(k=31, bias) -> Mish -> mask``.  Weights arrive in torch's
[out, in/groups, k] layout.  The plain version is the unfused composition
(``f5_tts_tpu/models/layers.py`` ``conv_pos_embed_xla``, :197-209).

Dispatch is by device: a CPU tensor runs ``conv_pos_plain``; a CUDA tensor
launches the kernel, and a shape or dtype it does not take raises (the
kernel takes 64-channel groups, the F5-TTS width of 1024 / 16).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from f5_tts_tpu_torch.ops.cuda_build import CudaKernel

KSIZE = 31
GROUP_WIDTH = 64  # channels per group the kernel takes

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = CudaKernel(
    "fused_convpos_fwd", "fused_convpos.cu",
    [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


def _conv_same(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, groups: int) -> torch.Tensor:
    """[b, n, c] grouped conv with 'same' padding (odd k), bias in x's dtype."""
    k = w.shape[-1]
    y = F.conv1d(x.transpose(1, 2), w.to(x.dtype), None, padding=(k - 1) // 2, groups=groups)
    return y.transpose(1, 2) + b.to(x.dtype)


def conv_pos_plain(x, w1, b1, w2, b2, lens, groups: int) -> torch.Tensor:
    """The unfused composition, in x's dtype."""
    n = x.shape[1]
    m = (torch.arange(n, device=x.device)[None, :] < lens.to(x.device)[:, None])
    m = m[..., None].to(x.dtype)
    h = x * m
    h = mish(_conv_same(h, w1, b1, groups)) * m
    return mish(_conv_same(h, w2, b2, groups)) * m


def tap_major(w: torch.Tensor, groups: int) -> torch.Tensor:
    """torch [out, in/g, k] -> the kernel's [groups][k][c_in][c_out]."""
    d, dg, k = w.shape
    return w.reshape(groups, d // groups, dg, k).permute(0, 3, 2, 1).contiguous()


def conv_pos_cuda(x, w1, b1, w2, b2, lens, groups: int) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream."""
    if x.ndim != 3:
        raise ValueError(f"x must be [b, n, d], got {tuple(x.shape)}")
    b, n, d = x.shape
    if groups <= 0 or d != groups * GROUP_WIDTH:
        raise ValueError(f"fused_convpos kernel takes {GROUP_WIDTH}-channel groups, "
                         f"got d={d}, groups={groups}")
    for name, w in (("w1", w1), ("w2", w2)):
        if tuple(w.shape) != (d, GROUP_WIDTH, KSIZE):
            raise ValueError(f"{name} must be [{d}, {GROUP_WIDTH}, {KSIZE}], got {tuple(w.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"fused_convpos kernel takes fp32 or bf16, got {x.dtype}")
    for name, t in (("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2)):
        if t.dtype != x.dtype or t.device != x.device:
            raise TypeError(f"{name} is {t.dtype} on {t.device}; x is {x.dtype} on {x.device}")
    if tuple(b1.shape) != (d,) or tuple(b2.shape) != (d,):
        raise ValueError(f"biases must be [{d}]")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("fused_convpos kernel needs a contiguous, 16-byte aligned x")
    if lens.shape != (b,) or lens.dtype != torch.int32 or lens.device != x.device:
        raise ValueError(f"lens must be int32 [{b}] on {x.device}")
    out = torch.empty_like(x)
    if n == 0 or b == 0:
        return out
    # tap-major weight copies (2 x 4 MB in bf16 at d=1024), made per call
    w1t, w2t = tap_major(w1, groups), tap_major(w2, groups)
    b1c, b2c = b1.contiguous(), b2.contiguous()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    KERNEL.launch(x.data_ptr(), w1t.data_ptr(), b1c.data_ptr(), w2t.data_ptr(), b2c.data_ptr(),
                  lens.data_ptr(), out.data_ptr(), b, n, d, groups, _DTYPE_CODE[x.dtype], stream)
    return out


def conv_pos_fused(x, w1, b1, w2, b2, lens, groups: int = 16) -> torch.Tensor:
    """Device dispatch: plain version for CPU tensors, the kernel for CUDA."""
    if x.device.type == "cpu":
        return conv_pos_plain(x, w1, b1, w2, b2, lens, groups)
    if x.device.type == "cuda":
        return conv_pos_cuda(x, w1, b1, w2, b2, lens, groups)
    raise ValueError(f"conv_pos_fused: no implementation for device {x.device}")
