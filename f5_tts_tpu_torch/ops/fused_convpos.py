"""Fused ConvPositionEmbedding: the CUDA forward kernel, its plain version
and the autograd Function around them.

JAX counterpart: ``f5_tts_tpu/ops/fused_convpos.py::_kernel`` (:37-83),
called through ``_conv_pos_fused`` (:87-119) and ``conv_pos_fused``
(:168-173), differentiated by ``_fused_diff`` (:130-150).  The kernel is ``csrc/fused_convpos.cu``; its header says what
bounds it on the H100 and how its blocking departs from the TPU kernel's.

The function: for x [b, n, d] and a prefix mask of lengths ``lens``,
``mask -> grouped conv1d(k=31, same, bias) -> Mish -> mask -> grouped
conv1d(k=31, bias) -> Mish -> mask``.  Weights arrive in torch's
[out, in/groups, k] layout.  The plain version is the unfused composition
(``f5_tts_tpu/models/layers.py`` ``conv_pos_embed_xla``, :197-209).

Dispatch is by device: a CPU tensor runs ``conv_pos_plain``; a CUDA tensor
launches the kernel, and a shape or dtype it does not take raises (the
kernel takes 64-channel groups, the F5-TTS width of 1024 / 16).

The kernel reads its weights in a tap-major bf16 layout (``kernel_taps``:
[parts][groups][31][c_out][c_in], one part for bf16 x, the high and low
bf16 parts for fp32 x).  A serving engine makes that copy once, when it
casts its weights (``ConvPositionEmbedding.freeze_taps``, called by
``infer/engine.py``), and passes it in as ``taps``; a call without
``taps`` (training, whose weights change every step, or a bare call)
makes it per call.  ``TAP_COPIES`` counts the copies made.  The kernel
comes in the tile configurations (output rows per block, ring stages) of
``CONFIGS``; the wrapper launches ``CONFIG``, the fastest on the card at
[2, 1024, 1024] (``PERF.md``).

The backward is not a kernel, in JAX either: ``_fused_diff`` linearizes the
plain XLA composition.  Here ``_ConvPosFn.backward`` re-runs
``conv_pos_plain`` on the saved inputs under autograd and returns its
gradients for x, both weights and both biases.
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
# (x, w1t, b1, w2t, b2, lens, out, b, n, d, groups, dtype, rows, stages, stream)
KERNEL = CudaKernel(
    "fused_convpos_fwd", "fused_convpos.cu",
    [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the (output rows per block, ring stages) configurations built, and the
# one the wrapper launches
CONFIGS = ((64, 4), (128, 4), (128, 6), (192, 4))
CONFIG = (128, 4)
TAP_COPIES = 0  # kernel_taps calls: weight copies made in the kernel's layout


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
    """torch [out, in/g, k] -> [groups][k][c_out][c_in]: per tap the
    [c_out][c_in] matrix the kernel's product reads row by row."""
    d, dg, k = w.shape
    return w.reshape(groups, d // groups, dg, k).permute(0, 3, 1, 2)


def kernel_taps(w: torch.Tensor, groups: int, dtype: torch.dtype) -> torch.Tensor:
    """The kernel's weights for inputs of ``dtype``: the tap-major layout in
    bf16, [1, groups, k, c_out, c_in] for bf16, and for fp32 the bf16 high
    part and the bf16 low part (the high part's rounding error) stacked as
    [2, ...], which the kernel's three bf16 products use."""
    global TAP_COPIES
    TAP_COPIES += 1
    t = tap_major(w.detach(), groups)
    hi = t.to(torch.bfloat16)
    if dtype == torch.bfloat16:
        return hi.contiguous()[None]
    return torch.stack([hi, (t.float() - hi.float()).to(torch.bfloat16)]).contiguous()


def conv_pos_cuda(x, w1, b1, w2, b2, lens, groups: int, taps=None,
                  config: tuple[int, int] = CONFIG) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream.  ``taps``: the
    pair ``kernel_taps(w1, ...), kernel_taps(w2, ...)`` made beforehand, or
    None to make it here.  ``config`` (output rows per block, ring stages)
    is one of ``CONFIGS``."""
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
    if config not in CONFIGS:
        raise ValueError(f"fused_convpos configuration {config} is not one of {CONFIGS}")
    if taps is None:
        taps = (kernel_taps(w1, groups, x.dtype), kernel_taps(w2, groups, x.dtype))
    parts = 1 if x.dtype == torch.bfloat16 else 2
    for t in taps:
        if tuple(t.shape) != (parts, groups, KSIZE, GROUP_WIDTH, GROUP_WIDTH) \
                or t.dtype != torch.bfloat16 or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"taps must be kernel_taps(w, {groups}, {x.dtype}) on {x.device}")
    out = torch.empty_like(x)
    if n == 0 or b == 0:
        return out
    b1c, b2c = b1.contiguous(), b2.contiguous()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    KERNEL.launch(x.data_ptr(), taps[0].data_ptr(), b1c.data_ptr(), taps[1].data_ptr(),
                  b2c.data_ptr(), lens.data_ptr(), out.data_ptr(), b, n, d, groups,
                  _DTYPE_CODE[x.dtype], *config, stream)
    return out


def _conv_pos_forward(x, w1, b1, w2, b2, lens, groups: int, taps=None) -> torch.Tensor:
    """Device dispatch: plain version for CPU tensors, the kernel for CUDA."""
    if x.device.type == "cpu":
        return conv_pos_plain(x, w1, b1, w2, b2, lens, groups)
    if x.device.type == "cuda":
        return conv_pos_cuda(x, w1, b1, w2, b2, lens, groups, taps)
    raise ValueError(f"conv_pos_fused: no implementation for device {x.device}")


class _ConvPosFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, lens, groups, taps):
        ctx.save_for_backward(x, w1, b1, w2, b2, lens)
        ctx.groups = groups
        return _conv_pos_forward(x, w1, b1, w2, b2, lens, groups, taps)

    @staticmethod
    def backward(ctx, g):
        x, w1, b1, w2, b2, lens = ctx.saved_tensors
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(True) for t in (x, w1, b1, w2, b2)]
            y = conv_pos_plain(*ins, lens, ctx.groups)
            grads = torch.autograd.grad(y, ins, g)
        return (*grads, None, None, None)


def conv_pos_fused(x, w1, b1, w2, b2, lens, groups: int = 16, taps=None) -> torch.Tensor:
    """Differentiable fused ConvPositionEmbedding: the kernel (CUDA) or the
    plain version (CPU) forward, the plain composition's gradients backward.
    ``taps``: the weights' ``kernel_taps`` pair, made once where the weights
    stay fixed (serving), or None."""
    return _ConvPosFn.apply(x, w1, b1, w2, b2, lens, groups, taps)
