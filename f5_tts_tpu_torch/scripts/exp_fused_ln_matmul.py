"""Experiment: LayerNorm + AdaLN modulate fused into the qkv matmul's
prologue (kernel I) against the unfused composition, on the card.

JAX counterpart: ``scripts/exp_fused_ln_matmul.py``: the Pallas ``_kernel``
(:27) through ``fused_ln_matmul`` (:48), A/B'd against ``xla_ref`` (:66),
XLA's LN + modulate then matmul.  ``fused_ln_matmul`` keeps JAX's argument
layout: x bf16 [M, K], w bf16 [K, N], bias fp32 [1, N], scale1p and shift
fp32 [1, K] -> bf16 [M, N] (x's dtype).  ``fused_ln_matmul_plain`` is
``xla_ref`` in PyTorch; ``unfused`` is the composition a PyTorch model
would write (``F.layer_norm``, modulate, ``torch.matmul``), the
experiment's "XLA" side.  Neither this kernel nor this driver is on the
serving path.

Dispatch is by device: a CPU tensor runs the plain version; a CUDA tensor
launches kernel I (``csrc/fused_ln_matmul.cu``, any M, K, N) or raises
(bf16 x and w only).  ``KERNEL.launches`` counts its launches.

    python -m f5_tts_tpu_torch.scripts.exp_fused_ln_matmul

prints, at the experiment's shape M = 2048, K = 1024, N = 3072: the error
of kernel I against the plain version and microseconds of device time per
call (``utils.device.device_ms``) for kernel I and for the unfused
composition.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from f5_tts_tpu_torch.ops.cuda_build import CudaKernel
from f5_tts_tpu_torch.ops.workspace import workspace

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = CudaKernel("fused_ln_matmul", "fused_ln_matmul.cu",
                    [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P])
LN_EPS = 1e-6


def fused_ln_matmul_plain(x, w, bias, scale1p, shift) -> torch.Tensor:
    """JAX ``xla_ref``: fp32 statistics, modulate, bf16 operand, product
    (rounded to bf16), + bias, cast to x's dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    norm = xc * torch.rsqrt(var + LN_EPS) * scale1p + shift
    return (norm.to(torch.bfloat16) @ w + bias).to(x.dtype)


def unfused(x, w, bias, scale1p, shift) -> torch.Tensor:
    """The same function as a PyTorch model composes it: the yardstick."""
    norm = F.layer_norm(x.float(), (x.shape[-1],), eps=LN_EPS) * scale1p + shift
    return torch.addmm(bias.to(x.dtype), norm.to(x.dtype), w)


def fused_ln_matmul_cuda(x, w, bias, scale1p, shift) -> torch.Tensor:
    """Launch kernel I on PyTorch's current stream."""
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"fused_ln_matmul takes x [M, K] and w [K, N], got {tuple(x.shape)} "
                         f"and {tuple(w.shape)}")
    m, k = x.shape
    n = w.shape[1]
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"fused_ln_matmul kernel takes bf16 x and w, got {x.dtype}, {w.dtype}")
    want = {"bias": (1, n), "scale1p": (1, k), "shift": (1, k)}
    for name, t in (("bias", bias), ("scale1p", scale1p), ("shift", shift)):
        if t.shape != want[name] or t.dtype != torch.float32:
            raise ValueError(f"fused_ln_matmul takes fp32 {name} {list(want[name])}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    for name, t in (("x", x), ("w", w), ("bias", bias), ("scale1p", scale1p), ("shift", shift)):
        if not t.is_contiguous() or t.data_ptr() % 16 or t.device != x.device:
            raise ValueError(f"fused_ln_matmul needs a contiguous, 16-byte aligned {name} on "
                             f"{x.device}")
    if m == 0 or n == 0 or k == 0:
        raise ValueError(f"fused_ln_matmul: empty operand, M, K, N = {m}, {k}, {n}")
    if max(m, n, k) >= 2**31 // 2:
        raise ValueError(f"fused_ln_matmul: M, K, N = {m}, {k}, {n} exceed the kernel's indices")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    stats = torch.empty((m, 2), dtype=torch.float32, device=x.device)  # row mean, rstd
    KERNEL.launch(x.data_ptr(), w.data_ptr(), bias.data_ptr(), scale1p.data_ptr(),
                  shift.data_ptr(), out.data_ptr(), stats.data_ptr(),
                  workspace(x.device, "sync", 4, zero=True).data_ptr(), m, n, k,
                  torch.cuda.current_stream(x.device).cuda_stream)
    return out


def fused_ln_matmul(x, w, bias, scale1p, shift) -> torch.Tensor:
    """JAX ``fused_ln_matmul`` (its blocks are the kernel's own here).
    Device dispatch of kernel I: the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return fused_ln_matmul_plain(x, w, bias, scale1p, shift)
    if x.device.type == "cuda":
        return fused_ln_matmul_cuda(x, w, bias, scale1p, shift)
    raise ValueError(f"fused_ln_matmul: no implementation for device {x.device}")


def inputs(m: int, k: int, n: int, device, seed: int = 0):
    """The experiment's inputs: x ~ N(0, 1), w ~ 0.02 N(0, 1) in bf16; bias
    0.01 N(0, 1), scale1p 1 + 0.1 N(0, 1), shift 0.1 N(0, 1) in fp32."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    return (randn(m, k).to(torch.bfloat16), (randn(k, n) * 0.02).to(torch.bfloat16),
            randn(1, n) * 0.01, 1 + randn(1, k) * 0.1, randn(1, k) * 0.1)


def main() -> None:
    from f5_tts_tpu_torch.utils.device import card_name_and_power_limit, device_ms

    if not torch.cuda.is_available():
        raise SystemExit("exp_fused_ln_matmul needs a CUDA card")
    print(card_name_and_power_limit())
    args = inputs(2048, 1024, 3072, "cuda")
    want = fused_ln_matmul_plain(*args).float()
    got = fused_ln_matmul_cuda(*args).float()
    err = (got - want).abs()
    us = device_ms(lambda: fused_ln_matmul_cuda(*args), 50) * 1e3
    print(f"kernel I 128 x 256 tiles: {us:7.1f} us/call of device time (vs plain: max abs "
          f"{err.max().item():.2e}, mean abs {err.mean().item():.2e})")
    us = device_ms(lambda: unfused(*args), 50) * 1e3
    print(f"torch LN+modulate+matmul: {us:7.1f} us/call of device time")


if __name__ == "__main__":
    main()
