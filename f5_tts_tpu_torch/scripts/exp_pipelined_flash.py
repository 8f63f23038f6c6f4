"""Experiment: software-pipelined flash attention (kernel H) against the
serving kernel A, on the card.

JAX counterpart: ``scripts/exp_pipelined_flash.py``: ``_kernel_pipe`` (:24)
through ``_flash_pipe`` (:64), which issues key tile j+1's q k^T before
tile j's softmax and p v, A/B'd against the committed flash kernel.  Here
kernel H (``csrc/flash_attention_pipelined.cu``) double-buffers the K / V
tiles with ``cp.async`` and issues tile j+1's score products before tile
j's softmax.  Its function is kernel A's (``ops/flash_attention.py``), and
so is its plain version, ``flash_attention_plain``.  Neither is on the
serving path.

Dispatch is by device, as for every kernel of the port: a CPU tensor runs
the plain version; a CUDA tensor launches kernel H (bf16 only; the tile
configurations in ``CONFIGS``) or raises.  ``KERNEL.launches`` counts its
launches.

    python -m f5_tts_tpu_torch.scripts.exp_pipelined_flash

prints, at the experiment's shape [2, 16, 1024, 64] bf16 with lens {1024,
824}: H's error against kernel A, microseconds of device time per call
(``utils.device.device_ms``) for H at each tile configuration, and kernel
A's.
"""

from __future__ import annotations

import ctypes

import torch

from f5_tts_tpu_torch.ops.cuda_build import CudaKernel
from f5_tts_tpu_torch.ops.flash_attention import HEAD_DIM, LOG2E, flash_attention_plain

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = CudaKernel(
    "flash_attention_pipelined", "flash_attention_pipelined.cu",
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _P],
)
CONFIGS = ((64, 64), (128, 64), (64, 32))  # (block_q, block_k) instances of kernel H


def flash_pipe_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lens: torch.Tensor,
                    block_q: int = 64, block_k: int = 64) -> torch.Tensor:
    """Launch kernel H on PyTorch's current stream."""
    if not (q.shape == k.shape == v.shape) or q.ndim != 4 or q.shape[-1] != HEAD_DIM:
        raise ValueError(f"flash_pipe takes q, k, v of one [b, h, n, {HEAD_DIM}] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if (block_q, block_k) not in CONFIGS:
        raise ValueError(f"flash_pipe: (block_q, block_k) must be one of {CONFIGS}")
    b, h, n, _ = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16 or not t.is_contiguous() or t.data_ptr() % 16 \
                or t.device != q.device:
            raise ValueError(f"flash_pipe needs a contiguous, 16-byte aligned bf16 {name} on "
                             f"{q.device}")
    if lens.shape != (b,) or lens.dtype != torch.int32 or lens.device != q.device \
            or not lens.is_contiguous():
        raise ValueError(f"lens must be contiguous int32 [{b}] on {q.device}")
    if b * h > 65535:
        raise ValueError(f"b*h = {b * h} exceeds the kernel grid's 65535")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), out.data_ptr(),
                  b, h, n, block_q, block_k, HEAD_DIM ** -0.5 * LOG2E,
                  torch.cuda.current_stream(q.device).cuda_stream)
    return out


def flash_pipe(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lens: torch.Tensor,
               block_q: int = 64, block_k: int = 64) -> torch.Tensor:
    """Kernel A's function through kernel H (JAX ``_flash_pipe``).  Device
    dispatch: the plain version for CPU tensors (the blocks then do not
    matter)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, lens)
    if q.device.type == "cuda":
        return flash_pipe_cuda(q, k, v, lens, block_q, block_k)
    raise ValueError(f"flash_pipe: no implementation for device {q.device}")


def main() -> None:
    from f5_tts_tpu_torch.ops import flash_attention as FA
    from f5_tts_tpu_torch.utils.device import card_name_and_power_limit, device_ms

    if not torch.cuda.is_available():
        raise SystemExit("exp_pipelined_flash needs a CUDA card")
    print(card_name_and_power_limit())
    b, h, n, dh = 2, 16, 1024, 64
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((b, h, n, dh), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    lens = torch.tensor([n, n - 200], dtype=torch.int32, device="cuda")
    want = FA.flash_attention_cuda(q, k, v, lens).float()
    for bq, bk in CONFIGS:
        got = flash_pipe_cuda(q, k, v, lens, bq, bk).float()
        err = (got - want).abs()
        us = device_ms(lambda: flash_pipe_cuda(q, k, v, lens, bq, bk), 50) * 1e3
        print(f"pipe bq={bq} bk={bk}: {us:7.1f} us/call of device time (vs kernel A: max abs "
              f"{err.max().item():.2e}, mean abs {err.mean().item():.2e})")
    us = device_ms(lambda: FA.flash_attention_cuda(q, k, v, lens), 50) * 1e3
    print(f"kernel A bq=64 bk=64: {us:7.1f} us/call of device time")


if __name__ == "__main__":
    main()
