"""Experiment: warp-specialised, pipelined flash attention (kernel H) against
the serving kernel A, on the card.

JAX counterpart: ``scripts/exp_pipelined_flash.py``: ``_kernel_pipe`` (:24)
through ``_flash_pipe`` (:64), which issues key tile j+1's q k^T before
tile j's softmax and p v, A/B'd against the committed flash kernel.  Here
kernel H (``csrc/flash_attention_pipelined.cu``) is a warp-specialised
Hopper kernel: a producer warpgroup streams q, K and V by TMA into an
``mbarrier`` ring, and two consumer warpgroups take turns on ``wgmma``,
each issuing the next tile's scores before the current tile's softmax,
which runs while they are in the tensor cores, and p v after it.
Its function is kernel A's (``ops/flash_attention.py``), and so is its
plain version, ``flash_attention_plain``.  Neither is on the serving path.

Dispatch is by device, as for every kernel of the port: a CPU tensor runs
the plain version; a CUDA tensor launches kernel H (bf16 only; the
instances in ``CONFIGS``, ``CONFIG`` by default) or raises.
``KERNEL.launches`` counts its launches.

    python -m f5_tts_tpu_torch.scripts.exp_pipelined_flash

prints, at the experiment's shapes [2, 16, n, 64] bf16 with n = 1024 (lens
{1024, 824}) and n = 4096 (lens {4096, 4059}): H's error against kernel A
and the device time per call (``utils.device.device_ms``) of every
instance of H, of kernel A and of ``scaled_dot_product_attention``, each
beside the bound.
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
# (block_q, block_k): query rows per block (two consumer warpgroups of 64),
# keys per tile
CONFIGS = ((128, 64), (128, 128))
CONFIG = (128, 128)  # the faster at [2, 16, 1024, 64] on the H100
PROBE = CudaKernel("mbar_wait_probe", "flash_attention_pipelined.cu", [_P])


def flash_pipe_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lens: torch.Tensor,
                    block_q: int = CONFIG[0], block_k: int = CONFIG[1]) -> torch.Tensor:
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
               block_q: int = CONFIG[0], block_k: int = CONFIG[1]) -> torch.Tensor:
    """Kernel A's function through kernel H (JAX ``_flash_pipe``).  Device
    dispatch: the plain version for CPU tensors (the blocks then do not
    matter)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, lens)
    if q.device.type == "cuda":
        return flash_pipe_cuda(q, k, v, lens, block_q, block_k)
    raise ValueError(f"flash_pipe: no implementation for device {q.device}")


def probe_bounded_wait(device: torch.device | str = "cuda") -> None:
    """Launch one block that waits on an ``mbarrier`` no one arrives at: the
    kernels' bounded wait (``common.cuh`` ``mbar_wait``) must trap within a
    few seconds rather than hang.  The trap ends the CUDA context, so call
    this only in a process of its own."""
    PROBE.launch(torch.cuda.current_stream(torch.device(device)).cuda_stream)


def bound_ms(b: int, h: int, n: int, lens: list[int]) -> tuple[float, str]:
    """The H100's least time for the function: 4 h n kv 64 operations per
    batch row at 989 TFLOP/s (bf16), or q, k, v, o and lens through 3.35
    TB/s, whichever is longer."""
    t_ops = sum(4.0 * h * n * min(max(kv, 0), n) * HEAD_DIM for kv in lens) / 989e12
    t_bytes = (4.0 * b * h * n * HEAD_DIM * 2 + 4 * b) / 3.35e12
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def main() -> None:
    from f5_tts_tpu_torch.ops import flash_attention as FA
    from f5_tts_tpu_torch.utils.device import card_name_and_power_limit, device_ms

    if not torch.cuda.is_available():
        raise SystemExit("exp_pipelined_flash needs a CUDA card")
    print(card_name_and_power_limit())
    b, h, dh = 2, 16, HEAD_DIM
    gen = torch.Generator(device="cuda").manual_seed(0)
    for n, lens_l in ((1024, [1024, 824]), (4096, [4096, 4059])):
        q, k, v = (torch.randn((b, h, n, dh), generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
        bms, by = bound_ms(b, h, n, lens_l)
        iters = 50 if n == 1024 else 10
        want = FA.flash_attention_cuda(q, k, v, lens).float()
        print(f"[{b}, {h}, {n}, {dh}] lens {lens_l}: bound {bms:.4f} ms ({by})")
        for cfg in CONFIGS:
            err = (flash_pipe_cuda(q, k, v, lens, *cfg).float() - want).abs()
            ms = device_ms(lambda: flash_pipe_cuda(q, k, v, lens, *cfg), iters)
            print(f"  H {cfg}: {ms:.4f} ms/call of device time, {bms / ms:.1%} of the bound "
                  f"(vs kernel A: max abs {err.max().item():.2e}, mean abs "
                  f"{err.mean().item():.2e})")
        ms = device_ms(lambda: FA.flash_attention_cuda(q, k, v, lens), iters)
        print(f"  kernel A {FA.FWD_CONFIG}: {ms:.4f} ms/call, {bms / ms:.1%} of the bound")
        keep = (torch.arange(n, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
        ms = device_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=keep), iters)
        print(f"  scaled_dot_product_attention: {ms:.4f} ms/call, {bms / ms:.1%} of the bound")


if __name__ == "__main__":
    main()
