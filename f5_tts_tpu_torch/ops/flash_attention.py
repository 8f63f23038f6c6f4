"""Masked flash attention: the CUDA kernels, their plain versions, and the
differentiable training attention built on them.

JAX counterparts, all in ``f5_tts_tpu/ops/flash_attention.py``:

- kernel A, the serving forward: ``_kernel`` (:150-191) through ``_flash``
  (:195-229) and ``flash_attention`` (:543-556);
- kernel C, the forward with logsumexp stats: ``_kernel_fwd_stats``
  (:45-78) through ``_flash_fwd_stats`` (:233-260);
- kernels D and E, the backward: ``_kernel_dq`` (:81-109) and
  ``_kernel_dkv`` (:112-147) through ``_flash_bwd`` (:264-310);
- kernel F, the two-segment (MMDiT joint-attention) forward: ``_kernel_seg``
  (:463-490) through ``_flash_seg`` (:493-515) and
  ``flash_attention_two_segment`` (:518-525);
- the custom VJP ``_flash_diff`` / ``_flash_stats_diff`` (:313-384) and the
  public ``flash_attention_with_stats`` (:387-397),
  ``flash_attention_trainable`` (:423-442) and
  ``flash_attention_two_segment_trainable`` (:445-453), here one
  ``torch.autograd.Function`` whose forward is kernel C and whose backward
  computes ``D = rowsum(do * o)`` in fp32 and launches D and E.

The kernels are ``csrc/flash_attention.cu`` (A, C, F) and
``csrc/flash_attention_bwd.cu`` (D, E); their headers say what bounds them
on the H100 and how their blocking departs from the TPU kernels'.  They
come in tile configurations (rows per block, ring stages): A, C and F in
those of ``FWD_CONFIGS``, D and E in those of ``BWD_CONFIGS``; the wrappers
launch ``FWD_CONFIG``, ``DQ_CONFIG`` and ``DKV_CONFIG``, the fastest on the
card at the training shape (``PERF.md``).

Semantics: non-causal attention over q, k, v [b, h, n, 64].  Key columns
are valid only in [0, lens[b]) (lens int32 [b]), or, in the two-segment
mode that a static ``seg`` selects (the TPU kernels' ``seg`` argument), in
[0, lens[b, 0]) U [seg, seg + lens[b, 1]) (lens int32 [b, 2]): MMDiT's
joint [audio, text] sequence with the text stream at ``seg``.  Kernels C,
D and E take both modes (instances ``KERNEL_STATS_SEG``, ``KERNEL_DQ_SEG``,
``KERNEL_DKV_SEG``); kernel F is kernel A's two-segment instance.  A query
row with no valid key gives 0.  Every kernel takes bf16 operands only: the
wrappers cast fp32 q, k, v (and do) to bf16, and the kernels write their
outputs in the inputs' dtype.  All of them compute the scores from the raw
bf16 q and k and apply scale*log2 e in fp32 inside the exponent, so the
backward's p, recomputed from L, is the forward's own; they round p (and
ds) to bf16 for their products, accumulating in fp32.  The TPU kernels
round q * scale*log2 e to bf16 before the scores instead
(tests/test_torch_flash_train.py holds both roundings within the forward's
and the backward's tolerances).  The logsumexp ``L`` is natural-log, fp32
[b, h, n], and ``-1e30`` for a row with no valid key, whose output and
gradients are 0.  ``lens`` gets no gradient.

Dispatch is by device: a CPU tensor runs the plain version; a CUDA tensor
launches the kernel, and anything the kernel does not take raises.  A and F
(``flash_attention_op``) and C (``fwd_stats_op``) are ``torch.library``
custom ops, whose CPU implementation is the plain version and whose CUDA
implementation launches the kernel; ``torch.export`` and activation
checkpoint policies see each as one op.  There
is no length gate: any n and any 0 <= seg <= n work.  Each kernel
instance's ``CudaKernel`` counts its launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from f5_tts_tpu_torch.ops.cuda_build import CudaKernel
from f5_tts_tpu_torch.ops.cuda_build import no_meta as _no_meta

LOG2E = 1.4426950408889634
HEAD_DIM = 64  # the kernels' head width (every Base config, F5TTS_Tiny)


def kernel_takes(head_dim: int) -> bool:
    """Whether the kernels take q, k, v of this head width: the shape half
    of JAX's ``flash_supported`` / ``flash_seg_supported`` (``dh % 64 ==
    0``, :528-540), narrowed to the one width built.  The callers that gate
    on it (``ops/attention.attention_takes_kernel``) send a narrower head to
    the plain ``sdpa``; the wrappers themselves raise for it."""
    return head_dim == HEAD_DIM

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# A and C: (b, h, n, dh, out dtype, rows per block, ring stages, qscale)
KERNEL = CudaKernel(  # kernel A
    "flash_attention_fwd", "flash_attention.cu",
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P],
)
KERNEL_STATS = CudaKernel(  # kernel C
    "flash_attention_fwd_stats", "flash_attention.cu",
    [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P],
)
# D and E: (b, h, n, dh, out dtype[, seg], rows per block, ring stages, qscale, scale)
KERNEL_DQ = CudaKernel(  # kernel D
    "flash_attention_bwd_dq", "flash_attention_bwd.cu",
    [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P],
)
KERNEL_DKV = CudaKernel(  # kernel E
    "flash_attention_bwd_dkv", "flash_attention_bwd.cu",
    [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P],
)
# the two-segment instances: one more int, seg, before the scales
KERNEL_SEG = CudaKernel(  # kernel F
    "flash_attention_fwd_seg", "flash_attention.cu",
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P],
)
KERNEL_STATS_SEG = CudaKernel(  # kernel C, two-segment mode
    "flash_attention_fwd_stats_seg", "flash_attention.cu",
    [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P],
)
KERNEL_DQ_SEG = CudaKernel(  # kernel D, two-segment mode
    "flash_attention_bwd_dq_seg", "flash_attention_bwd.cu",
    [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P],
)
KERNEL_DKV_SEG = CudaKernel(  # kernel E, two-segment mode
    "flash_attention_bwd_dkv_seg", "flash_attention_bwd.cu",
    [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P],
)
KERNELS = (KERNEL, KERNEL_STATS, KERNEL_DQ, KERNEL_DKV,
           KERNEL_SEG, KERNEL_STATS_SEG, KERNEL_DQ_SEG, KERNEL_DKV_SEG)
NO_KEY_LSE = -1e30  # the logsumexp of a row with no valid key
# kernels A, C, F: the (rows per block, ring stages) configurations built,
# and the one the wrappers launch (the fastest at the training shape)
FWD_CONFIGS = ((64, 2), (64, 3), (128, 2), (128, 3), (192, 2))
FWD_CONFIG = (64, 2)
# kernels D and E: the (rows per block, ring stages) configurations built,
# and the ones the wrappers launch (the fastest at the training shape)
BWD_CONFIGS = ((64, 2), (128, 2), (64, 3))
DQ_CONFIG = (64, 3)
DKV_CONFIG = (64, 3)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def key_valid(lens: torch.Tensor, n: int, seg: int | None = None) -> torch.Tensor:
    """The kernels' key mask, bool [b, n]: [0, lens) for lens [b]; with
    ``seg``, [0, lens[:, 0]) U [seg, seg + lens[:, 1]) for lens [b, 2]."""
    col = torch.arange(n, device=lens.device)[None, :]
    if seg is None:
        return col < lens[:, None]
    return (col < lens[:, 0:1]) | ((col >= seg) & (col < seg + lens[:, 1:2]))


def _masked_scores(q: torch.Tensor, k: torch.Tensor, lens: torch.Tensor,
                   seg: int | None = None) -> torch.Tensor:
    """fp32 scores q.k^T * scale, -inf on the keys the mask drops."""
    s = (q.float() @ k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
    valid = key_valid(lens.to(q.device), k.shape[2], seg)
    return s.masked_fill(~valid[:, None, None, :], float("-inf"))


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          lens: torch.Tensor, seg: int | None = None) -> torch.Tensor:
    """Exact fp32 attention with the kernel's key mask and zero-row rule."""
    vf = v.float()
    s = _masked_scores(q, k, lens, seg)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))  # rows with no valid key
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    return ((p @ vf) / torch.clamp(l, min=1e-30)).to(q.dtype)


def flash_attention_two_segment_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                      lens2: torch.Tensor, seg: int) -> torch.Tensor:
    """Kernel F's function in fp32: keys valid in [0, lens2[:, 0]) U
    [seg, seg + lens2[:, 1]); a row with both segments empty gives 0."""
    return flash_attention_plain(q, k, v, lens2, seg)


def flash_attention_fwd_stats_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                    lens: torch.Tensor, seg: int | None = None
                                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact fp32 (o, L): kernel C's function, with its no-valid-key rule."""
    s = _masked_scores(q, k, lens, seg)
    L = torch.logsumexp(s, dim=-1)
    L = torch.where(torch.isfinite(L), L, torch.full_like(L, NO_KEY_LSE))
    p = torch.exp(s - L[..., None])  # 0 on masked keys
    return (p @ v.float()).to(q.dtype), L


def flash_attention_bwd_plain(q, k, v, do, L, D, lens, seg: int | None = None):
    """(dq, dk, dv) by the backward kernels' formulas in fp32 (not autograd):
    p = exp(s - L), 0 on masked keys; ds = p (do.v^T - D); dq = scale ds.k;
    dk = scale ds^T.q; dv = p^T.do."""
    scale = q.shape[-1] ** -0.5
    p = torch.exp(_masked_scores(q, k, lens, seg) - L.float()[..., None])
    dof = do.float()
    ds = p * (dof @ v.float().transpose(-1, -2) - D.float()[..., None])
    dq = (ds @ k.float()) * scale
    dk = (ds.transpose(-1, -2) @ q.float()) * scale
    dv = p.transpose(-1, -2) @ dof
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q, k, v, lens, seg=None):
    if not (q.shape == k.shape == v.shape) or q.ndim != 4:
        raise ValueError(f"q, k, v must share one [b, h, n, dh] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, n, dh = q.shape
    if not kernel_takes(dh):
        raise ValueError(f"flash_attention kernel takes head dim {HEAD_DIM}, got {dh}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes fp32 or bf16 q/k/v of one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention kernel needs a contiguous, 16-byte aligned {name}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    want = (b,) if seg is None else (b, 2)
    if lens.shape != want or lens.dtype != torch.int32 or lens.device != q.device \
            or not lens.is_contiguous():
        raise ValueError(f"lens must be contiguous int32 {list(want)} on {q.device}, got "
                         f"{lens.dtype} {tuple(lens.shape)} on {lens.device}")
    if seg is not None and not 0 <= seg <= n:
        raise ValueError(f"seg must lie in [0, {n}], got {seg}")
    if b * h > 65535:
        raise ValueError(f"b*h = {b * h} exceeds the kernel grid's 65535")


def _seg_args(seg):
    """The kernel-instance selector's extra launch argument: none for the
    prefix mode, (seg,) for the two-segment mode."""
    return () if seg is None else (int(seg),)


def _bf16(*xs):
    """The kernels read bf16 operands: fp32 inputs are cast here (the
    returned tensors keep them alive until the launch is queued)."""
    return [x if x.dtype == torch.bfloat16 else x.to(torch.bfloat16) for x in xs]


def _fwd_tail(q, seg, config):
    b, h, n, dh = q.shape
    if config not in FWD_CONFIGS:
        raise ValueError(f"forward kernel configuration {config} is not one of {FWD_CONFIGS}")
    return (b, h, n, dh, _DTYPE_CODE[q.dtype], *_seg_args(seg), *config,
            float(dh) ** -0.5 * LOG2E, torch.cuda.current_stream(q.device).cuda_stream)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lens: torch.Tensor, seg: int | None = None,
                         config: tuple[int, int] = FWD_CONFIG) -> torch.Tensor:
    """Launch kernel A (kernel F with ``seg``) on PyTorch's current stream:
    o in q's dtype.  ``config`` (rows per block, ring stages) is one of
    ``FWD_CONFIGS``."""
    _check(q, k, v, lens, seg)
    out = torch.empty_like(q)
    if q.numel():
        kernel = KERNEL if seg is None else KERNEL_SEG
        ops = _bf16(q, k, v)
        kernel.launch(*(x.data_ptr() for x in ops), lens.data_ptr(), out.data_ptr(),
                      *_fwd_tail(q, seg, config))
    return out


def flash_attention_fwd_stats_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                   lens: torch.Tensor, seg: int | None = None,
                                   config: tuple[int, int] = FWD_CONFIG
                                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch kernel C (its two-segment instance with ``seg``): (o in q's
    dtype, L fp32 [b, h, n]).  ``config`` as kernel A's."""
    _check(q, k, v, lens, seg)
    b, h, n, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    if q.numel():
        kernel = KERNEL_STATS if seg is None else KERNEL_STATS_SEG
        ops = _bf16(q, k, v)
        kernel.launch(*(x.data_ptr() for x in ops), lens.data_ptr(), out.data_ptr(),
                      lse.data_ptr(), *_fwd_tail(q, seg, config))
    return out, lse


def _check_bwd(q, k, v, do, L, D, lens, seg=None):
    _check(q, k, v, lens, seg)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"do must match q ({q.dtype} {tuple(q.shape)}), got "
                         f"{do.dtype} {tuple(do.shape)} on {do.device}")
    if not do.is_contiguous() or do.data_ptr() % 16:
        raise ValueError("flash_attention backward needs a contiguous, 16-byte aligned do")
    for name, t in (("L", L), ("D", D)):
        if t.shape != q.shape[:3] or t.dtype != torch.float32 or t.device != q.device \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous fp32 {tuple(q.shape[:3])} on "
                             f"{q.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _bwd_args(q, k, v, do, L, D, lens):
    """The launch's leading pointers; the kernels read bf16 operands, so
    fp32 q, k, v, do are cast here (the returned tensors keep them alive
    until the launch is queued on the stream)."""
    ops = _bf16(q, k, v, do)
    return ops, [x.data_ptr() for x in ops] + [L.data_ptr(), D.data_ptr(), lens.data_ptr()]


def _bwd_tail(q, seg, config):
    b, h, n, dh = q.shape
    scale = float(dh) ** -0.5
    if config not in BWD_CONFIGS:
        raise ValueError(f"backward kernel configuration {config} is not one of {BWD_CONFIGS}")
    return (b, h, n, dh, _DTYPE_CODE[q.dtype], *_seg_args(seg), *config, scale * LOG2E, scale,
            torch.cuda.current_stream(q.device).cuda_stream)


def flash_attention_bwd_dq_cuda(q, k, v, do, L, D, lens, seg: int | None = None,
                                config: tuple[int, int] = DQ_CONFIG) -> torch.Tensor:
    """Launch kernel D (its two-segment instance with ``seg``): dq, in q's
    dtype.  ``config`` (rows per block, ring stages) is one of
    ``BWD_CONFIGS``."""
    _check_bwd(q, k, v, do, L, D, lens, seg)
    dq = torch.empty_like(q)
    if q.numel():
        kernel = KERNEL_DQ if seg is None else KERNEL_DQ_SEG
        _ops, ptrs = _bwd_args(q, k, v, do, L, D, lens)
        kernel.launch(*ptrs, dq.data_ptr(), *_bwd_tail(q, seg, config))
    return dq


def flash_attention_bwd_dkv_cuda(q, k, v, do, L, D, lens, seg: int | None = None,
                                 config: tuple[int, int] = DKV_CONFIG
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch kernel E (its two-segment instance with ``seg``): (dk, dv), in
    the inputs' dtype.  ``config`` as kernel D's."""
    _check_bwd(q, k, v, do, L, D, lens, seg)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if q.numel():
        kernel = KERNEL_DKV if seg is None else KERNEL_DKV_SEG
        _ops, ptrs = _bwd_args(q, k, v, do, L, D, lens)
        kernel.launch(*ptrs, dk.data_ptr(), dv.data_ptr(), *_bwd_tail(q, seg, config))
    return dk, dv


def _dispatch(name, plain, cuda, x, *args, **kw):
    if x.device.type == "cpu":
        return plain(x, *args, **kw)
    if x.device.type == "cuda":
        return cuda(x, *args, **kw)
    raise ValueError(f"{name}: no implementation for device {x.device}")


def flash_attention_fwd_stats(q, k, v, lens, seg: int | None = None):
    """Device dispatch of kernel C: the plain version for CPU tensors."""
    return _dispatch("flash_attention_fwd_stats", flash_attention_fwd_stats_plain,
                     flash_attention_fwd_stats_cuda, q, k, v, lens, seg=seg)


@torch.library.custom_op("f5_tts_tpu_torch::flash_fwd_stats", mutates_args=())
def fwd_stats_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lens: torch.Tensor,
                 seg: Optional[int] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """``flash_attention_fwd_stats`` as a dispatcher op, so that a selective
    activation-checkpoint policy can keep its outputs (``models/remat.py``):
    the training forward launches kernel C through it."""
    return flash_attention_fwd_stats(q, k, v, lens, seg=seg)


@fwd_stats_op.register_fake
def _(q, k, v, lens, seg=None):
    return torch.empty_like(q), q.new_empty(q.shape[:3], dtype=torch.float32)


def _bwd_cuda(q, k, v, do, L, D, lens, seg=None):
    return (flash_attention_bwd_dq_cuda(q, k, v, do, L, D, lens, seg),
            *flash_attention_bwd_dkv_cuda(q, k, v, do, L, D, lens, seg))


def flash_attention_bwd(q, k, v, do, L, D, lens, seg: int | None = None):
    """Device dispatch of kernels D and E: the plain version for CPU tensors."""
    return _dispatch("flash_attention_bwd", flash_attention_bwd_plain, _bwd_cuda,
                     q, k, v, do, L, D, lens, seg=seg)


@torch.library.custom_op("f5_tts_tpu_torch::flash_attention", mutates_args=(), device_types="cpu")
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lens: torch.Tensor,
                       seg: Optional[int] = None) -> torch.Tensor:
    """Kernel A (kernel F with ``seg``) as a dispatcher op: the plain version
    is its CPU implementation, the kernel its CUDA one, and any other device
    has none and raises.  ``torch.export`` keeps the op as one opaque node
    (``runtime/aot.py``)."""
    return flash_attention_plain(q, k, v, lens, seg)


@flash_attention_op.register_kernel("cuda")
def _(q, k, v, lens, seg=None):
    return flash_attention_cuda(q, k, v, lens, seg)


@flash_attention_op.register_fake
def _(q, k, v, lens, seg=None):
    _no_meta("flash_attention", q)
    return torch.empty_like(q)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    lens: torch.Tensor) -> torch.Tensor:
    """Device dispatch of kernel A (``flash_attention_op``): the plain
    version for CPU tensors."""
    return flash_attention_op(q, k, v, lens)


def _lens2(lens_a: torch.Tensor, lens_t: torch.Tensor) -> torch.Tensor:
    return torch.stack([lens_a.to(torch.int32), lens_t.to(torch.int32)], dim=1).contiguous()


def flash_attention_two_segment(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                lens_a: torch.Tensor, lens_t: torch.Tensor, seg: int
                                ) -> torch.Tensor:
    """Attention with the two-prefix key mask: columns [0, lens_a[i]) and
    [seg, seg + lens_t[i]) are valid for batch row i (JAX
    ``flash_attention_two_segment``).  Device dispatch of kernel F: the
    plain version for CPU tensors."""
    return flash_attention_op(q.contiguous(), k.contiguous(), v.contiguous(),
                              _lens2(lens_a, lens_t), int(seg))


class _FlashAttentionFn(torch.autograd.Function):
    """(o, L) = attention with stats; the backward takes both cotangents.
    ``seg`` (a Python int, or None for the single-prefix mask) selects the
    two-segment instances of kernels C, D and E."""

    @staticmethod
    def forward(ctx, q, k, v, lens, seg=None):
        o, L = fwd_stats_op(q, k, v, lens, seg)
        ctx.save_for_backward(q, k, v, lens, o, L)
        ctx.seg = seg
        ctx.set_materialize_grads(False)
        return o, L

    @staticmethod
    def backward(ctx, do, dL):
        q, k, v, lens, o, L = ctx.saved_tensors
        do = torch.zeros_like(o) if do is None else do.to(q.dtype).contiguous()
        # D_i = rowsum(do_i * o_i), the softmax-jacobian term; a logsumexp
        # cotangent shifts it: ds = p (dp - D + dL)
        D = (do.float() * o.float()).sum(dim=-1)
        if dL is not None:
            D = D - dL.float()
        dq, dk, dv = flash_attention_bwd(q, k, v, do, L, D.contiguous(), lens, seg=ctx.seg)
        return dq, dk, dv, None, None


def flash_attention_with_stats(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               lens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Differentiable attention returning ``(out, logsumexp)``; gradients flow
    through both.  ``lens`` [b] int32 may hold 0: that row's output is 0,
    its logsumexp -1e30 and its gradients 0."""
    n, nk = q.shape[2], k.shape[2]
    if n != nk:
        raise ValueError(f"flash_attention_with_stats needs len(q)==len(k), got {n} vs {nk}")
    return _FlashAttentionFn.apply(q.contiguous(), k.contiguous(), v.contiguous(), lens)


def flash_attention_trainable(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              mask: torch.Tensor | None = None) -> torch.Tensor:
    """Differentiable masked attention (kernel C forward, D and E backward).
    ``mask`` is a prefix (length) mask [b, n].  Padded query rows must get
    zero upstream gradient, as the caller's re-mask of the output gives
    (``models/layers.py`` ``mha``)."""
    b, _, n, _ = q.shape
    if mask is None:
        lens = torch.full((b,), n, dtype=torch.int32, device=q.device)
    else:
        lens = mask.sum(dim=-1, dtype=torch.int32)
    return flash_attention_with_stats(q, k, v, lens)[0]


def flash_attention_two_segment_trainable(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                          lens_a: torch.Tensor, lens_t: torch.Tensor,
                                          seg: int) -> torch.Tensor:
    """Differentiable two-segment attention (MMDiT's training path): kernel
    C's two-segment instance forward, D's and E's backward.  When no input
    needs a gradient the forward is kernel F, as the primal of JAX's
    ``_flash_diff`` is ``_flash_seg``.  Padded query rows must get zero
    upstream gradient, as MMDiT's re-mask of both streams gives."""
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))):
        return flash_attention_two_segment(q, k, v, lens_a, lens_t, seg)
    return _FlashAttentionFn.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                                   _lens2(lens_a, lens_t), int(seg))[0]
