"""Non-causal, length-masked multi-head attention.

JAX counterpart: ``f5_tts_tpu/ops/attention.py``.  ``sdpa`` is the plain
einsum attention with an fp32 softmax and a large-negative additive key mask
(:23-36).  ``attention`` dispatches (:83-116): ``"auto"`` and ``"flash"``
go to the serving forward of ``ops/flash_attention.py`` (kernel A for CUDA
tensors, its plain version for CPU tensors); ``"flash_train"`` and
``"train_auto"`` go to its differentiable ``flash_attention_trainable``
(kernels C, D, E, or their plain versions under the same autograd
Function); ``"sdpa"`` runs the plain ``sdpa`` only when the caller names it.
``mask`` is a prefix (length) mask [b, n].  The ``"chunked"`` backend and
callable backends (ring attention) are not ported.
"""

from __future__ import annotations

import torch

from f5_tts_tpu_torch.ops.flash_attention import flash_attention, flash_attention_trainable

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         mask: torch.Tensor | None = None) -> torch.Tensor:
    """q, k, v [b, h, n, d]; mask [b, n] bool keep-mask (key side)."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    if mask is not None:
        logits = logits + torch.where(mask[:, None, None, :], 0.0, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def attention(q, k, v, mask=None, backend: str = "auto"):
    if backend == "sdpa":
        return sdpa(q, k, v, mask)
    if backend in ("flash_train", "train_auto"):
        return flash_attention_trainable(q, k, v, mask)
    if backend not in ("auto", "flash"):
        raise ValueError(f"unknown attention backend {backend!r} "
                         "(auto | flash | flash_train | train_auto | sdpa)")
    b, _, n, _ = q.shape
    if mask is None:
        lens = torch.full((b,), n, dtype=torch.int32, device=q.device)
    else:
        lens = mask.sum(dim=-1, dtype=torch.int32)
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), lens)
