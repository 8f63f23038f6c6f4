"""Non-causal, length-masked multi-head attention.

JAX counterpart: ``f5_tts_tpu/ops/attention.py``.  ``sdpa`` is the plain
einsum attention with an fp32 softmax and a large-negative additive key mask
(:23-36).  ``attention`` dispatches (:83-116): ``"auto"`` and ``"flash"``
go to the serving forward of ``ops/flash_attention.py`` (kernel A for CUDA
tensors, its plain version for CPU tensors); ``"flash_train"`` and
``"train_auto"`` go to its differentiable ``flash_attention_trainable``
(kernels C, D, E, or their plain versions under the same autograd
Function); ``"sdpa"`` runs the plain ``sdpa`` when the caller names it.
On CUDA tensors ``"auto"`` and ``"train_auto"`` take the kernels only for
a head width they take and ``sdpa`` otherwise, as JAX's take SDPA where
``flash_supported`` fails; the forced ``"flash"`` and ``"flash_train"``
always take them, and raise for such a width
(``attention_takes_kernel``).
``"chunked"`` is JAX's ``chunked_attention`` (:39-80): a plain,
differentiable online-softmax scan over 512-key chunks, which gives
``sdpa`` when the chunk does not divide n, as JAX's does.  A callable
backend ``(q, k, v, mask) -> o`` is called as is (:90-91): the ring
attention of ``parallel/ring.py``.  ``mask`` is a prefix (length) mask
[b, n].
"""

from __future__ import annotations

import torch

from f5_tts_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_trainable,
    kernel_takes,
)

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


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mask: torch.Tensor | None = None, chunk: int = 512) -> torch.Tensor:
    """Online softmax over key chunks, never the [n, n] scores; autograd
    through the loop is the recomputing backward (JAX ``chunked_attention``)."""
    b, h, n, d = q.shape
    if n % chunk != 0:
        return sdpa(q, k, v, mask)
    scale = d ** -0.5
    m = torch.full((b, h, n, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, n, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, n, d), dtype=torch.float32, device=q.device)
    for j in range(0, n, chunk):
        s = torch.einsum("bhqd,bhkd->bhqk", q, k[:, :, j:j + chunk]).float() * scale
        if mask is not None:
            s = torch.where(mask[:, None, None, j:j + chunk], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype),
                                         v[:, :, j:j + chunk]).float()
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


FLASH_BACKENDS = ("auto", "flash", "train_auto", "flash_train")
FORCED_BACKENDS = ("flash", "flash_train")


def attention_takes_kernel(device_type: str, backend: str, head_dim: int) -> bool:
    """Whether a flash backend sends q, k, v of ``head_dim`` on a
    ``device_type`` device to the kernels' functions (``flash_attention``,
    ``flash_attention_trainable``, MMDiT's two-segment pair) rather than to
    the plain ``sdpa``: JAX's gate (:96-116, ``flash_supported``) on the
    device type and the static head width alone.  A CPU tensor keeps the
    kernels' functions, whose CPU implementation is their plain version; on
    the card the forced names always take the kernels."""
    if device_type != "cuda" or backend in FORCED_BACKENDS:
        return True
    return kernel_takes(head_dim)


def attention(q, k, v, mask=None, backend="auto"):
    if callable(backend):
        return backend(q, k, v, mask)
    if backend == "sdpa":
        return sdpa(q, k, v, mask)
    if backend == "chunked":
        return chunked_attention(q, k, v, mask)
    if backend not in FLASH_BACKENDS:
        raise ValueError(f"unknown attention backend {backend!r} "
                         "(auto | flash | flash_train | train_auto | sdpa | chunked | a callable)")
    if not attention_takes_kernel(q.device.type, backend, q.shape[-1]):
        return sdpa(q, k, v, mask)
    if backend in ("flash_train", "train_auto"):
        return flash_attention_trainable(q, k, v, mask)
    b, _, n, _ = q.shape
    if mask is None:
        lens = torch.full((b,), n, dtype=torch.int32, device=q.device)
    else:
        lens = mask.sum(dim=-1, dtype=torch.int32)
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), lens)
