"""Activation checkpointing of the backbones' blocks, with JAX's remat policies.

JAX counterparts: ``remat_policy`` and ``AUTO_DOTS_FLASH_MAX_TOKENS``
(``f5_tts_tpu/models/dit.py:57-102``), the per-block ``jax.checkpoint`` of
DiT (:258-278), UNetT (``unett.py:172-179``) and MMDiT (``mmdit.py:228-234``),
and the trainer's ``resolve_remat_policy`` (``train/trainer.py:28-48``).

A checkpointed block keeps only its inputs for the backward and runs its
forward again there (``torch.utils.checkpoint``, non-reentrant).  The
policy names what the first forward keeps besides, so that the recompute
does not redo it (``create_selective_checkpoint_contexts``):

- ``nothing``: keeps nothing; the recompute runs the whole block again,
  kernel C included (C launches twice per block per micro-step);
- ``dots``: keeps the outputs of the products without batch dimensions, as
  ``dots_with_no_batch_dims_saveable`` keeps: the linears' ``mm`` /
  ``addmm`` (``bmm`` and the attention are recomputed);
- ``flash``: keeps only kernel C's outputs, o and the logsumexp L (JAX tags
  them ``flash_out`` / ``flash_lse``), so the recompute never launches C;
- ``dots_flash``: both;
- ``auto``: ``dots_flash`` up to ``AUTO_DOTS_FLASH_MAX_TOKENS`` tokens (b x
  n) per device, ``flash`` above, from a matrix measured on the H100
  (``chip_smoke.py`` phase 20), not JAX's v5e one.

C is visible to the policy because its launch is a dispatcher op,
``ops/flash_attention.fwd_stats_op``.  A block's weights enter the
checkpoint as explicit inputs, so the recompute reads the tensors the first
forward read, also when the caller swapped them in with
``torch.func.functional_call`` (the trainer's bf16 copies), which has ended
by the time the backward runs.

The checkpointed region draws no random numbers (the loss draws its noise,
times, spans and drops before the backbone, ``models/cfm.py`` ``loss``), so
the RNG state is not stashed (``preserve_rng_state=False``).
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn as nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

POLICIES = ("nothing", "dots", "flash", "dots_flash", "auto")

# per-device token budget (b x n) up to which "auto" picks "dots_flash" at
# F5TTS_v1_Base scale; above it, "flash".  From chip_smoke.py phase 20's
# matrix on one NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md, PR 11): in mixed
# precision dots_flash ran no slower than flash at 38,400 and 76,800 frames
# per update (47.2 GiB peak at 76,800) and ran out of memory at 153,600
AUTO_DOTS_FLASH_MAX_TOKENS = 76_800


def resolve(policy: str, tokens: int | None) -> str:
    """The concrete policy: ``auto`` resolved from the token count b x n."""
    if policy not in POLICIES:
        raise ValueError(f"unknown remat_policy {policy!r} ({' | '.join(POLICIES)})")
    if policy != "auto":
        return policy
    if tokens is None:
        raise ValueError("remat_policy='auto' needs the token count b*n; pass tokens= or "
                         "pre-resolve it (train/trainer.py resolve_remat_policy)")
    return "dots_flash" if tokens <= AUTO_DOTS_FLASH_MAX_TOKENS else "flash"


def resolve_remat_policy(model_cfg, batch_size_per_device: int, batch_size_type: str):
    """``model_cfg`` with ``remat_policy="auto"`` resolved from the trainer's
    per-device frame budget (JAX ``resolve_remat_policy``): a frame budget is
    the b x n token count; sample mode does not know its frames ahead and
    takes ``flash``, the policy that fits at every shape."""
    arch = model_cfg.arch
    if not arch.checkpoint_activations:
        return model_cfg
    if arch.remat_policy != "auto":
        resolve(arch.remat_policy, None)  # an unknown name raises here, not at the first step
        return model_cfg
    pol = resolve("auto", batch_size_per_device) if batch_size_type == "frame" else "flash"
    return dataclasses.replace(model_cfg, arch=dataclasses.replace(arch, remat_policy=pol))


def _dots() -> set:
    return {torch.ops.aten.mm.default, torch.ops.aten.addmm.default}


def _flash() -> set:
    import f5_tts_tpu_torch.ops.flash_attention  # noqa: F401 - registers the op

    return {torch.ops.f5_tts_tpu_torch.flash_fwd_stats.default}


def saved_ops(policy: str) -> set:
    """The dispatcher ops whose outputs a (resolved) policy keeps."""
    return {"nothing": set, "dots": _dots, "flash": _flash,
            "dots_flash": lambda: _dots() | _flash()}[policy]()


def _context_fn(save: frozenset):
    def policy_fn(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in save else CheckpointPolicy.PREFER_RECOMPUTE

    return create_selective_checkpoint_contexts(policy_fn)


class _Call(nn.Module):
    """``fn(module, *args)`` as a module's forward, for ``functional_call``."""

    def __init__(self, module: nn.Module, fn):
        super().__init__()
        self.m = module
        self.fn = fn

    def forward(self, *args):
        return self.fn(self.m, *args)


def checkpoint_block(module: nn.Module, fn, *args, policy: str):
    """``fn(module, *args)`` under activation checkpointing with a resolved
    ``policy``.  The recompute reads the weights the forward read."""
    names, weights = zip(*module.named_parameters())
    k = len(names)
    call = _Call(module, fn)

    def run(*flat):
        ws = {f"m.{n}": w for n, w in zip(names, flat[:k])}
        return torch.func.functional_call(call, ws, flat[k:])

    save = frozenset(saved_ops(policy))
    context_fn = functools.partial(_context_fn, save) if save else None
    kw = {"context_fn": context_fn} if context_fn is not None else {}
    return checkpoint(run, *weights, *args, use_reentrant=False, preserve_rng_state=False, **kw)


def block_runner(cfg, tokens: int):
    """How a backbone runs each block: ``fn(module, *args)`` directly, or
    checkpointed under the config's policy when ``checkpoint_activations``."""
    if not cfg.checkpoint_activations:
        return lambda module, fn, *args: fn(module, *args)
    policy = resolve(cfg.remat_policy, tokens)
    return lambda module, fn, *args: checkpoint_block(module, fn, *args, policy=policy)
