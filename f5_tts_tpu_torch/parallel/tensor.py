"""Tensor parallelism: Megatron's column / row split over the ``model`` ranks.

JAX counterpart: the ``backbone_param_specs`` placements of
``f5_tts_tpu/parallel/mesh.py`` under GSPMD, which inserts the all-reduces.
With no GSPMD the port makes them explicit, with Megatron's two operators,
each a ``torch.autograd.Function`` over the ``model`` group:

- *f* (``TensorParallel.copy_in``): identity forward, all-reduce backward.
  It sits on the input of a column-parallel linear, so the input's gradient
  is the sum of every rank's part.
- *g* (``TensorParallel.reduce``): all-reduce forward, identity backward.
  It sits on the output of a row-parallel linear.

A rank holds its ``heads / tp`` attention heads (q, k, v column-parallel,
``to_out`` row-parallel) and its ``inner / tp`` feed-forward columns
(``ff.0.0`` column-, ``ff.2`` row-parallel); the row-parallel bias is added
once, after the all-reduce (``row_linear``).  Everything else is replicated
and runs on every rank on equal inputs: the all-reduce leaves bitwise-equal
sums on every rank (one rank reduces each chunk and the others receive
it), so replicated activations and gradients never drift apart.
``parallel/mesh.shard_params`` slices the weights and sets a
``TensorParallel`` on every attention and feed-forward module.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class _CopyIn(torch.autograd.Function):
    """f: identity forward, all-reduce of the gradient backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Reduce(torch.autograd.Function):
    """g: all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class TensorParallel:
    """This rank's place on the ``model`` axis: its process group, its
    coordinate ``rank`` and the axis ``size``."""

    def __init__(self, group):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)

    def __deepcopy__(self, memo):  # a module copy (the EMA model) shares the group
        return self

    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        if not torch.is_grad_enabled() or not x.requires_grad:
            return x
        return _CopyIn.apply(x, self.group)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        if not torch.is_grad_enabled() or not x.requires_grad:
            x = x.contiguous()
            dist.all_reduce(x, group=self.group)
            return x
        return _Reduce.apply(x, self.group)

    def local_heads(self, heads: int) -> int:
        if heads % self.size:
            raise ValueError(f"{heads} heads do not divide over the model axis {self.size}")
        return heads // self.size


def tp_of(module) -> TensorParallel | None:
    """The module's ``TensorParallel``, or None when it runs whole."""
    return getattr(module, "tp", None)


def rotary_heads(pe_attn_head: int, tp: TensorParallel | None, local_heads: int) -> int:
    """How many of this rank's heads take rotary: the first ``pe_attn_head``
    *global* heads rotate, and rank r holds heads ``r * local_heads ...``."""
    if tp is None:
        return pe_attn_head
    return max(0, min(local_heads, pe_attn_head - tp.rank * local_heads))
