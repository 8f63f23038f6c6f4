"""Sequence (context) parallelism: the mel-frame axis split over the ``seq``
ranks.

JAX counterpart: ``f5_tts_tpu/parallel/sequence.py``.  JAX pins the hidden
states to ``P(data, seq, None)`` with ``with_sharding_constraint`` and GSPMD
carries the frame split through the position-wise ops.  With no GSPMD the
port makes the split explicit: ``make_seq_constraint`` returns a hook that
``models/dit.py`` calls once, on the full-frame hidden states after the input
embedding, and that returns this rank's contiguous frames; the blocks run on
them (attention through ``parallel/ring.py``'s ring, RoPE at global
positions, the mask sliced alike), and ``SeqShard.gather`` all-gathers the
output frames at the end.  Its backward takes this rank's slice of the
cotangent: everything after the gather (the loss, the sampler's Euler
update) runs replicated on every seq rank, so each rank's parameter
gradients are its frames' share and their sum over the group is the whole.

The input embedding (the 31-tap ConvPositionEmbedding, kernel B) and the
ConvNeXt text embedding run on all frames on every rank, then the rank
slices: one embedding per rank, and no new collective.  Exchanging 15-frame
halos around each grouped conv instead would save that embedding's share of
the forward (2 of its ~25 layers) at the cost of two exchanges per conv.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from f5_tts_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, SEQ_AXIS,  # noqa: F401
                                            _mesh)


def make_sp_mesh(data: int = 1, seq: int = 2, model: int = 1, device_type: str | None = None):
    """Three-axis mesh [data, seq, model]."""
    return _mesh([data, seq, model], [DATA_AXIS, SEQ_AXIS, MODEL_AXIS], device_type)


def activation_spec(mesh) -> tuple:
    """Placements of [b, n, d] activations per mesh axis: rows over
    ``data``, frames over ``seq``, replicated over the rest."""
    return tuple(Shard(0) if name == DATA_AXIS else Shard(1) if name == SEQ_AXIS
                 else Replicate() for name in mesh.mesh_dim_names)


class _Gather(torch.autograd.Function):
    """All-gather of the frame shards along ``dim``; the backward keeps this
    rank's slice of the (replicated) cotangent."""

    @staticmethod
    def forward(ctx, x, shard: "SeqShard", dim: int):
        ctx.shard, ctx.dim, ctx.n = shard, dim, x.shape[dim]
        parts = [torch.empty_like(x) for _ in range(shard.size)]
        dist.all_gather(parts, x.contiguous(), group=shard.group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.shard.rank * ctx.n, ctx.n), None, None


class SeqShard:
    """The seq split of one rank: ``self(h)`` (JAX's constraint) takes the
    full-frame hidden states [b, n, d] to this rank's frames; ``shard``
    slices any tensor's frame axis; ``gather`` is the matching all-gather."""

    def __init__(self, group):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)

    def _local(self, n: int) -> int:
        if n % self.size:
            raise ValueError(f"frames {n} not divisible by the seq axis {self.size}")
        return n // self.size

    def shard(self, t: torch.Tensor, dim: int = 1) -> torch.Tensor:
        nl = self._local(t.shape[dim])
        return t.narrow(dim, self.rank * nl, nl)

    def __call__(self, h: torch.Tensor) -> torch.Tensor:
        return self.shard(h, 1)

    def gather(self, h: torch.Tensor, dim: int = 1) -> torch.Tensor:
        return _Gather.apply(h, self, dim)


def make_seq_constraint(mesh) -> SeqShard:
    """The ``activation_constraint`` hook of ``dit.forward`` on ``mesh``'s
    ``seq`` axis."""
    if SEQ_AXIS not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"mesh {mesh.mesh_dim_names} has no '{SEQ_AXIS}' axis")
    return SeqShard(mesh.get_group(SEQ_AXIS))
