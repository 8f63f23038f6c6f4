"""Pipeline parallelism: the DiT's blocks split over the ``pipe`` ranks, with
a GPipe schedule of microbatches.

JAX counterpart: ``f5_tts_tpu/parallel/pipeline.py``.  JAX shards the depth
axis of its scan-stacked blocks over ``pipe`` and runs a shift register of
``M + pp - 1`` ticks under ``shard_map``, stage s running microbatch t - s at
tick t; autodiff through ``ppermute`` gives the backward pipeline.  The port
runs the same ticks eagerly on each stage's process: stage s holds blocks
``[s * depth / pp, (s + 1) * depth / pp)`` (``pp_param_specs``), receives
microbatch m from stage s - 1 (stage 0 takes it from the input), runs its
blocks and sends the result to stage s + 1; the last stage keeps its
outputs, and they are then broadcast to every stage, so what follows the
blocks (the final norm, ``proj_out``, the loss) runs replicated.  The
backward pipeline comes from autograd: the send's backward receives the
cotangent from stage s + 1, the receive's backward sends it to stage s - 1.

Three operators keep the gradients those of the one-device model:

- ``_PipeIn`` (identity forward, all-reduce of the gradient over ``pipe``
  backward) on the blocks' inputs h and the time embedding: stage 0 alone
  reads h and every stage reads the time embedding, so each stage holds a
  part of their gradient, and after it every stage holds the whole;
- ``_PipeOut`` (the broadcast from the last stage) passes the last stage's
  cotangent alone into the pipeline: every stage computes the loss, and it
  counts once;
- the parameters before and after the blocks run on every stage, so each
  stage ends with their whole gradient: the gradients need no sum over
  ``pipe`` (``parallel/layout.py`` counts them once in the global norm).

Transport: point-to-point ``isend`` / ``irecv`` on the pipe group, tagged
by the microbatch (``parallel/distributed.p2p``: through host memory on
gloo, device to device on NCCL).  Every stage walks its
microbatches in one order forward and the reverse backward, which is the
order NCCL, which ignores tags, pairs them in.

``seq_shard`` (pp x sp): the sequence-parallel hook has already cut the
frames (``parallel/sequence.py``), so each tick runs the blocks on this
rank's frames with ring attention over ``seq``
(``parallel/ring.make_ring_attention_local``) as its backend.  With one
stage the hook is the plain loop over the blocks (JAX
``tests/test_pipeline_parallel.py:165``).
"""

from __future__ import annotations

import re

import torch
import torch.distributed as dist

from f5_tts_tpu_torch.parallel.distributed import p2p
from f5_tts_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, PIPE_AXIS,  # noqa: F401
                                            SEQ_AXIS, _mesh, axis_group, axis_rank, axis_size)

_BLOCK = re.compile(r"(^|\.)transformer_blocks\.(\d+)\.")


def make_pp_mesh(data: int = 1, pipe: int = 2, model: int = 1, device_type: str | None = None):
    """Three-axis mesh [data, pipe, model] (JAX ``make_pp_mesh``)."""
    return _mesh([data, pipe, model], [DATA_AXIS, PIPE_AXIS, MODEL_AXIS], device_type)


def pp_param_specs(keys, depth: int, pp: int) -> dict:
    """The stage that holds each tensor of a DiT (or its ``CFM``) state dict:
    block i's tensors on stage ``i // (depth / pp)``, None (every stage) for
    the rest (JAX ``pp_param_specs``)."""
    if depth % pp:
        raise ValueError(f"depth {depth} does not divide over {pp} pipeline stages")
    per = depth // pp
    out = {}
    for k in keys:
        m = _BLOCK.search(k)
        out[k] = None if m is None else int(m.group(2)) // per
    return out


class Stages:
    """This rank's place on the ``pipe`` axis and its point-to-point link to
    the neighbouring stages (module docstring)."""

    def __init__(self, mesh):
        self.pp = axis_size(mesh, PIPE_AXIS)
        self.stage = axis_rank(mesh, PIPE_AXIS)
        self.group = axis_group(mesh, PIPE_AXIS)
        self.pending: list = []  # the sends not yet waited on

    def global_rank(self, stage: int) -> int:
        return dist.get_global_rank(self.group, stage)

    def send(self, t: torch.Tensor, stage: int, tag: int) -> None:
        self.pending.append(p2p(self.group, sends=[(t.detach().contiguous(),
                                                    self.global_rank(stage), tag)]))

    def recv(self, like: torch.Tensor, stage: int, tag: int) -> torch.Tensor:
        buf = torch.empty(like.shape, dtype=like.dtype, device=like.device)
        p2p(self.group, recvs=[(buf, self.global_rank(stage), tag)]).wait()
        return buf

    def drain(self) -> None:
        """Wait for every send issued so far."""
        for transfers in self.pending:
            transfers.wait()
        self.pending = []


class _PipeIn(torch.autograd.Function):
    """(h, t_emb) unchanged; backward, their gradients summed over ``pipe``."""

    @staticmethod
    def forward(ctx, stages, h, t_emb):
        ctx.stages = stages
        return h.view_as(h), t_emb.view_as(t_emb)

    @staticmethod
    def backward(ctx, gh, gt):
        # the last node of the stage's backward: its cotangent sends are done
        # once the previous stage has them, before the buffers may go
        ctx.stages.drain()
        out = []
        for g in (gh, gt):
            g = g.contiguous().clone()
            dist.all_reduce(g, group=ctx.stages.group)
            out.append(g)
        return None, *out


class _Recv(torch.autograd.Function):
    """Microbatch ``m``'s activation from the previous stage (``like`` gives
    its shape); backward, its cotangent goes back there."""

    @staticmethod
    def forward(ctx, stages, like, m):
        ctx.stages, ctx.m = stages, m
        return stages.recv(like, stages.stage - 1, m)

    @staticmethod
    def backward(ctx, g):
        ctx.stages.send(g, ctx.stages.stage - 1, ctx.m)
        return None, torch.zeros_like(g), None


class _Send(torch.autograd.Function):
    """Microbatch ``m``'s activation to the next stage; returns a scalar
    token that carries the dependency to ``_PipeOut``.  Backward, the
    activation's cotangent comes from the next stage."""

    @staticmethod
    def forward(ctx, stages, x, m):
        ctx.stages, ctx.m, ctx.like = stages, m, torch.empty_like(x, device="meta")
        ctx.device = x.device
        stages.send(x, stages.stage + 1, m)
        return x.new_zeros(())

    @staticmethod
    def backward(ctx, _):
        like = torch.empty(ctx.like.shape, dtype=ctx.like.dtype, device=ctx.device)
        return None, ctx.stages.recv(like, ctx.stages.stage + 1, ctx.m), None


class _PipeOut(torch.autograd.Function):
    """The last stage's output, broadcast to every stage; backward, the last
    stage's cotangent enters its blocks and the others' send tokens start
    theirs."""

    @staticmethod
    def forward(ctx, stages, local, *tokens):
        ctx.stages, ctx.n_tokens = stages, len(tokens)
        out = local.clone()
        dist.broadcast(out, src=stages.global_rank(stages.pp - 1), group=stages.group)
        stages.drain()
        return out

    @staticmethod
    def backward(ctx, g):
        last = ctx.stages.stage == ctx.stages.pp - 1
        zero = g.new_zeros(())
        return (None, g if last else None, *([zero] * ctx.n_tokens))


def stage_blocks(blocks, stages: Stages):
    """This stage's blocks of the ``nn.ModuleList`` ``blocks``."""
    depth = len(blocks)
    if depth % stages.pp:
        raise ValueError(f"depth {depth} does not divide over {stages.pp} pipeline stages")
    per = depth // stages.pp
    return list(blocks)[stages.stage * per:(stages.stage + 1) * per]


def gpipe_block_scan(block_fn, blocks, h, t_emb, mask, rope, *, mesh, n_micro: int, run=None):
    """Run the blocks ``blocks`` (an ``nn.ModuleList`` of the whole depth,
    of which this stage reads its share) over ``h`` [b, n, dim] with the
    GPipe schedule over ``mesh``'s ``pipe`` axis.  ``block_fn(block, h_mb,
    t_emb_mb, mask_mb, rope) -> h_mb`` applies one block to one
    microbatch; ``run(block, block_fn, *args)`` calls it (the remat runner:
    ``models/remat.block_runner``).  Equal to the plain loop over the blocks
    up to float reassociation; with one stage it is that loop."""
    run = run or (lambda module, fn, *args: fn(module, *args))
    stages = Stages(mesh)
    if stages.pp == 1:
        for blk in blocks:
            h = run(blk, block_fn, h, t_emb, mask, rope)
        return h
    b = h.shape[0]
    M = n_micro
    if M < 1 or b % M:
        raise ValueError(f"batch {b} does not divide into {M} microbatches")
    mb = b // M
    stages.drain()
    if t_emb is None:  # the precomputed AdaLN tables' path: no time embedding to pass
        h = _PipeIn.apply(stages, h, h.new_zeros(()))[0]
    else:
        h, t_emb = _PipeIn.apply(stages, h, t_emb)
    own = stage_blocks(blocks, stages)
    s, pp = stages.stage, stages.pp
    outs, tokens = [], []
    for t in range(M + pp - 1):  # stage s runs microbatch t - s at tick t
        m = t - s
        if not 0 <= m < M:
            continue
        rows = slice(m * mb, (m + 1) * mb)
        x = h[rows] if s == 0 else _Recv.apply(stages, h[rows], m)
        te = None if t_emb is None else t_emb[rows]
        mk = None if mask is None else mask[rows]
        for blk in own:
            x = run(blk, block_fn, x, te, mk, rope)
        if s == pp - 1:
            outs.append(x)
        else:
            tokens.append(_Send.apply(stages, x, m))
    local = torch.cat(outs) if outs else torch.zeros_like(h)
    return _PipeOut.apply(stages, local, *tokens)


def make_dit_block_scan(cfg, mesh, n_micro: int, backend="auto", ring_sequence: str | None = None):
    """The ``block_scan`` hook of ``dit.forward`` over ``mesh``'s ``pipe``
    axis (JAX ``make_dit_block_scan``).  ``ring_sequence``: the ring's block
    (``auto`` | ``xla`` | ``flash``) for the attention inside each tick when
    the mesh also has a ``seq`` axis (pp x sp; the seq hook has cut the
    frames).  The remat policy reads the tokens of one microbatch on this
    rank (JAX :216-221)."""
    from f5_tts_tpu_torch.models import layers as L
    from f5_tts_tpu_torch.models import remat
    from f5_tts_tpu_torch.parallel.ring import make_ring_attention_local

    sp = axis_size(mesh, SEQ_AXIS)
    use_ring = bool(ring_sequence) and sp > 1 and axis_size(mesh, PIPE_AXIS) > 1
    blk_backend = (make_ring_attention_local(ring_sequence, group=axis_group(mesh, SEQ_AXIS))
                   if use_ring else backend)

    def block_fn(blk, hh, te, mk, rp):
        return L.dit_block(blk, hh, te, cfg.heads, mask=mk, rope_freqs=rp,
                           pe_attn_head=cfg.pe_attn_head, backend=blk_backend)

    def block_scan(blocks, h, t_emb, mask, rope):
        micro = max(n_micro, 1) if axis_size(mesh, PIPE_AXIS) > 1 else 1
        run = remat.block_runner(cfg, (h.shape[0] // micro) * h.shape[1])
        return gpipe_block_scan(block_fn, blocks, h, t_emb, mask, rope, mesh=mesh,
                                n_micro=n_micro, run=run)

    return block_scan
