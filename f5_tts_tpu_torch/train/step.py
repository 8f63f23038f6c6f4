"""Training step: CFM loss, global-norm clipping, AdamW or Adafactor, and EMA.

JAX counterpart: ``f5_tts_tpu/train/step.py:21-152``.  ``OptimConfig`` is the
same dataclass.  ``lr_schedule`` is optax's ``join_schedules`` of a linear
warmup from 0 (at update 0) and a linear decay to 0, counted in optimizer
updates.  ``Optimizer`` is the optax chain ``clip_by_global_norm`` ->
``adamw`` (or ``adafactor``) under ``MultiSteps``: it takes each micro-step's
gradients, and on every k-th applies one update from their mean, clipped as
optax clips (``g * max_norm / norm`` when ``norm >= max_norm``, no epsilon),
through ``torch.optim.AdamW`` (decoupled weight decay on every parameter, as
``optax.adamw``) or ``Adafactor`` (``optax.adafactor``'s update rule, below),
with a ``LambdaLR`` over the schedule.  ``ema_update`` is the ema_pytorch
rule of the JAX package.

Mixed precision is the JAX package's explicit cast, not autocast: the loss
runs on bf16 copies of the fp32 master weights
(``torch.func.functional_call``), with the mel cast to bf16; the gradients
flow back through the cast and arrive in fp32.  A wav batch (the trainer's
``mel_in_graph``) carries int16 waveforms that the step dequantizes and
turns into the log-mel on the device (``ops/mel.log_mel_prepadded``), as
JAX ``train_step`` does (:119-127).

Over a mesh (``train/trainer.py``) each rank's loss is its share of the
global mean (``cfm.loss``'s ``rows`` and ``count_group``), and the step
sums the gradients over the data (and seq) ranks before the global-norm
clip, in flat buckets (``all_reduce_sum_``: JAX's XLA all-reduce made
explicit).  ``Optimizer(zero1_group=...)`` is ZeRO-1: every rank holds the
whole summed gradients, updates AdamW's moments and parameters for its
rows of each tensor whose leading axis divides by the data size
(``parallel/mesh.zero1_state_specs``; the others on every rank), then the
updated rows go to every rank (a broadcast per owner).  Its ``state_dict``
gathers the moments into the one-device layout, and ``load_state_dict``
takes that layout and keeps this rank's rows, so a checkpoint resumes under
any data-parallel size.  The EMA runs on every rank, on identical
parameters.

ZeRO-1 with Adafactor (JAX ``zero1_state_specs`` on its state: ``v_row``,
``v_col`` and ``v`` shard their leading axis where it divides): each rank
keeps its rows of each such statistic; an update gathers them, runs
Adafactor's rule on the whole tensor (every rank holds the whole summed
gradients) and keeps its rows of the new statistics, so the update is the
one-device one and every rank applies it whole.  Under tensor parallelism
the clip reads the logical global norm (``parallel/layout.py``), AdamW
updates each rank's slice (its rule is per element), and Adafactor, whose
statistics and clip span the whole tensor, gathers a slice and its gradient
over ``model``, updates the whole and keeps its slice.

``train_step`` is a ``train.step`` span of the program's tracer
(``utils/profiling.py``) with its children in order: ``train.mel``,
``train.cast`` (mixed precision), ``train.forward``, ``train.backward``
(with the gradients' sum over a mesh), ``train.norm``, ``train.optimizer``
and ``train.ema`` (on an update).  While the tracer is on, a CUDA step also
counts the caching allocator's retries, device allocations and frees, and
all-stream synchronisations over the step (``profiling.ALLOC_COUNTERS``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
from torch.distributed.tensor import Shard

from f5_tts_tpu_torch.parallel.mesh import gather_dim, shard_rows, zero1_state_specs
from f5_tts_tpu_torch.utils.profiling import alloc_counters, span


@dataclass(frozen=True)
class OptimConfig:
    """Defaults mirror the reference configs' optim section + torch AdamW."""

    learning_rate: float = 7.5e-5
    num_warmup_updates: int = 20_000
    # None: the Trainer derives the decay horizon from the run length
    total_updates: int | None = None
    max_grad_norm: float = 1.0
    betas: tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 0.01
    ema_decay: float = 0.9999
    ema_update_after_step: int = 100
    ema_update_every: int = 10
    mixed_precision: bool = False  # bf16 compute on fp32 master weights
    grad_accumulation_steps: int = 1  # one optimizer update every k micro-steps
    optimizer: str = "adamw"  # "adamw" | "adafactor"


def _linear(init: float, end: float, steps: int, count: int) -> float:
    """optax.linear_schedule: constant ``init`` when ``steps <= 0``."""
    if steps <= 0:
        return init
    frac = 1.0 - min(max(count, 0), steps) / steps
    return (init - end) * frac + end


def lr_schedule(cfg: OptimConfig):
    """update count -> learning rate: linear warmup then linear decay to 0
    (reference trainer.py:316-326)."""
    total = cfg.total_updates if cfg.total_updates is not None else 1_000_000
    warm = cfg.num_warmup_updates
    decay = max(total - warm, 1)

    def schedule(count: int) -> float:
        if count < warm:
            return _linear(0.0, cfg.learning_rate, warm, count)
        return _linear(cfg.learning_rate, 0.0, decay, count - warm)

    return schedule


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors, fp32, on their device."""
    return torch.linalg.vector_norm(torch.stack([n.float() for n in torch._foreach_norm(tensors)]))


def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float, norm_fn=None
                         ) -> torch.Tensor:
    """optax.clip_by_global_norm in place, with no host sync; returns the
    norm (``norm_fn``'s, else ``global_norm``'s)."""
    norm = (norm_fn or global_norm)(grads)
    factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, factor)
    return norm


class Adafactor(torch.optim.Optimizer):
    """``optax.adafactor(lr, weight_decay_rate=wd)`` with optax's defaults
    (``f5_tts_tpu/train/step.py:61-62``; optax ``alias.adafactor``), on the
    gradients in ``p.grad``.  Per parameter, with the update count t (from
    0) and decay_t = 1 - (t + 1)^-0.8:

    - the second moments of g^2 + 1e-30: factored (a row and a column
      statistic over the two largest axes, JAX's ``_factored_dims``) when
      both are >= 128, else one per element; u = g / sqrt(moment), the row
      statistic normalized by its mean;
    - u / max(1, rms(u)) (``clip_by_block_rms(1.0)``), times the learning
      rate, times max(rms(p), 1e-3) (``multiply_by_parameter_scale``);
    - p -= u + wd * p: optax adds the decay after the learning rate, so it
      is not scaled by it.  No momentum.

    The two rms are over a leaf of JAX's tree, and JAX stacks the blocks of
    a backbone into one leaf per tensor name: ``stacks`` maps each block
    tensor to its stack (``utils/ckpt.stacked_leaf``), whose blocks share
    one rms of u and one of p (``_block_rms``).

    The factored axes depend only on the parameter's sizes, so the torch
    layout (a linear's [out, in]) factors as JAX's ([in, out]) does.  Not
    ``torch.optim.Adafactor``, whose update rule differs.
    """

    DECAY_RATE = 0.8
    MIN_DIM_TO_FACTOR = 128
    CLIP = 1.0  # clip_by_block_rms threshold
    MIN_SCALE = 1e-3  # the floor of rms(p) in multiply_by_parameter_scale
    EPS = 1e-30

    def __init__(self, params, lr: float, weight_decay: float = 0.0, zero1_group=None,
                 tp_dims: dict | None = None, stacks: dict | None = None, stack_group=None):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay))
        self.zero1_group = zero1_group
        self.tp_dims = tp_dims or {}  # param -> (dim, model group) of a tensor-parallel slice
        self.stacks = stacks or {}  # param -> the JAX leaf it is a depth slice of
        self.stack_group = stack_group  # the pipe ranks a stack's slices spread over
        self.sharded: dict = {}  # param -> the state keys held as this rank's rows

    @classmethod
    def factored_dims(cls, shape) -> tuple[int, int] | None:
        """optax ``_factored_dims``: (second largest, largest) axis, or None."""
        if len(shape) < 2:
            return None
        order = np.argsort(shape)
        if shape[order[-2]] < cls.MIN_DIM_TO_FACTOR:
            return None
        return int(order[-2]), int(order[-1])

    @torch.no_grad()
    def step(self):
        work = [(p, group, *self._direction(p)) for group in self.param_groups
                for p in group["params"] if p.grad is not None]
        rms = self._block_rms([(self.stacks.get(p), full_p, u) for p, _, full_p, u, _ in work])
        for (p, group, full_p, u, state), (rms_u, rms_p) in zip(work, rms):
            u = u / torch.clamp(rms_u / self.CLIP, min=1.0)
            u = u * group["lr"] * torch.clamp(rms_p, min=self.MIN_SCALE)
            if group["weight_decay"]:
                u = u + group["weight_decay"] * full_p
            full_p.sub_(u)
            self._keep(p, full_p, state)

    def _direction(self, p):
        """One parameter's second moments and its update direction g /
        sqrt(moment) on its logical (whole) tensor: a tensor-parallel slice
        and its gradient are gathered over ``model`` first, and ZeRO-1's
        state rows over ``data``.  Returns (whole parameter, direction,
        whole state)."""
        full_p, g = p, p.grad
        tp = self.tp_dims.get(p)
        if tp is not None:
            full_p, g = (gather_dim(t, *tp) for t in (p.detach(), g))
        state = self.state[p]
        if self.zero1_group is not None:
            state = {k: gather_shard(v, self.zero1_group) if k in self.sharded.get(p, ()) else v
                     for k, v in state.items()}
        dims = self.factored_dims(tuple(full_p.shape))
        if not state:
            state["step"] = 0
            if dims is None:
                state["v"] = torch.zeros_like(full_p)
            else:
                state["v_row"] = full_p.new_zeros([s for i, s in enumerate(full_p.shape)
                                                   if i != dims[1]])
                state["v_col"] = full_p.new_zeros([s for i, s in enumerate(full_p.shape)
                                                   if i != dims[0]])
        t = state["step"]
        decay = 1.0 - float(np.float32(t + 1) ** np.float32(-self.DECAY_RATE))
        g2 = g.square() + self.EPS
        if dims is None:
            v = state["v"].mul_(decay).add_(g2, alpha=1.0 - decay)
            u = g * v.rsqrt()
        else:
            d1, d0 = dims
            v_row = state["v_row"].mul_(decay).add_(g2.mean(dim=d0), alpha=1.0 - decay)
            v_col = state["v_col"].mul_(decay).add_(g2.mean(dim=d1), alpha=1.0 - decay)
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row = (v_row / v_row.mean(dim=reduced_d1, keepdim=True)).rsqrt()
            u = g * row.unsqueeze(d0) * v_col.rsqrt().unsqueeze(d1)
        state["step"] = t + 1
        return full_p, u, state

    def _block_rms(self, items) -> list:
        """(rms(u), rms(p)) for each (stack, whole parameter, direction) of
        ``items``.  optax's ``clip_by_block_rms`` and
        ``scale_by_param_block_rms`` read each leaf of JAX's tree whole, and
        JAX stacks a backbone's blocks into one leaf per tensor name
        (``utils/ckpt.stacked_leaf``): the blocks of a stack share its rms,
        their sums added over ``stack_group`` where the pipeline spreads
        them over stages.  Any other tensor is its own leaf."""
        sums = {}
        for key, p, u in items:
            if key is not None:
                part = torch.stack([u.square().sum(), p.square().sum()]).double()
                part = torch.cat([part, part.new_tensor([float(u.numel())])])
                sums[key] = part if key not in sums else sums[key] + part
        keys = sorted(sums)  # one order on every rank of the group
        if keys and self.stack_group is not None:
            buf = torch.stack([sums[k] for k in keys])
            dist.all_reduce(buf, group=self.stack_group)
            sums = dict(zip(keys, buf))
        out = []
        for key, p, u in items:
            if key is None:
                out.append((u.square().mean().sqrt(), p.square().mean().sqrt()))
            else:
                su, sq, n = sums[key]
                out.append(((su / n).sqrt().float(), (sq / n).sqrt().float()))
        return out

    def _keep(self, p, full_p, state):
        """This rank's slice of the updated whole parameter, and its rows of
        the state under ZeRO-1."""
        tp = self.tp_dims.get(p)
        if tp is not None:
            dim, grp = tp
            per = p.shape[dim]
            p.copy_(full_p.narrow(dim, dist.get_rank(grp) * per, per))
        if self.zero1_group is not None:
            dp, rank = dist.get_world_size(self.zero1_group), dist.get_rank(self.zero1_group)
            specs = zero1_state_specs(state, dp=dp)
            self.sharded[p] = {k for k, v in state.items()
                               if torch.is_tensor(v) and isinstance(specs[k], Shard)}
            self.state[p] = {k: shard_rows(v, rank, dp).clone() if k in self.sharded[p] else v
                             for k, v in state.items()}
        else:
            self.state[p] = state

    def state_bytes(self) -> int:
        """Bytes the optimizer state holds on the device."""
        return sum(t.numel() * t.element_size() for st in self.state.values()
                   for t in st.values() if torch.is_tensor(t))


def gather_shard(part: torch.Tensor, group) -> torch.Tensor:
    """The whole tensor of ``group``'s row blocks ``part`` (rank r's is the
    r-th, ``parallel/mesh.shard_rows``)."""
    dp = dist.get_world_size(group)
    full = part.new_empty((part.shape[0] * dp, *part.shape[1:]))
    shard_rows(full, dist.get_rank(group), dp).copy_(part)
    gather_rows_(full, group)
    return full


def all_reduce_sum_(tensors, group, bucket_elems: int = 1 << 24) -> None:
    """Sum ``tensors`` in place over ``group``, in flat buckets of at most
    ``bucket_elems`` elements of one dtype (one collective per bucket)."""
    bucket: list[torch.Tensor] = []

    def flush():
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat, group=group)
        off = 0
        for t in bucket:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()
        bucket.clear()

    size = 0
    for t in tensors:
        if bucket and (size + t.numel() > bucket_elems or t.dtype != bucket[0].dtype):
            flush()
            size = 0
        bucket.append(t)
        size += t.numel()
    if bucket:
        flush()


def gather_rows_(full: torch.Tensor, group) -> None:
    """Give every rank of ``group`` all of ``full``'s rows, rank r holding
    the r-th contiguous block of them (``parallel/mesh.shard_rows``): one
    broadcast per owner, which NCCL and gloo (CUDA tensors too) both carry."""
    dp = dist.get_world_size(group)
    for r in range(dp):
        dist.broadcast(shard_rows(full, r, dp), src=dist.get_global_rank(group, r), group=group)


class Optimizer:
    """Clip + AdamW or Adafactor with gradient accumulation (``make_optimizer``'s
    chain).  ``inner`` is the torch optimizer, ``scheduler`` its LambdaLR.
    ``zero1_group``: the data ranks' group, for ZeRO-1 (module docstring).
    ``norm_fn``: the global norm of the gradients (the logical one under
    tensor or pipeline parallelism, ``parallel/layout.ModelLayout``);
    ``tp_dims``: {parameter index: (dim, model group)} of the tensor-parallel
    slices, which Adafactor updates on their whole tensor; ``stacks``: per
    parameter, the JAX leaf it is a depth slice of (or None), which
    Adafactor's rms spans, over ``stack_group`` (the pipe ranks) where the
    pipeline spreads the slices."""

    def __init__(self, params: list[nn.Parameter], cfg: OptimConfig, zero1_group=None,
                 norm_fn=None, tp_dims: dict | None = None, stacks=None, stack_group=None):
        self.cfg = cfg
        self.params = list(params)
        self.k = max(cfg.grad_accumulation_steps, 1)
        self.norm_fn = norm_fn or global_norm
        self.zero1_group = zero1_group if (zero1_group is not None
                                           and dist.get_world_size(zero1_group) > 1) else None
        targets = self.params
        self.row_sharded = self.zero1_group is not None and cfg.optimizer == "adamw"
        if self.zero1_group is not None:
            self.dp = dist.get_world_size(self.zero1_group)
            self.rank = dist.get_rank(self.zero1_group)
        if self.row_sharded:
            self.sharded = [isinstance(sp, Shard)
                            for sp in zero1_state_specs(self.params, dp=self.dp)]
            # leaf views of each parameter's rows: AdamW updates them in place
            targets = [shard_rows(p.detach(), self.rank, self.dp) if sh else p.detach()
                       for p, sh in zip(self.params, self.sharded)]
        self.targets = targets
        if cfg.optimizer == "adamw":
            self.inner = torch.optim.AdamW(targets, lr=cfg.learning_rate, betas=cfg.betas,
                                           eps=cfg.eps, weight_decay=cfg.weight_decay)
        elif cfg.optimizer == "adafactor":
            self.inner = Adafactor(self.params, lr=cfg.learning_rate,
                                   weight_decay=cfg.weight_decay, zero1_group=self.zero1_group,
                                   tp_dims={self.params[i]: v for i, v in (tp_dims or {}).items()},
                                   stacks={p: k for p, k in zip(self.params, stacks or ())
                                           if k is not None},
                                   stack_group=stack_group)
        else:
            raise ValueError(f"unknown optimizer {cfg.optimizer!r} (adamw | adafactor)")
        sched, base = lr_schedule(cfg), cfg.learning_rate
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(
            self.inner, lambda count: sched(count) / base if base else 0.0)
        self.mini_step = 0  # micro-steps accumulated towards the next update

    def step(self, grads) -> bool:
        """Take one micro-step's gradients; on the k-th, update the parameters
        from their mean and return True."""
        if self.mini_step == 0:
            for p, g in zip(self.params, grads):
                p.grad = g
        else:
            torch._foreach_add_([p.grad for p in self.params], list(grads))
        self.mini_step += 1
        if self.mini_step < self.k:
            return False
        self.mini_step = 0
        acc = [p.grad for p in self.params]
        if self.k > 1:
            torch._foreach_div_(acc, float(self.k))
        clip_by_global_norm_(acc, self.cfg.max_grad_norm, self.norm_fn)
        if self.row_sharded:
            for t, p, sh in zip(self.targets, self.params, self.sharded):
                t.grad = shard_rows(p.grad, self.rank, self.dp) if sh else p.grad
        self.inner.step()
        self.scheduler.step()
        if self.row_sharded:
            for t, p, sh in zip(self.targets, self.params, self.sharded):
                t.grad = None
                if sh:
                    gather_rows_(p.data, self.zero1_group)
        for p in self.params:
            p.grad = None
        return True

    def _sharded_keys(self, i: int) -> tuple:
        """The state keys of parameter ``i`` held as this rank's rows."""
        if self.zero1_group is None:
            return ()
        if self.row_sharded:
            return ("exp_avg", "exp_avg_sq") if self.sharded[i] else ()
        # sorted: a set's order differs between processes, a collective's may not
        return tuple(sorted(self.inner.sharded.get(self.params[i], ())))

    def state_dict(self) -> dict:
        """The inner optimizer's state dict in the one-device layout: under
        ZeRO-1 the state's rows gathered from every data rank (a collective:
        every rank calls it)."""
        sd = self.inner.state_dict()
        if self.zero1_group is None:
            return sd
        state = dict(sd["state"])
        for i in range(len(self.params)):
            keys = self._sharded_keys(i)
            if keys and i in state:
                state[i] = dict(state[i], **{k: gather_shard(state[i][k], self.zero1_group)
                                             for k in keys})
        return dict(sd, state=state)

    def load_state_dict(self, sd: dict) -> None:
        """Load a one-device-layout state dict (``state_dict``'s); under
        ZeRO-1 this rank keeps its rows of each sharded tensor."""
        if self.zero1_group is not None:
            state = dict(sd["state"])
            for i in range(len(self.params)):
                if i not in state:
                    continue
                if self.row_sharded:
                    keys = self._sharded_keys(i)
                else:  # Adafactor: the rule its step applies
                    specs = zero1_state_specs(state[i], dp=self.dp)
                    keys = tuple(k for k, v in state[i].items()
                                 if torch.is_tensor(v) and isinstance(specs[k], Shard))
                    self.inner.sharded[self.params[i]] = set(keys)
                state[i] = dict(state[i], **{
                    k: shard_rows(state[i][k], self.rank, self.dp).clone() for k in keys})
            sd = dict(sd, state=state)
        self.inner.load_state_dict(sd)

    def state_bytes(self) -> int:
        """Bytes of optimizer state this rank holds on its device."""
        return sum(t.numel() * t.element_size() for st in self.inner.state.values()
                   for t in st.values() if torch.is_tensor(t))

    def accumulation_state(self) -> dict | None:
        """The gradients summed so far between updates (None at a boundary),
        as live tensors: a checkpoint writer snapshots them."""
        if self.mini_step == 0:
            return None
        return {"mini_step": self.mini_step, "grads": [p.grad.detach() for p in self.params]}

    def load_accumulation_state(self, state: dict | None) -> None:
        self.mini_step = 0 if state is None else int(state["mini_step"])
        for i, p in enumerate(self.params):
            p.grad = None if state is None else state["grads"][i].to(p.device)


def make_optimizer(params, cfg: OptimConfig, zero1_group=None, layout=None,
                   stacks=None) -> Optimizer:
    """``Optimizer`` over ``params``.  ``layout`` (``parallel/layout.
    ModelLayout``, whose ``live`` parameters ``params`` are) gives the
    logical norm, the tensor-parallel slices and the pipe group;
    ``stacks``: per parameter, ``utils/ckpt.stacked_leaf`` of its name."""
    kw = {} if layout is None else layout.optimizer_kwargs()
    return Optimizer(params, cfg, zero1_group=zero1_group, stacks=stacks, **kw)


@torch.no_grad()
def ema_update(ema_params: list[torch.Tensor], params: list[torch.Tensor], update: int,
               cfg: OptimConfig, enabled: bool = True) -> None:
    """ema_pytorch rule, in place: on every ``update_every``-th optimizer
    update, copy the online weights until ``update_after_step`` and
    decay-average after it.  ``enabled`` is False on accumulation micro-steps."""
    if not enabled or update % cfg.ema_update_every:
        return
    if update <= cfg.ema_update_after_step:
        torch._foreach_copy_(ema_params, params)
        return
    torch._foreach_mul_(ema_params, cfg.ema_decay)
    torch._foreach_add_(ema_params, params, alpha=1.0 - cfg.ema_decay)


def batch_mel(batch: dict, mel_cfg=None) -> torch.Tensor:
    """The batch's log-mel [b, n, d]: its "mel", or from its "wav" on the
    device (JAX ``train_step`` :119-127): int16 dequantized by the per-row
    "wav_scale", then ``log_mel_prepadded`` (the host reflect-padded it)."""
    if "mel" in batch:
        return batch["mel"]
    from f5_tts_tpu_torch.ops.mel import log_mel_prepadded

    wav = batch["wav"]
    if wav.dtype == torch.int16:  # collate_wav_batch's wire format
        wav = wav.float() * (batch["wav_scale"][:, None] / 32767.0)
    return log_mel_prepadded(wav, mel_cfg)


def train_step(model: nn.Module, optimizer: Optimizer, ema_model: nn.Module, micro: int,
               batch: dict, seed: int, opt_cfg: OptimConfig, backend="train_auto",
               mel_cfg=None, activation_constraint=None, rows=None, data_group=None,
               grad_group=None, block_scan=None, layout=None):
    """One micro-step on ``model`` (a ``models.cfm.CFM``): loss and gradients,
    the optimizer (an update on every k-th micro-step) and the EMA.

    ``batch`` holds tensors on the model's device: "mel" [b, n, d] (or
    "wav" [b, S] int16 with "wav_scale" [b], whose mel is taken here under
    ``mel_cfg``), "text_ids" [b, nt], "lens" [b] and optionally "valid" [b].
    ``seed`` seeds this micro-step's generators.  Returns (micro + 1,
    metrics) with "loss" and "grad_norm" (of this micro-step's gradients,
    before clipping) as device scalars.

    Over a mesh: ``rows`` and ``data_group`` go to ``cfm.loss`` (its
    ``rows`` and ``count_group``); ``grad_group`` (data x seq) sums the
    gradients; the reported loss is summed over ``data_group``, the global
    mean.  ``activation_constraint``: the sequence-parallel hook;
    ``block_scan`` the pipeline's.  ``layout`` (``parallel/layout.ModelLayout``,
    under tensor or pipeline parallelism): the gradients are taken for its
    ``live`` parameters (the optimizer's), and the reported norm is the
    logical one.
    """
    with span("train.step", b=batch["text_ids"].shape[0], micro=micro) as st:
        before = alloc_counters(batch["lens"].device) if st else None
        with span("train.mel"):
            mel = batch_mel(batch, mel_cfg)
        st.set(n=mel.shape[1])
        named = dict(model.named_parameters())
        if opt_cfg.mixed_precision:
            with span("train.cast"):
                named_in = {k: p.to(torch.bfloat16) if p.is_floating_point() else p
                            for k, p in named.items()}
                mel = mel.to(torch.bfloat16)
        with span("train.forward"):
            gen = torch.Generator(device=mel.device).manual_seed(seed)
            drop_gen = torch.Generator().manual_seed(seed)
            args = (batch["text_ids"], batch["lens"])
            kw = dict(generator=gen, drop_generator=drop_gen, backend=backend,
                      valid=batch.get("valid"), activation_constraint=activation_constraint,
                      rows=rows, count_group=data_group)
            if block_scan is not None:
                kw["block_scan"] = block_scan
            if opt_cfg.mixed_precision:
                loss = torch.func.functional_call(model, named_in, (mel, *args), kw)
            else:
                loss = model(mel, *args, **kw)
        live = list(named) if layout is None else layout.live
        params = [named[k] for k in live]
        with span("train.backward"):  # and the gradients' sum over the mesh
            grads = torch.autograd.grad(loss, params)
            loss = loss.detach()
            if grad_group is not None:
                all_reduce_sum_(grads, grad_group)
                if data_group is not None:
                    dist.all_reduce(loss, group=data_group)
        with span("train.norm"):
            gnorm = optimizer.norm_fn(grads)
        with span("train.optimizer"):
            did_update = optimizer.step(grads)
        micro += 1
        if did_update:
            with span("train.ema"):
                ema = list(ema_model.parameters()) if layout is None else \
                    [dict(ema_model.named_parameters())[k] for k in live]
                ema_update(ema, params, micro // optimizer.k, opt_cfg)
        if before is not None:
            after = alloc_counters(batch["lens"].device)
            for k, v in before.items():
                st.count(k, after[k] - v)
    return micro, {"loss": loss, "grad_norm": gnorm}
