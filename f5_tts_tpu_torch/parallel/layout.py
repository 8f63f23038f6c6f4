"""Where each parameter of a model lies over a mesh's ``model`` and ``pipe``
axes, for training.

JAX counterpart: ``shard_params`` under ``backbone_param_specs`` and
``pp_param_specs`` (``f5_tts_tpu/parallel/mesh.py``, ``pipeline.py``), as
``f5_tts_tpu/train/trainer.py:354-369`` composes them.  JAX keeps one
logical array per parameter and lets GSPMD place it; the port holds each
rank's part and keeps the bookkeeping that the logical view needs:

- ``apply_``: tensor parallelism (``mesh.shard_params``: this rank's
  slices) and the pipeline (the blocks of the other stages become empty
  placeholders, their memory freed);
- ``live``: the names of the parameters this rank trains (all but the
  placeholders), in ``named_parameters`` order;
- ``global_norm``: the norm of the *logical* gradients.  A tensor sharded
  over ``model`` contributes its slice on each rank, a replicated one once
  (not tp times); a stage's blocks count on their stage, the tensors before
  and after the blocks once (not pp times): each squared norm is weighted by
  1 / (the ranks of ``pipe`` x ``model`` that hold the same tensor), then
  summed over those ranks;
- ``full_state_dict`` / ``gather_live``: the one-device layout, gathered
  from the slices (an all-gather over ``model``) and the stages (a
  broadcast from the owner over ``pipe``), so a checkpoint trained under
  tp x pp loads into a one-device model; ``local`` takes that layout back
  to this rank's part (a resume loads the one-device state before
  ``apply_``);
- ``full_optimizer_state`` / ``live_optimizer_state``: the same for the
  optimizer's state dict (AdamW's moments have their parameter's shape and
  gather as it does; Adafactor keeps whole statistics under tensor
  parallelism, ``train/step.Adafactor``).

Collective methods must be called on every rank, in one order.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import Shard

from f5_tts_tpu_torch.parallel import mesh as M
from f5_tts_tpu_torch.parallel.pipeline import pp_param_specs


def _backbone(model: torch.nn.Module):
    """(backbone, its key prefix in ``model``'s state dict)."""
    if hasattr(model, "transformer"):
        return model.transformer, "transformer."
    return model, ""


class ModelLayout:
    def __init__(self, model: torch.nn.Module, mesh, tensor_parallel: bool = False,
                 pipeline: bool = False):
        self.mesh = mesh
        named = list(model.named_parameters())
        self.names = [n for n, _ in named]
        self.shapes = {n: tuple(p.shape) for n, p in named}
        self.dtypes = {n: p.dtype for n, p in named}
        backbone, prefix = _backbone(model)
        self.tp_group = M.axis_group(mesh, M.MODEL_AXIS) if tensor_parallel else None
        self.tp = 1 if self.tp_group is None else dist.get_world_size(self.tp_group)
        self.tp_rank = 0 if self.tp_group is None else dist.get_rank(self.tp_group)
        specs = M.backbone_param_specs(backbone) if self.tp > 1 else {}
        self.tp_dim = {}
        for n in self.names:
            spec = specs.get(n[len(prefix):]) if n.startswith(prefix) else None
            self.tp_dim[n] = spec.dim if isinstance(spec, Shard) else None
        self.pp_group = M.axis_group(mesh, M.PIPE_AXIS) if pipeline else None
        self.pp = 1 if self.pp_group is None else dist.get_world_size(self.pp_group)
        self.stage = M.axis_rank(mesh, M.PIPE_AXIS) if self.pp > 1 else 0
        if self.pp > 1:
            if not hasattr(backbone, "transformer_blocks") or type(backbone).__name__ != "DiT":
                raise ValueError("the pipeline runs DiT only (JAX's make_dit_block_scan and "
                                 "pp_param_specs read DiT's stacked 'blocks')")
            self.stage_of = pp_param_specs(self.names, len(backbone.transformer_blocks), self.pp)
        else:
            self.stage_of = dict.fromkeys(self.names)
        self.live = [n for n in self.names if self.stage_of[n] in (None, self.stage)]
        self.weight = {n: 1.0 / ((self.tp if self.tp_dim[n] is None else 1)
                                 * (self.pp if self.stage_of[n] is None else 1))
                       for n in self.live}
        # the ranks that hold parts of one logical model: a pipe axis without
        # the pipeline holds copies, which the norm must not add
        axes = tuple(a for a, n in ((M.PIPE_AXIS, self.pp), (M.MODEL_AXIS, self.tp)) if n > 1)
        self.norm_group = M.axes_group(mesh, axes) if axes else None

    @property
    def active(self) -> bool:
        return self.norm_group is not None

    def apply_(self, model: torch.nn.Module) -> torch.nn.Module:
        """Shard ``model`` in place: this rank's tensor-parallel slices, and
        the other stages' blocks emptied."""
        backbone, _ = _backbone(model)
        if self.tp > 1:
            M.shard_params(backbone, self.mesh)
        if self.pp > 1:
            live = set(self.live)
            for n, p in model.named_parameters():
                if n not in live:
                    p.data = p.data.new_empty(0)
                    p.requires_grad_(False)
        return model

    def live_params(self, model: torch.nn.Module) -> list:
        named = dict(model.named_parameters())
        return [named[n] for n in self.live]

    def optimizer_kwargs(self) -> dict:
        """``train/step.Optimizer``'s arguments for the ``live`` parameters:
        the logical norm, the tensor-parallel slices (index -> (dim, model
        group)) and the pipe group that Adafactor's stacks spread over."""
        tp_dims = {i: (self.tp_dim[n], self.tp_group) for i, n in enumerate(self.live)
                   if self.tp > 1 and self.tp_dim[n] is not None}
        return dict(norm_fn=self.global_norm if self.active else None, tp_dims=tp_dims or None,
                    stack_group=self.pp_group if self.pp > 1 else None)

    # ---------------------------------------------------------------- norm
    def global_norm(self, grads) -> torch.Tensor:
        """The logical gradients' global norm from this rank's ``grads``
        (aligned with ``live``)."""
        norms = torch.stack([n.float() for n in torch._foreach_norm(list(grads))])
        w = torch.tensor([self.weight[n] for n in self.live], device=norms.device)
        sq = (norms.square() * w).sum()
        dist.all_reduce(sq, group=self.norm_group)
        return sq.sqrt()

    # ------------------------------------------------------------- layouts
    def _full(self, name: str, t: torch.Tensor | None, device) -> torch.Tensor:
        """The one-device tensor of ``name`` from this rank's part ``t``
        (None on a stage that does not hold it)."""
        stage = self.stage_of[name]
        if t is not None and self.tp_dim[name] is not None and self.tp > 1:
            t = M.gather_dim(t, self.tp_dim[name], self.tp_group)
        if stage is None or self.pp == 1:
            return t
        if t is None:
            t = torch.empty(self.shapes[name], dtype=self.dtypes[name], device=device)
        t = t.contiguous()
        dist.broadcast(t, src=dist.get_global_rank(self.pp_group, stage), group=self.pp_group)
        return t

    def gather_live(self, tensors, device) -> list:
        """Tensors shaped as this rank's live parameters (aligned with
        ``live``) -> the one-device tensors of every parameter (aligned with
        ``names``)."""
        mine = dict(zip(self.live, tensors))
        return [self._full(n, mine.get(n), device) for n in self.names]

    def full_state_dict(self, model: torch.nn.Module) -> dict:
        """``model.state_dict()`` in the one-device layout."""
        sd = model.state_dict()
        dev = next(t.device for t in sd.values())
        full = dict(zip(self.names, self.gather_live([sd[n] for n in self.live], dev)))
        return {k: full.get(k, v) for k, v in sd.items()}

    def local(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's part of the one-device tensor ``full`` of ``name``."""
        d = self.tp_dim[name]
        if d is None or self.tp == 1:
            return full
        per = full.shape[d] // self.tp
        return full.narrow(d, self.tp_rank * per, per)

    # ------------------------------------------------------------ optimizer
    def full_optimizer_state(self, sd: dict, whole_tp_state: bool) -> dict:
        """An optimizer state dict over ``live`` (``train/step.Optimizer``'s,
        ZeRO-1 already gathered) -> the one-device layout over ``names``.
        ``whole_tp_state``: the state of a sharded parameter is already whole
        (Adafactor's); else tensors shaped as the parameter gather as it."""
        mine = {}
        for li, name in enumerate(self.live):
            if li not in sd["state"]:
                continue
            entry = {}
            for k, v in sd["state"][li].items():
                if (torch.is_tensor(v) and not whole_tp_state and self.tp > 1
                        and self.tp_dim[name] is not None and v.dim() > 0):
                    v = M.gather_dim(v, self.tp_dim[name], self.tp_group)
                entry[k] = v.cpu() if torch.is_tensor(v) else v
            mine[self.names.index(name)] = entry
        if self.pp > 1:
            parts: list = [None] * self.pp
            dist.all_gather_object(parts, mine, group=self.pp_group)
            mine = {}
            for p in parts:
                mine.update(p)
        groups = [dict(g, params=list(range(len(self.names)))) for g in sd["param_groups"]]
        return {"state": dict(sorted(mine.items())), "param_groups": groups}

    def live_optimizer_state(self, sd: dict, whole_tp_state: bool) -> dict:
        """The inverse of ``full_optimizer_state``: this rank's part."""
        state = {}
        for li, name in enumerate(self.live):
            j = self.names.index(name)
            if j not in sd["state"]:
                continue
            state[li] = {k: (self.local(name, v) if torch.is_tensor(v) and not whole_tp_state
                             and v.dim() > 0 else v).clone() if torch.is_tensor(v) else v
                         for k, v in sd["state"][j].items()}
        groups = [dict(g, params=list(range(len(self.live)))) for g in sd["param_groups"]]
        return {"state": state, "param_groups": groups}
