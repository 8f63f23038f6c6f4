"""Device meshes and the sharding rules: parameters, optimizer state, batches.

JAX counterpart: ``f5_tts_tpu/parallel/mesh.py``.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` whose dimensions are named
from ``data``, ``seq`` and ``model`` (outer to inner), over the processes of
the default group: one device per process.  Where JAX gives a leaf a
``PartitionSpec`` and lets GSPMD place it, the port states the same rule as
DTensor placements per tensor and applies it by hand (axes, outer to inner:
``data``, ``pipe``, ``seq``, ``model``):

- ``backbone_param_specs``: JAX's Megatron column / row rule, written in the
  port's ``state_dict`` keys and torch's ``[out, in]`` layout: ``Shard(0)``
  for the weight and bias of a column-parallel linear (attention q, k, v,
  also MMDiT's ``*_c``; the FF input), ``Shard(1)`` for the weight of a
  row-parallel one (``to_out``, ``to_out_c``, the FF output), ``Replicate()``
  elsewhere.  ``shard_params`` applies it: this rank's slices, and a
  ``parallel/tensor.TensorParallel`` on every attention and feed-forward
  module, which then runs its share of the heads and columns.
- ``zero1_state_specs`` / ``shard_opt_state``: ZeRO-1, "shard the leading
  axis over ``data`` where it divides, else replicate", on the port's own
  tensor layout (``train/step.py`` updates each rank's shard).
- ``batch_sharding``: the rows of a batch over ``data``.
"""

from __future__ import annotations

import re

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

DATA_AXIS = "data"
MODEL_AXIS = "model"
PIPE_AXIS = "pipe"  # the pipeline stages (parallel/pipeline.py)
SEQ_AXIS = "seq"  # sequence parallelism (parallel/sequence.py)


def _device_type() -> str:
    """The mesh's device type: ``cuda`` on NCCL; ``cpu`` on gloo, which also
    carries CUDA tensors (the mesh only names the groups; every collective
    is called on them explicitly)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _mesh(shape: list[int], names: list[str], device_type: str | None) -> DeviceMesh:
    n = dist.get_world_size()
    total = 1
    for s in shape:
        total *= s
    if total != n:
        raise ValueError(f"mesh {'x'.join(map(str, shape))} ({', '.join(names)}) needs {total} "
                         f"processes; the group has {n}")
    return init_device_mesh(device_type or _device_type(), tuple(shape),
                            mesh_dim_names=tuple(names))


def make_mesh(data: int | None = None, model: int = 1, device_type: str | None = None
              ) -> DeviceMesh:
    """Mesh [data, model] over the default group's processes; ``data``
    defaults to world // model."""
    if data is None:
        data = dist.get_world_size() // model
    return _mesh([data, model], [DATA_AXIS, MODEL_AXIS], device_type)


def make_train_mesh(data: int | None = None, model: int = 1, pipe: int = 1, seq: int = 1,
                    device_type: str | None = None) -> DeviceMesh:
    """Training mesh, outer to inner: data, (pipe), (seq), model; ``pipe``
    and ``seq`` exist only above 1, so the two-axis case is ``make_mesh``'s
    (JAX ``make_train_mesh``).  The tensor-parallel collectives ride the
    innermost axis, the pipeline's point-to-point transfers sit outside."""
    if data is None:
        data = dist.get_world_size() // (model * pipe * seq)
    shape, names = [data], [DATA_AXIS]
    if pipe > 1:
        shape.append(pipe)
        names.append(PIPE_AXIS)
    if seq > 1:
        shape.append(seq)
        names.append(SEQ_AXIS)
    shape.append(model)
    names.append(MODEL_AXIS)
    return _mesh(shape, names, device_type)


def axis_size(mesh: DeviceMesh | None, axis: str) -> int:
    """The mesh's size along ``axis``; 1 without a mesh or without the axis."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_group(mesh: DeviceMesh | None, axis: str):
    """The process group of this rank's line along ``axis``, or None when
    the axis has one rank (no collective is needed)."""
    if axis_size(mesh, axis) == 1:
        return None
    return mesh.get_group(axis)


def data_rank_and_size(mesh: DeviceMesh | None) -> tuple[int, int]:
    """This rank's coordinate on ``data`` and the axis size; without a mesh
    the process rank and the world size (1 and 0 when no group runs)."""
    if mesh is not None:
        if DATA_AXIS not in (mesh.mesh_dim_names or ()):
            return 0, 1
        return mesh.get_local_rank(DATA_AXIS), axis_size(mesh, DATA_AXIS)
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def axis_rank(mesh: DeviceMesh | None, axis: str) -> int:
    """This rank's coordinate on ``axis`` (0 without a mesh or the axis)."""
    if axis_size(mesh, axis) == 1:
        return 0
    return mesh.get_local_rank(axis)


def axes_group(mesh: DeviceMesh, axes: tuple[str, ...]):
    """The process group of the ranks that share this rank's coordinates on
    every axis but ``axes`` (e.g. ``(data, seq)``: the gradient sum), or
    None when it holds one rank.  Every rank makes every such group, in one
    order, at its first call on the mesh (kept on the mesh): call it at the
    same point on every rank."""
    names = list(mesh.mesh_dim_names or ())
    sel = [names.index(a) for a in axes if a in names]
    size = 1
    for i in sel:
        size *= mesh.size(i)
    if size == 1:
        return None
    cache = mesh.__dict__.setdefault("_axes_groups", {})
    if tuple(sel) not in cache:
        rest = [i for i in range(len(names)) if i not in sel]
        lines = mesh.mesh.permute(*rest, *sel).reshape(-1, size).tolist()
        me = dist.get_rank()
        for ranks in lines:
            g = dist.new_group(ranks)
            if me in ranks:
                cache[tuple(sel)] = g
    return cache[tuple(sel)]


def mesh_group(mesh: DeviceMesh):
    """The group of all of the mesh's ranks: the default group when the
    mesh spans it."""
    ranks = sorted(mesh.mesh.flatten().tolist())
    if ranks == list(range(dist.get_world_size())):
        return dist.group.WORLD
    return dist.new_group(ranks)


# column-parallel projections (shard the output features): attention q, k, v
# and MMDiT's text-stream *_c, the FF input; row-parallel: to_out(_c), the FF
# output (JAX _COL_KEYS / _FF_KEYS / _tp_param_spec)
_COL = re.compile(r"(^|\.)(to_[qkv](_c)?|ff\.0\.0)$")
_ROW = re.compile(r"(^|\.)(to_out\.0|to_out_c|ff\.2)$")


def _tp_param_spec(key: str):
    module, _, leaf = key.rpartition(".")
    if _COL.search(module) and leaf in ("weight", "bias"):
        return Shard(0)  # torch [out, in]: the output features are dim 0
    if _ROW.search(module) and leaf == "weight":
        return Shard(1)
    return Replicate()


def backbone_param_specs(params) -> dict:
    """Placement over ``model`` of every backbone tensor (DiT, UNetT, MMDiT):
    ``params`` is a backbone ``nn.Module`` or its ``state_dict``; returns
    {key: Shard(dim) | Replicate()} (JAX ``backbone_param_specs``)."""
    keys = params.state_dict().keys() if isinstance(params, torch.nn.Module) else params.keys()
    return {k: _tp_param_spec(k) for k in keys}


dit_param_specs = backbone_param_specs  # JAX's historical name


def shard_params(backbone: torch.nn.Module, mesh: DeviceMesh, specs: dict | None = None
                 ) -> torch.nn.Module:
    """Turn ``backbone`` into this rank's tensor-parallel shard, in place
    (JAX ``shard_params`` under ``backbone_param_specs``): each ``Shard(d)``
    tensor becomes its slice along ``d`` for the rank's coordinate on
    ``model``, each ``Replicate()`` one stays whole, and every attention and
    feed-forward module gets the ``TensorParallel`` that makes it run its
    share.  A module holding W8A8 weights stays whole on every rank, as
    JAX's replicated ``kernel_q`` (module docstring of ``infer/serve.py``).
    A fused qkv is rebuilt from this rank's q, k and v slices.  Returns
    ``backbone``; with one rank on ``model`` it is unchanged."""
    from f5_tts_tpu_torch.models.layers import Attention
    from f5_tts_tpu_torch.parallel.tensor import TensorParallel

    group = axis_group(mesh, MODEL_AXIS)
    if group is None:
        return backbone
    tp = TensorParallel(group)
    specs = specs if specs is not None else backbone_param_specs(backbone)
    whole = set()  # W8A8 modules: every tensor below them stays whole
    for name, m in backbone.named_modules():
        if _tp_module(m) and any(getattr(c, "weight_q", None) is not None
                                 or getattr(c, "qkv_weight_q", None) is not None
                                 for c in m.modules()):
            whole.add(name)

    def kept(key: str) -> bool:
        return any(key.startswith(w + ".") for w in whole if w)

    named = dict(backbone.named_parameters())
    with torch.no_grad():
        for key, spec in specs.items():
            if isinstance(spec, Shard) and key in named and not kept(key):
                p = named[key]
                per = p.shape[spec.dim] // tp.size
                if per * tp.size != p.shape[spec.dim]:
                    raise ValueError(f"{key} {tuple(p.shape)}: dim {spec.dim} does not divide "
                                     f"over the model axis {tp.size}")
                p.data = p.data.narrow(spec.dim, tp.rank * per, per).clone()
    for name, m in backbone.named_modules():
        if _tp_module(m) and name not in whole:
            m.tp = tp
            if isinstance(m, Attention) and m.qkv_weight is not None:
                m.fuse_qkv()
    return backbone


def _tp_module(m) -> bool:
    from f5_tts_tpu_torch.models.layers import Attention, FeedForward
    from f5_tts_tpu_torch.models.mmdit import JointAttention

    return isinstance(m, (Attention, FeedForward, JointAttention))


def zero1_state_specs(opt_state, mesh: DeviceMesh | None = None, dp: int | None = None):
    """ZeRO-1 placement over ``data`` of each optimizer-state tensor (a list
    or a dict of tensors): ``Shard(0)`` where the leading axis divides by the
    data size, else ``Replicate()`` (scalars, counts)."""
    dp = dp if dp is not None else axis_size(mesh, DATA_AXIS)

    def spec(t):
        shape = tuple(getattr(t, "shape", ()))
        if len(shape) >= 1 and shape[0] > 0 and shape[0] % dp == 0:
            return Shard(0)
        return Replicate()

    if isinstance(opt_state, dict):
        return {k: spec(v) for k, v in opt_state.items()}
    return [spec(t) for t in opt_state]


def shard_rows(t: torch.Tensor, rank: int, dp: int) -> torch.Tensor:
    """Rank ``rank``'s rows of ``t`` under ``Shard(0)`` over ``dp`` ranks: a view."""
    per = t.shape[0] // dp
    return t.narrow(0, rank * per, per)


def gather_dim(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The whole tensor of ``group``'s slices of ``t`` along ``dim``, rank r's
    the r-th (an all-gather)."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def shard_opt_state(opt_state, mesh: DeviceMesh):
    """This rank's part of each tensor under ``zero1_state_specs``: its rows
    where the state shards, the whole tensor where it replicates."""
    rank, dp = data_rank_and_size(mesh)
    specs = zero1_state_specs(opt_state, dp=dp)
    if isinstance(opt_state, dict):
        return {k: shard_rows(v, rank, dp) if isinstance(specs[k], Shard) else v
                for k, v in opt_state.items()}
    return [shard_rows(t, rank, dp) if isinstance(s, Shard) else t
            for t, s in zip(opt_state, specs)]


def batch_sharding(mesh: DeviceMesh) -> tuple:
    """DTensor placements of a [batch, ...] tensor on ``mesh``: rows over
    ``data``, replicated over the other axes (JAX ``P(DATA_AXIS)``)."""
    return tuple(Shard(0) if name == DATA_AXIS else Replicate()
                 for name in mesh.mesh_dim_names)
