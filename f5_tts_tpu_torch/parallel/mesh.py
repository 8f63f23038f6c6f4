"""Device meshes and the sharding rules: parameters, optimizer state, batches.

JAX counterpart: ``f5_tts_tpu/parallel/mesh.py``.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` whose dimensions are named
from ``data``, ``seq`` and ``model`` (outer to inner), over the processes of
the default group: one device per process.  Where JAX gives a leaf a
``PartitionSpec`` and lets GSPMD place it, the port states the same rule as
DTensor placements per tensor and applies it by hand:

- ``backbone_param_specs``: JAX's Megatron column / row rule, written in the
  port's ``state_dict`` keys and torch's ``[out, in]`` layout: ``Shard(0)``
  for the weight and bias of a column-parallel linear (attention q, k, v,
  also MMDiT's ``*_c``; the FF input), ``Shard(1)`` for the weight of a
  row-parallel one (``to_out``, ``to_out_c``, the FF output), ``Replicate()``
  elsewhere.  Applying it is tensor parallelism, the next slice.
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
PIPE_AXIS = "pipe"  # the pipeline stages (the next slice)
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
    (JAX ``make_train_mesh``)."""
    if pipe > 1:
        raise NotImplementedError("the pipeline axis is the next slice of the port "
                                  "(tensor parallel and the pipeline; see ROADMAP.md)")
    if data is None:
        data = dist.get_world_size() // (model * seq)
    shape, names = [data], [DATA_AXIS]
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


def mesh_group(mesh: DeviceMesh):
    """The group of all of the mesh's ranks (the data x seq gradient sum):
    the default group when the mesh spans it."""
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
