"""Multi-process start-up: one process per GPU.

JAX counterpart: ``f5_tts_tpu/parallel/distributed.py``.  JAX starts one
controller per host (``jax.distributed.initialize``); the port starts one
process per card, under ``torchrun`` or by hand, and joins them in the
default ``torch.distributed`` process group: NCCL for CUDA tensors, gloo for
CPU tensors.

    torchrun --nproc_per_node=4 -m f5_tts_tpu_torch.train.cli --sequence_parallel 2

``init_distributed`` reads ``torchrun``'s ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``, or takes the
coordinator's address, the process count and this process's index from its
caller, as JAX's does.  It binds ``cuda:LOCAL_RANK`` and returns JAX's
topology dict.  Without a GPU it raises, as every entry point of the port
does, unless the caller names the CPU (gloo).

``p2p`` posts point-to-point transfers on a group for the ring
(``parallel/ring.py``) and the pipeline (``parallel/pipeline.py``).  gloo
carries no CUDA tensor point-to-point, so on gloo a CUDA tensor goes
through host memory (a copy to the host, the transfer, a copy back at the
wait); on NCCL it goes device to device.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from f5_tts_tpu_torch.utils.device import resolve_device


def _topology(device: torch.device) -> dict:
    world = dist.get_world_size() if dist.is_initialized() else 1
    return {
        "process_index": dist.get_rank() if dist.is_initialized() else 0,
        "process_count": world,
        "local_devices": 1,  # one device per process
        "global_devices": world,
        "device": str(device),
        "backend": dist.get_backend() if dist.is_initialized() else None,
    }


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     device: str | None = None,
                     backend: str | None = None) -> dict:
    """Join this process to the default process group; returns the topology.

    ``coordinator_address``: ``host:port`` of rank 0 (``tcp://``), or any
    ``torch.distributed`` init URL (``file://...``); with it, or with
    ``num_processes``, the arguments replace ``torchrun``'s environment.
    With neither and no ``WORLD_SIZE`` in the environment the process runs
    alone and no group starts (JAX's single-host case).  ``device``: ``None``
    or ``"cuda"`` binds ``cuda:LOCAL_RANK``; ``"cuda:K"`` binds card K (two
    ranks may share one card over gloo, never over NCCL); ``"cpu"`` runs on
    gloo.  ``backend``: NCCL for a card and gloo for the CPU unless named.
    """
    dev = resolve_device(device, "init_distributed")
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return _topology(dev)
    explicit = coordinator_address is not None or num_processes is not None
    if not explicit and "WORLD_SIZE" not in os.environ:
        return _topology(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if explicit:
        if coordinator_address is None:
            coordinator_address = (f"{os.environ.get('MASTER_ADDR', 'localhost')}:"
                                   f"{os.environ.get('MASTER_PORT', '29500')}")
        url = coordinator_address if "://" in coordinator_address \
            else f"tcp://{coordinator_address}"
        dist.init_process_group(backend, init_method=url,
                                world_size=int(num_processes if num_processes is not None
                                               else os.environ["WORLD_SIZE"]),
                                rank=int(process_id if process_id is not None
                                         else os.environ.get("RANK", "0")),
                                device_id=dev if backend == "nccl" else None)
    else:
        dist.init_process_group(backend, init_method="env://",
                                device_id=dev if backend == "nccl" else None)
    return _topology(dev)


def process_batch_slice(global_batch: int, mesh=None) -> tuple[int, int]:
    """(start, size) of this rank's contiguous rows of a globally sized batch:
    its coordinate on ``mesh``'s ``data`` axis, or its process rank without a
    mesh.  ``global_batch`` must divide over the data ranks."""
    from f5_tts_tpu_torch.parallel.mesh import data_rank_and_size

    rank, size = data_rank_and_size(mesh)
    if global_batch % size:
        raise ValueError(f"batch {global_batch} does not divide over {size} data ranks")
    per = global_batch // size
    return rank * per, per


class Transfers:
    """Point-to-point transfers in flight (``p2p``): ``wait()`` waits for
    them and, where they went through host memory, copies each received
    host buffer into its tensor.  The host buffers live until then."""

    def __init__(self, works, sends, pairs):
        self.works, self.sends, self.pairs = works, sends, pairs

    def wait(self) -> None:
        for w in self.works:
            w.wait()
        for dst, src in self.pairs:
            dst.copy_(src)
        self.works, self.sends, self.pairs = [], [], []


def p2p(group, sends=(), recvs=()) -> Transfers:
    """Post ``isend`` for each (tensor, global peer rank, tag) of ``sends``
    and ``irecv`` into each (tensor, peer, tag) of ``recvs`` on ``group``
    (several as one ``batch_isend_irecv``).  The received tensors are
    filled once the returned ``Transfers`` is waited on."""
    staged = (any(t.is_cuda for t, _, _ in (*sends, *recvs))
              and dist.get_backend(group) != "nccl")
    host_sends = [(t.cpu() if staged else t, peer, tag) for t, peer, tag in sends]
    host_recvs = [(torch.empty(t.shape, dtype=t.dtype) if staged else t, peer, tag)
                  for t, peer, tag in recvs]
    ops = ([(dist.isend, *x) for x in host_sends]
           + [(dist.irecv, *x) for x in host_recvs])
    if len(ops) == 1:
        op, t, peer, tag = ops[0]
        works = [op(t, peer, group, tag)]
    else:
        works = dist.batch_isend_irecv([dist.P2POp(op, t, peer, group, tag)
                                        for op, t, peer, tag in ops])
    pairs = [(t, h) for (t, _, _), (h, _, _) in zip(recvs, host_recvs)] if staged else []
    return Transfers(works, [t for t, _, _ in host_sends], pairs)
