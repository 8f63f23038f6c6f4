"""Trainer: the single-device training loop.

JAX counterpart: ``f5_tts_tpu/train/trainer.py:51-609``.  What it keeps:

- a producer thread (load + collate on the host) and an uploader thread
  (pinned host memory, ``non_blocking`` copies on CUDA) ahead of the step
  loop; an exception in either poisons its queue and is raised in the loop;
- ``mel_in_graph``: the producer only decodes and pads the waveforms
  (``CustomDataset.wav_batch``, ``collate_wav_batch``) and the step takes
  the log-mel on the device;
- activation checkpointing (``arch.checkpoint_activations``) under its
  ``remat_policy``, ``auto`` resolved from the per-device frame budget
  (``models/remat.resolve_remat_policy``);
- AdamW or Adafactor (``OptimConfig.optimizer``);
- ``total_updates`` derived from the run length when not pinned;
- checkpoints ``model_{update}.pt`` (rotated to ``keep_last_n_checkpoints``;
  ``pretrained_*`` files never rotate) and ``model_last.pt``, in the
  reference's ``.pt`` layout, written asynchronously
  (``utils/ckpt.CheckpointWriter``: a device -> host snapshot into reused
  pinned buffers, then a writer thread); loading, rotation, the end of
  ``train`` and the SIGTERM save wait for the write;
- resume from ``model_last.pt`` (else the newest ``model_N.pt``) at the exact
  micro-step, with the sampler fast-forwarded;
- the JSONL log, plus ``wandb`` or ``tensorboard`` (``tensorboardX``, under
  ``<ckpt_dir>/runs``) when the package imports (else that logger stays
  off, as in JAX), the SIGTERM save (finish the step, write
  ``model_last.pt``, return), and ``log_samples_fn(ema_model, update,
  model)`` at each save.

Each micro-step's generators are seeded from ``(seed, micro_step)`` alone,
so a resumed run draws what an uninterrupted one draws.  The trainer runs
on the card: ``device=None`` means ``"cuda"``.

Over a mesh (``parallel/mesh.make_train_mesh``, one process per device,
started by ``parallel/distributed.init_distributed``), as JAX :121-125,
434-470, 505-530:

- every rank walks the same sampler order; each data rank collates only
  its contiguous rows of each global batch, padded to a multiple of the
  data size with ``valid = 0`` duplicates and to the batch's global padded
  width, so every rank has the same shapes and draws for its rows what the
  one-process run draws there (``cfm.loss`` ``rows``); the gradients are
  summed over the data (and seq) ranks before the clip (``train/step.py``);
- ``zero1`` shards the optimizer's state over ``data``: AdamW's moments or
  Adafactor's statistics (``train/step.Optimizer``); a checkpoint holds them
  gathered, so it resumes under any data size;
- ``tensor_parallel`` (a ``model`` axis) splits every block's attention
  heads and feed-forward columns over ``model`` (``parallel/tensor.py``),
  and ``pipeline_microbatches = M`` (a ``pipe`` axis; DiT) runs the blocks
  as a GPipe pipeline of M microbatches over ``pipe``
  (``parallel/pipeline.py``), JAX :117-181, 354-369: the rows of each
  global batch are padded to a multiple of data x M; the parameters are
  placed by ``parallel/layout.ModelLayout`` (each rank its slices and its
  stage's blocks), the gradients summed over data x seq alone, the clip
  reads the logical global norm, and every checkpoint is written in the
  one-device layout, gathered from the shards, so a model trained under
  tp x pp loads into a one-device ``F5TTS``, and resumes under any mesh;
  with ``seq`` too the pipeline runs ring attention in each tick (pp x sp);
- ``sequence_parallel`` splits the frames over ``seq`` on ring attention
  (``parallel/sequence.py``, ``parallel/ring.py``): DiT only, as in JAX,
  whose UNetT and MMDiT take no activation constraint;
- ``convpos_taps`` is accepted for JAX's signature and routes nothing: JAX's
  per-tap ConvPositionEmbedding is the function that kernel B and its plain
  version already compute (``models/layers.conv_pos_embed_taps``);
- rank 0 writes the checkpoints, the JSONL log and the loggers; a SIGTERM
  on any rank makes every rank save and stop at the same micro-step.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import os
import queue
import signal
import threading
import time

import numpy as np
import torch

from f5_tts_tpu_torch.models.remat import resolve_remat_policy
from f5_tts_tpu_torch.parallel import mesh as M
from f5_tts_tpu_torch.parallel.distributed import process_batch_slice
from f5_tts_tpu_torch.train.dataset import (DynamicBatchSampler, SampleBatchSampler,
                                            collate_batch, collate_wav_batch, pad_frames_to)
from f5_tts_tpu_torch.train.step import OptimConfig, make_optimizer, train_step
from f5_tts_tpu_torch.utils.ckpt import CheckpointWriter, stacked_leaf, train_checkpoint
from f5_tts_tpu_torch.utils.device import resolve_device

def micro_step_seed(seed: int, micro: int) -> int:
    """The generator seed of micro-step ``micro`` of a run seeded ``seed``."""
    return int(np.random.SeedSequence([seed, micro]).generate_state(1)[0])


class Trainer:
    def __init__(
        self,
        model_cfg,  # models.configs.ModelConfig
        vocab: dict | None,
        opt_cfg: OptimConfig = OptimConfig(),
        ckpt_dir: str = "ckpts/run",
        batch_size_per_device: int = 38_400,
        batch_size_type: str = "frame",
        max_samples: int = 64,
        grad_accumulation_steps: int = 1,
        save_per_updates: int = 50_000,
        keep_last_n_checkpoints: int = -1,
        last_per_updates: int = 5_000,
        log_file: str | None = None,
        logger: str | None = None,
        mesh=None,
        seed: int = 666,
        log_samples_fn=None,  # callback(ema_model, update, model), at each save
        zero1: bool = False,
        tensor_parallel: bool = False,
        pipeline_microbatches: int = 0,
        sequence_parallel: bool = False,
        convpos_taps: bool | None = None,
        mel_in_graph: bool = False,
        preemption_save: bool = True,
        device: str | None = None,
        log_every_updates: int = 10,  # the JSONL log's cadence (and update 1)
    ):
        if mesh is not None:
            from torch.distributed.device_mesh import DeviceMesh

            if not isinstance(mesh, DeviceMesh):
                raise TypeError(f"mesh must be a torch DeviceMesh (parallel/mesh.py), "
                                f"got {type(mesh).__name__}")
        mesh_axes = set(mesh.mesh_dim_names) if mesh is not None else set()
        self.mesh = mesh
        self.dp = M.axis_size(mesh, M.DATA_AXIS)
        self.sequence_parallel = bool(sequence_parallel) and M.SEQ_AXIS in mesh_axes
        if self.sequence_parallel and model_cfg.arch.backbone != "DiT":
            raise ValueError(f"sequence_parallel runs DiT only ({model_cfg.arch.backbone} takes "
                             "no activation constraint, in JAX either)")
        self.tensor_parallel = bool(tensor_parallel) and M.axis_size(mesh, M.MODEL_AXIS) > 1
        # JAX :121: the microbatches count only with a pipe axis
        self.pipeline_microbatches = (int(pipeline_microbatches) if M.PIPE_AXIS in mesh_axes
                                      else 0)
        if self.pipeline_microbatches and model_cfg.arch.backbone != "DiT":
            raise ValueError(f"the pipeline runs DiT only ({model_cfg.arch.backbone}'s forward "
                             "takes no block_scan, in JAX either)")
        self.zero1 = bool(zero1) and self.dp > 1
        self.convpos_taps = bool(convpos_taps)  # routes nothing (module docstring)
        self.is_main = mesh is None or torch.distributed.get_rank() == 0
        if logger not in (None, "wandb", "tensorboard"):
            raise ValueError(f"unknown logger {logger!r} (wandb | tensorboard)")
        if grad_accumulation_steps > 1 and opt_cfg.grad_accumulation_steps == 1:
            opt_cfg = dataclasses.replace(opt_cfg, grad_accumulation_steps=grad_accumulation_steps)
        self.device = resolve_device(device, "Trainer")
        model_cfg = resolve_remat_policy(model_cfg, batch_size_per_device, batch_size_type)
        self.model_cfg = model_cfg
        self.vocab = vocab
        self.opt_cfg = opt_cfg
        self.ckpt_dir = ckpt_dir
        self.batch_size_per_device = batch_size_per_device
        self.batch_size_type = batch_size_type
        self.max_samples = max_samples
        self.save_per_updates = save_per_updates
        self.keep_last_n_checkpoints = keep_last_n_checkpoints
        self.last_per_updates = last_per_updates
        self.seed = seed
        self.log_samples_fn = log_samples_fn
        self.preemption_save = preemption_save
        self.log_every_updates = log_every_updates
        self.mel_in_graph = mel_in_graph
        self.writer = CheckpointWriter()
        self._groups = None  # (data, data x seq, all) process groups, made in train()
        self.layout = None  # parallel/layout.ModelLayout under tensor or pipeline parallelism
        os.makedirs(ckpt_dir, exist_ok=True)
        self.log_file = log_file or os.path.join(ckpt_dir, "train_log.jsonl")
        self.wandb = None
        self.tb_writer_cls = None  # a writer is open under <ckpt_dir>/runs while train() runs
        self.tb_writer = None
        if logger == "wandb":  # JAX trainer.py:129-146: a logger whose package is missing stays off
            try:
                import wandb

                self.wandb = wandb
            except ImportError:
                pass
        elif logger == "tensorboard":  # the reference writes under <ckpt_dir>/runs
            try:
                from tensorboardX import SummaryWriter

                self.tb_writer_cls = SummaryWriter
            except ImportError:
                pass

    # ------------------------------------------------------------------ ckpt
    def _ckpt_path(self, tag) -> str:
        return os.path.join(self.ckpt_dir, f"model_{tag}.pt")

    def _numbered(self) -> list[str]:
        names = [f for f in os.listdir(self.ckpt_dir)
                 if f.startswith("model_") and f.endswith(".pt") and f[6:-3].isdigit()]
        return sorted(names, key=lambda f: int(f[6:-3]))

    def save_checkpoint(self, model, ema_model, optimizer, micro: int, update: int,
                        last: bool = False, block: bool = False) -> None:
        """Start the write of ``model_{update}.pt`` (or ``model_last.pt``);
        the rotation of the numbered files runs after it, on the writer."""
        acc = optimizer.accumulation_state()
        opt_state = optimizer.state_dict()  # under ZeRO-1 a gather: every rank calls it
        lay = self.layout
        if lay is not None:  # the one-device layout, gathered from the shards (collectives)
            dev = next(model.parameters()).device
            opt_state = lay.full_optimizer_state(
                opt_state, whole_tp_state=self.opt_cfg.optimizer == "adafactor")
            model, ema_model = lay.full_state_dict(model), lay.full_state_dict(ema_model)
            if acc is not None:
                acc = dict(acc, grads=lay.gather_live(acc["grads"], dev))
        if not self.is_main:
            return
        obj = train_checkpoint(model, ema_model, opt_state,
                               optimizer.scheduler.state_dict(), micro, update,
                               extra=None if acc is None else {"grad_accumulation": acc})
        rotate = not last and self.keep_last_n_checkpoints >= 0
        self.writer.save(self._ckpt_path("last" if last else update), obj,
                         after=self._rotate if rotate else None, block=block)

    def _rotate(self) -> None:
        """Drop the oldest ``model_N.pt`` beyond ``keep_last_n_checkpoints``
        (an in-flight temporary name never matches; ``pretrained_*`` never)."""
        numbered = self._numbered()
        keep = self.keep_last_n_checkpoints
        for f in numbered[:len(numbered) - keep] if keep else numbered:
            os.remove(os.path.join(self.ckpt_dir, f))

    def load_checkpoint(self) -> dict | None:
        self.writer.wait()  # never read under an in-flight write
        path = self._ckpt_path("last")
        if not os.path.exists(path):
            numbered = self._numbered()
            if not numbered:
                return None
            path = os.path.join(self.ckpt_dir, numbered[-1])
        return torch.load(path, map_location="cpu", weights_only=True)

    # ------------------------------------------------------------------ log
    def _log(self, rec: dict) -> None:
        if not self.is_main:
            return
        with open(self.log_file, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self.wandb is not None and getattr(self.wandb, "run", None):
            self.wandb.log(rec, step=rec.get("update"))
        if self.tb_writer is not None:
            step = rec.get("update", 0)
            for k, v in rec.items():
                if isinstance(v, (int, float)) and k != "update":
                    self.tb_writer.add_scalar(k, v, global_step=step)
            self.tb_writer.flush()

    # ---------------------------------------------------------------- train
    def train(self, model, dataset, epochs: int = 1, resume: bool = True):
        """Runs the loop on ``model`` (a ``models.cfm.CFM``, moved to the
        trainer's device); returns (model, ema_model, update).

        On SIGTERM (installed only from the main thread) the in-flight step
        finishes, ``model_last.pt`` is written and train() returns; a later
        ``resume=True`` run continues from that micro-step.
        """
        preempt = {"hit": False}
        old = None
        if self.preemption_save and threading.current_thread() is threading.main_thread():
            old = signal.signal(signal.SIGTERM, lambda s, f: preempt.update(hit=True))
        if self.tb_writer_cls is not None:
            self.tb_writer = self.tb_writer_cls(logdir=os.path.join(self.ckpt_dir, "runs"))
        try:
            return self._train_impl(model, dataset, epochs, resume, preempt)
        finally:
            if old is not None:
                signal.signal(signal.SIGTERM, old)
            if self.tb_writer is not None:  # close() writes the events still queued
                self.tb_writer.close()
                self.tb_writer = None

    def _sampler(self, dataset):
        if self.batch_size_type == "sample":
            return SampleBatchSampler(dataset, batch_size=self.batch_size_per_device,
                                      random_seed=self.seed)
        return DynamicBatchSampler(dataset, frames_threshold=self.batch_size_per_device,
                                   max_samples=self.max_samples, random_seed=self.seed)

    def _train_impl(self, model, dataset, epochs, resume, preempt):
        sampler = self._sampler(dataset)
        if self.opt_cfg.total_updates is None:
            # the LR decay horizon from the run length (reference trainer.py:316-326)
            k = max(self.opt_cfg.grad_accumulation_steps, 1)
            total = max(math.ceil(len(sampler) / k) * max(epochs, 1),
                        self.opt_cfg.num_warmup_updates + 1)
            self.opt_cfg = dataclasses.replace(self.opt_cfg, total_updates=total)
        model = model.to(self.device)
        ema_model = copy.deepcopy(model).requires_grad_(False)
        if self.mesh is not None and self._groups is None:
            self._groups = (M.axis_group(self.mesh, M.DATA_AXIS),
                            M.axes_group(self.mesh, (M.DATA_AXIS, M.SEQ_AXIS)),
                            M.mesh_group(self.mesh))
        data_group, grad_group, all_group = self._groups or (None, None, None)
        ckpt = self.load_checkpoint() if resume else None
        if ckpt is not None:  # the one-device layout, before any sharding
            model.load_state_dict(ckpt["model_state_dict"])
            ema_model.load_state_dict({k[len("ema_model."):]: v
                                       for k, v in ckpt["ema_model_state_dict"].items()
                                       if k.startswith("ema_model.")})
        lay = None
        if self.tensor_parallel or self.pipeline_microbatches:  # JAX :354-369
            from f5_tts_tpu_torch.parallel.layout import ModelLayout

            lay = ModelLayout(model, self.mesh, tensor_parallel=self.tensor_parallel,
                              pipeline=bool(self.pipeline_microbatches))
            lay.apply_(model)
            lay.apply_(ema_model)
        self.layout = lay
        names = [n for n, _ in model.named_parameters()] if lay is None else lay.live
        params = list(model.parameters()) if lay is None else lay.live_params(model)
        optimizer = make_optimizer(params, self.opt_cfg,
                                   zero1_group=data_group if self.zero1 else None, layout=lay,
                                   stacks=[stacked_leaf(n, self.model_cfg.arch) for n in names])
        self.optimizer = optimizer  # the last run's, for inspection
        micro = 0
        if ckpt is not None:
            opt_sd, acc = ckpt["optimizer_state_dict"], ckpt.get("grad_accumulation")
            if lay is not None:
                opt_sd = lay.live_optimizer_state(
                    opt_sd, whole_tp_state=self.opt_cfg.optimizer == "adafactor")
                if acc is not None:
                    full = dict(zip(lay.names, acc["grads"]))
                    acc = dict(acc, grads=[lay.local(n, full[n]) for n in lay.live])
            optimizer.load_state_dict(opt_sd)
            optimizer.scheduler.load_state_dict(ckpt["scheduler_state_dict"])
            optimizer.load_accumulation_state(acc)
            micro = int(ckpt["step"])
            print(f"resumed at micro-step {micro} (update {micro // optimizer.k})")
        k_accum = optimizer.k
        update = micro // k_accum
        batches_per_epoch = max(len(sampler), 1)
        skip = micro % batches_per_epoch
        start_epoch = micro // batches_per_epoch
        cuda = self.device.type == "cuda"

        errors: list = []

        def guarded(fn, down: queue.Queue):
            """A failure in a pipeline thread is recorded and poisons the
            downstream queue, so the step loop raises it."""
            def run(*args):
                try:
                    fn(*args)
                except BaseException as e:  # noqa: BLE001 - re-raised in the step loop
                    errors.append(e)
                    down.put(None)
            return run

        mel_cfg = self.model_cfg.mel

        def collate(idx, **kw):
            if self.mel_in_graph:  # JAX trainer.py:468-490
                return collate_wav_batch(dataset.wav_batch(idx), self.vocab,
                                         self.model_cfg.tokenizer, mel_cfg, **kw)
            return collate_batch([dataset[i] for i in idx], self.vocab,
                                 self.model_cfg.tokenizer, **kw)

        rows_multiple = self.dp * max(1, self.pipeline_microbatches)

        def produce(skip_n: int, out_q: queue.Queue):
            for bi, idx in enumerate(sampler):
                if bi < skip_n:
                    continue
                if self.mesh is None:
                    out_q.put((collate(idx), len(idx), None))
                    continue
                # this data rank's rows of the global batch (JAX :434-470):
                # padded to a multiple of dp with valid = 0 duplicates, at the
                # global padded width from the sampler's metadata
                # rows divide over data and the GPipe microbatches (JAX :446-451)
                b_real, idx = len(idx), list(idx)
                idx += [idx[i % b_real] for i in range(-b_real % rows_multiple)]
                n_global = pad_frames_to(
                    max(int(math.ceil(dataset.get_frame_len(i))) for i in idx), 256)
                start, size = process_batch_slice(len(idx), self.mesh)
                local = collate(idx[start:start + size], mel_len=n_global, text_len=n_global)
                local["valid"] = (np.arange(start, start + size) < b_real).astype(np.float32)
                out_q.put((local, b_real, (start, b_real)))
            out_q.put(None)

        def upload(in_q: queue.Queue, out_q: queue.Queue):
            while True:
                got = in_q.get()
                if got is None:
                    out_q.put(None)
                    return
                batch, b_real, rows = got
                if "mel" in batch:
                    n_frames = batch["mel"].shape[1]
                else:  # the wav bucket S = (n - 1) * hop + n_fft
                    n_frames = (batch["wav"].shape[1] - mel_cfg.n_fft) // mel_cfg.hop_length + 1
                # this rank's real rows' frames (the log sums them over the data ranks)
                valid_frames = int((batch["lens"] * batch.get("valid", 1)).sum())
                tensors = {}
                for key, arr in batch.items():
                    t = torch.from_numpy(np.ascontiguousarray(arr))
                    if cuda:
                        t = t.pin_memory().to(self.device, non_blocking=True)
                    tensors[key] = t
                out_q.put((tensors, b_real, n_frames, valid_frames, rows))

        state = (model, ema_model, optimizer)
        seq, backend, block_scan, ring_in_pipe = None, "train_auto", None, None
        if self.sequence_parallel:  # JAX :148-170: the seq hook and ring attention
            from f5_tts_tpu_torch.parallel.ring import make_ring_attention
            from f5_tts_tpu_torch.parallel.sequence import make_seq_constraint

            seq = make_seq_constraint(self.mesh)
            if self.pipeline_microbatches:  # pp x sp: the ring inside every tick
                ring_in_pipe = "auto"
            else:
                backend = make_ring_attention(self.mesh, block_impl="auto")
        if self.pipeline_microbatches:
            from f5_tts_tpu_torch.parallel.pipeline import make_dit_block_scan

            block_scan = make_dit_block_scan(self.model_cfg.arch, self.mesh,
                                             self.pipeline_microbatches, backend=backend,
                                             ring_sequence=ring_in_pipe)
        for epoch in range(start_epoch, epochs):
            sampler.set_epoch(epoch)
            q1: queue.Queue = queue.Queue(maxsize=4)
            q2: queue.Queue = queue.Queue(maxsize=2)
            threading.Thread(target=guarded(produce, q1),
                             args=(skip if epoch == start_epoch else 0, q1), daemon=True).start()
            threading.Thread(target=guarded(upload, q2), args=(q1, q2), daemon=True).start()
            while True:
                item = q2.get()
                if item is None:
                    if errors:
                        raise errors[0]
                    break
                batch, b_real, n_frames, valid_frames, rows = item
                t0 = time.perf_counter()
                micro, metrics = train_step(model, optimizer, ema_model, micro, batch,
                                            micro_step_seed(self.seed, micro), self.opt_cfg,
                                            mel_cfg=mel_cfg, rows=rows, data_group=data_group,
                                            grad_group=grad_group, backend=backend,
                                            activation_constraint=seq, block_scan=block_scan,
                                            layout=lay)
                did_update = micro % k_accum == 0
                if did_update:
                    update = micro // k_accum
                if did_update and (update % self.log_every_updates == 0 or update == 1):
                    rec = {"update": update, "micro_step": micro, "epoch": epoch,
                           "loss": float(metrics["loss"]),
                           "grad_norm": float(metrics["grad_norm"]),
                           "step_time_s": time.perf_counter() - t0,
                           "frames": int(b_real * n_frames),
                           "valid_frames": self._sum_over_data(valid_frames, data_group)}
                    if cuda:
                        rec["max_memory_allocated"] = torch.cuda.max_memory_allocated(self.device)
                    self._log(rec)
                if did_update and update % self.save_per_updates == 0:
                    self.save_checkpoint(*state, micro, update)
                    if self.log_samples_fn is not None and self.is_main:  # reference :408-438
                        try:
                            self.log_samples_fn(ema_model, update, model)
                        except Exception as e:  # noqa: BLE001 - sampling must not stop training
                            print(f"log_samples failed at update {update}: {e}")
                if did_update and update % self.last_per_updates == 0:
                    self.save_checkpoint(*state, micro, update, last=True)
                if self._agree(preempt["hit"], all_group):
                    self.save_checkpoint(*state, micro, update, last=True, block=True)
                    self._log({"preempted": True, "update": update, "micro_step": micro})
                    print(f"SIGTERM: model_last.pt at micro-step {micro}; exiting")
                    return model, ema_model, update
            skip = 0
        self.save_checkpoint(*state, micro, update, last=True, block=True)
        return model, ema_model, update

    def _sum_over_data(self, value: int, group) -> int:
        if group is None:
            return value
        t = torch.tensor([value], dtype=torch.int64, device=self.device)
        torch.distributed.all_reduce(t, group=group)
        return int(t.item())

    def _agree(self, hit: bool, group) -> bool:
        """True on every rank when any rank got SIGTERM (one tiny all-reduce
        per step over a mesh), so all save and stop at one micro-step."""
        if group is None:
            return hit
        t = torch.tensor([int(hit)], dtype=torch.int32, device=self.device)
        torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MAX, group=group)
        return bool(t.item())
