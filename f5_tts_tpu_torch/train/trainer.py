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
so a resumed run draws what an uninterrupted one draws.  The mesh modes
(``mesh``, ``zero1``, ``tensor_parallel``, ``pipeline_microbatches``,
``sequence_parallel``) and ``convpos_taps`` are not ported and raise.  The
trainer runs on the card: ``device=None`` means ``"cuda"``.
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
from f5_tts_tpu_torch.train.dataset import (DynamicBatchSampler, SampleBatchSampler,
                                            collate_batch, collate_wav_batch)
from f5_tts_tpu_torch.train.step import OptimConfig, make_optimizer, train_step
from f5_tts_tpu_torch.utils.ckpt import CheckpointWriter, train_checkpoint
from f5_tts_tpu_torch.utils.device import resolve_device

_NOT_PORTED = "is not ported to the PyTorch package yet (see ROADMAP.md)"


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
        for name, value in (("mesh", mesh is not None), ("zero1", zero1),
                            ("tensor_parallel", tensor_parallel),
                            ("pipeline_microbatches", pipeline_microbatches),
                            ("sequence_parallel", sequence_parallel),
                            ("convpos_taps", convpos_taps)):
            if value:
                raise NotImplementedError(f"Trainer({name}=...) {_NOT_PORTED}")
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
        obj = train_checkpoint(model, ema_model, optimizer.inner.state_dict(),
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
        optimizer = make_optimizer(list(model.parameters()), self.opt_cfg)
        micro = 0
        if resume:
            ckpt = self.load_checkpoint()
            if ckpt is not None:
                model.load_state_dict(ckpt["model_state_dict"])
                ema_model.load_state_dict({k[len("ema_model."):]: v
                                           for k, v in ckpt["ema_model_state_dict"].items()
                                           if k.startswith("ema_model.")})
                optimizer.inner.load_state_dict(ckpt["optimizer_state_dict"])
                optimizer.scheduler.load_state_dict(ckpt["scheduler_state_dict"])
                optimizer.load_accumulation_state(ckpt.get("grad_accumulation"))
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

        def produce(skip_n: int, out_q: queue.Queue):
            for bi, idx in enumerate(sampler):
                if bi < skip_n:
                    continue
                if self.mel_in_graph:  # JAX trainer.py:468-490
                    out_q.put(collate_wav_batch(dataset.wav_batch(idx), self.vocab,
                                                self.model_cfg.tokenizer, mel_cfg))
                else:
                    items = [dataset[i] for i in idx]
                    out_q.put(collate_batch(items, self.vocab, self.model_cfg.tokenizer))
            out_q.put(None)

        def upload(in_q: queue.Queue, out_q: queue.Queue):
            while True:
                batch = in_q.get()
                if batch is None:
                    out_q.put(None)
                    return
                if "mel" in batch:
                    b_real, n_frames = batch["mel"].shape[:2]
                else:  # the wav bucket S = (n - 1) * hop + n_fft
                    b_real = batch["wav"].shape[0]
                    n_frames = (batch["wav"].shape[1] - mel_cfg.n_fft) // mel_cfg.hop_length + 1
                valid_frames = int(batch["lens"].sum())
                tensors = {}
                for key, arr in batch.items():
                    t = torch.from_numpy(np.ascontiguousarray(arr))
                    if cuda:
                        t = t.pin_memory().to(self.device, non_blocking=True)
                    tensors[key] = t
                out_q.put((tensors, b_real, n_frames, valid_frames))

        state = (model, ema_model, optimizer)
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
                batch, b_real, n_frames, valid_frames = item
                t0 = time.perf_counter()
                micro, metrics = train_step(model, optimizer, ema_model, micro, batch,
                                            micro_step_seed(self.seed, micro), self.opt_cfg,
                                            mel_cfg=mel_cfg)
                did_update = micro % k_accum == 0
                if did_update:
                    update = micro // k_accum
                if did_update and (update % self.log_every_updates == 0 or update == 1):
                    rec = {"update": update, "micro_step": micro, "epoch": epoch,
                           "loss": float(metrics["loss"]),
                           "grad_norm": float(metrics["grad_norm"]),
                           "step_time_s": time.perf_counter() - t0,
                           "frames": int(b_real * n_frames), "valid_frames": valid_frames}
                    if cuda:
                        rec["max_memory_allocated"] = torch.cuda.max_memory_allocated(self.device)
                    self._log(rec)
                if did_update and update % self.save_per_updates == 0:
                    self.save_checkpoint(*state, micro, update)
                    if self.log_samples_fn is not None:  # reference log_samples (:408-438)
                        try:
                            self.log_samples_fn(ema_model, update, model)
                        except Exception as e:  # noqa: BLE001 - sampling must not stop training
                            print(f"log_samples failed at update {update}: {e}")
                if did_update and update % self.last_per_updates == 0:
                    self.save_checkpoint(*state, micro, update, last=True)
                if preempt["hit"]:
                    self.save_checkpoint(*state, micro, update, last=True, block=True)
                    self._log({"preempted": True, "update": update, "micro_step": micro})
                    print(f"SIGTERM: model_last.pt at micro-step {micro}; exiting")
                    return model, ema_model, update
            skip = 0
        self.save_checkpoint(*state, micro, update, last=True, block=True)
        return model, ema_model, update
