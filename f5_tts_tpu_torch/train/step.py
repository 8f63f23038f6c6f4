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
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn as nn


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


def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place, with no host sync; returns the norm."""
    norm = global_norm(grads)
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

    The factored axes depend only on the parameter's sizes, so the torch
    layout (a linear's [out, in]) factors as JAX's ([in, out]) does.  Not
    ``torch.optim.Adafactor``, whose update rule differs.
    """

    DECAY_RATE = 0.8
    MIN_DIM_TO_FACTOR = 128
    CLIP = 1.0  # clip_by_block_rms threshold
    MIN_SCALE = 1e-3  # the floor of rms(p) in multiply_by_parameter_scale
    EPS = 1e-30

    def __init__(self, params, lr: float, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay))

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
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    self._update(p, p.grad, group)

    def _update(self, p, g, group):
        state = self.state[p]
        dims = self.factored_dims(tuple(p.shape))
        if not state:
            state["step"] = 0
            if dims is None:
                state["v"] = torch.zeros_like(p)
            else:
                state["v_row"] = p.new_zeros([s for i, s in enumerate(p.shape) if i != dims[1]])
                state["v_col"] = p.new_zeros([s for i, s in enumerate(p.shape) if i != dims[0]])
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
        u = u / torch.clamp(u.square().mean().sqrt() / self.CLIP, min=1.0)
        u = u * group["lr"] * torch.clamp(p.square().mean().sqrt(), min=self.MIN_SCALE)
        if group["weight_decay"]:
            u = u + group["weight_decay"] * p
        p.sub_(u)
        state["step"] = t + 1

    def state_bytes(self) -> int:
        """Bytes the optimizer state holds on the device."""
        return sum(t.numel() * t.element_size() for st in self.state.values()
                   for t in st.values() if torch.is_tensor(t))


class Optimizer:
    """Clip + AdamW or Adafactor with gradient accumulation (``make_optimizer``'s
    chain).  ``inner`` is the torch optimizer, ``scheduler`` its LambdaLR."""

    def __init__(self, params: list[nn.Parameter], cfg: OptimConfig):
        self.cfg = cfg
        self.params = list(params)
        self.k = max(cfg.grad_accumulation_steps, 1)
        if cfg.optimizer == "adamw":
            self.inner = torch.optim.AdamW(self.params, lr=cfg.learning_rate, betas=cfg.betas,
                                           eps=cfg.eps, weight_decay=cfg.weight_decay)
        elif cfg.optimizer == "adafactor":
            self.inner = Adafactor(self.params, lr=cfg.learning_rate,
                                   weight_decay=cfg.weight_decay)
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
        clip_by_global_norm_(acc, self.cfg.max_grad_norm)
        self.inner.step()
        self.scheduler.step()
        for p in self.params:
            p.grad = None
        return True

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


def make_optimizer(params, cfg: OptimConfig) -> Optimizer:
    return Optimizer(params, cfg)


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
               batch: dict, seed: int, opt_cfg: OptimConfig, backend: str = "train_auto",
               mel_cfg=None):
    """One micro-step on ``model`` (a ``models.cfm.CFM``): loss and gradients,
    the optimizer (an update on every k-th micro-step) and the EMA.

    ``batch`` holds tensors on the model's device: "mel" [b, n, d] (or
    "wav" [b, S] int16 with "wav_scale" [b], whose mel is taken here under
    ``mel_cfg``), "text_ids" [b, nt], "lens" [b] and optionally "valid" [b].
    ``seed`` seeds this micro-step's generators.  Returns (micro + 1,
    metrics) with "loss" and "grad_norm" (of this micro-step's gradients,
    before clipping) as device scalars.
    """
    mel = batch_mel(batch, mel_cfg)
    gen = torch.Generator(device=mel.device).manual_seed(seed)
    drop_gen = torch.Generator().manual_seed(seed)
    named = dict(model.named_parameters())
    args = (batch["text_ids"], batch["lens"])
    kw = dict(generator=gen, drop_generator=drop_gen, backend=backend, valid=batch.get("valid"))
    if opt_cfg.mixed_precision:
        low = {k: p.to(torch.bfloat16) if p.is_floating_point() else p for k, p in named.items()}
        loss = torch.func.functional_call(model, low, (mel.to(torch.bfloat16), *args), kw)
    else:
        loss = model(mel, *args, **kw)
    params = list(named.values())
    grads = torch.autograd.grad(loss, params)
    gnorm = global_norm(grads)
    did_update = optimizer.step(grads)
    micro += 1
    if did_update:
        ema_update(list(ema_model.parameters()), params, micro // optimizer.k, opt_cfg)
    return micro, {"loss": loss.detach(), "grad_norm": gnorm}
