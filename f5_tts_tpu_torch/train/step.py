"""Training step: CFM loss, global-norm clipping, AdamW and EMA.

JAX counterpart: ``f5_tts_tpu/train/step.py:21-152``.  ``OptimConfig`` is the
same dataclass.  ``lr_schedule`` is optax's ``join_schedules`` of a linear
warmup from 0 (at update 0) and a linear decay to 0, counted in optimizer
updates.  ``Optimizer`` is the optax chain ``clip_by_global_norm`` ->
``adamw`` under ``MultiSteps``: it takes each micro-step's gradients, and on
every k-th applies one update from their mean, clipped as optax clips
(``g * max_norm / norm`` when ``norm >= max_norm``, no epsilon), through
``torch.optim.AdamW`` (decoupled weight decay on every parameter, as
``optax.adamw``) with a ``LambdaLR`` over the schedule.  ``ema_update`` is
the ema_pytorch rule of the JAX package.  ``"adafactor"`` is not ported.

Mixed precision is the JAX package's explicit cast, not autocast: the loss
runs on bf16 copies of the fp32 master weights
(``torch.func.functional_call``), with the mel cast to bf16; the gradients
flow back through the cast and arrive in fp32.
"""

from __future__ import annotations

from dataclasses import dataclass

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
    optimizer: str = "adamw"  # "adafactor" is not ported


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


class Optimizer:
    """Clip + AdamW with gradient accumulation (``make_optimizer``'s chain)."""

    def __init__(self, params: list[nn.Parameter], cfg: OptimConfig):
        if cfg.optimizer != "adamw":
            raise NotImplementedError(f"optimizer {cfg.optimizer!r} is not ported yet; "
                                      "see ROADMAP.md")
        self.cfg = cfg
        self.params = list(params)
        self.k = max(cfg.grad_accumulation_steps, 1)
        self.adamw = torch.optim.AdamW(self.params, lr=cfg.learning_rate, betas=cfg.betas,
                                       eps=cfg.eps, weight_decay=cfg.weight_decay)
        sched, base = lr_schedule(cfg), cfg.learning_rate
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(
            self.adamw, lambda count: sched(count) / base if base else 0.0)
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
        self.adamw.step()
        self.scheduler.step()
        for p in self.params:
            p.grad = None
        return True

    def accumulation_state(self) -> dict | None:
        """The gradients summed so far between updates (None at a boundary)."""
        if self.mini_step == 0:
            return None
        return {"mini_step": self.mini_step, "grads": [p.grad.detach().cpu() for p in self.params]}

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


def train_step(model: nn.Module, optimizer: Optimizer, ema_model: nn.Module, micro: int,
               batch: dict, seed: int, opt_cfg: OptimConfig, backend: str = "train_auto"):
    """One micro-step on ``model`` (a ``models.cfm.CFM``): loss and gradients,
    the optimizer (an update on every k-th micro-step) and the EMA.

    ``batch`` holds tensors on the model's device: "mel" [b, n, d],
    "text_ids" [b, nt], "lens" [b] and optionally "valid" [b].  ``seed``
    seeds this micro-step's generators.  Returns (micro + 1, metrics) with
    "loss" and "grad_norm" (of this micro-step's gradients, before clipping)
    as device scalars.
    """
    mel = batch["mel"]
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
