"""Conditional flow matching: the zero-shot infilling sampler and the
training loss.

JAX counterpart: ``f5_tts_tpu/models/cfm.py`` (``timestep_schedule`` and
``SampleOptions`` :28-87, ``_picard_integrate`` :94-171, ``sample``
:174-457, ``mask_from_frac_lengths`` and ``loss`` :460-575).  Both run any
backbone through ``backbones.get_backbone`` (JAX :227, :548); MMDiT also gets
the text stream's mask ``c_mask = text_ids != -1``.  The NFE loop is a
Python loop of fused-CFG forwards (cond and uncond as one 2B batch), with
the AdaLN modulations of the whole schedule precomputed before it where the
backbone has ``precompute_adaln`` (DiT; Euler) and the carry kept in the
compute dtype.  ``duplicate_test`` starts the ODE at ``t_start`` from a
blend of the noise and a shifted copy of the reference mel, over
``int(steps * (1 - t_start))`` steps (JAX :238-256).

``time_parallel_window = W > 0`` integrates with the single-device Picard
(parallel-in-time) sampler: each sweep evaluates a window of W Euler steps
as one forward over W·b rows and freezes the longest converged prefix
(``picard_begin``, ``picard_sweep``, ``picard_finish``).  The window is
gathered with device index tensors, so a sweep has no host sync and is
capturable (the engine captures the three parts as CUDA graphs).  The one
departure from JAX, whose ``lax.while_loop`` keeps the loop on the device:
the host reads the frozen count ``s`` once per sweep (a 4-byte copy) to
decide whether to sweep again.  Picard over a mesh (JAX's
``time_parallel_mesh``) is the next slice (ROADMAP.md).

``activation_constraint`` (``sample`` and ``loss``, JAX :189, 263-264,
490, 565) is sequence parallelism's hook, handed to the backbone; DiT alone
takes it, as in JAX.  Under data parallelism each rank's ``loss`` draws
what the one-process run draws for its rows (``rows``: the draws are made
for the whole batch and this rank's rows taken), and divides its sum by the
count of selected elements over the whole batch (``count_group``: the
count is summed over the data ranks, JAX :571-574), so the data ranks'
gradients add up to the one-process gradient.

The loss draws its randomness from explicit ``torch.Generator``s: the noise,
times and span masks from one on the mel's device, the two CFG drop
decisions (one Bernoulli each per step, shared by the whole batch) from one
on the CPU, so reading them costs no device sync.

``CFM`` is the reference's top-level module: its state dict holds the
backbone (DiT, UNetT or MMDiT) under ``transformer.``, as released
checkpoints do, and its
``forward`` is the training loss, as the reference's is.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn as nn

from f5_tts_tpu_torch.models.backbones import build_backbone, get_backbone
from f5_tts_tpu_torch.models.configs import ArchConfig, MMDiTConfig

# Empirically Pruned Step Sampling tables (reference model/utils.py:205-218),
# as fractions of 32
_EPSS = {
    5: [0, 2, 4, 8, 16, 32],
    6: [0, 2, 4, 6, 8, 16, 32],
    7: [0, 2, 4, 6, 8, 16, 24, 32],
    10: [0, 2, 4, 6, 8, 12, 16, 20, 24, 28, 32],
    12: [0, 2, 4, 6, 8, 10, 12, 14, 16, 20, 24, 28, 32],
    16: [0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 14, 16, 20, 24, 28, 32],
}


class CFM(nn.Module):
    """Holds the backbone as ``transformer`` (reference cfm.py:34-80 naming)."""

    def __init__(self, cfg: ArchConfig):
        super().__init__()
        self.cfg = cfg
        self.transformer = build_backbone(cfg)

    def forward(self, mel, text_ids, lens, generator=None, drop_generator=None, **kw):
        """The training loss (``loss`` below), as the reference CFM.forward."""
        return loss(self.transformer, self.cfg, mel, text_ids, lens, generator=generator,
                    drop_generator=drop_generator, **kw)


def timestep_schedule(steps: int, sway_sampling_coef: float | None = -1.0,
                      use_epss: bool = True, t_start: float = 0.0) -> np.ndarray:
    """ODE timesteps [steps+1] with sway warping (coef -1: t' = 1 - cos(pi t / 2))."""
    if t_start == 0.0 and use_epss and steps in _EPSS:
        t = np.asarray(_EPSS[steps], dtype=np.float64) / 32.0
    else:
        t = np.linspace(t_start, 1.0, steps + 1, dtype=np.float64)
    if sway_sampling_coef is not None:
        t = t + sway_sampling_coef * (np.cos(np.pi / 2.0 * t) - 1.0 + t)
    return t.astype(np.float32)


@functools.lru_cache(maxsize=None)
def schedule_tensors(steps: int, sway_sampling_coef: float | None, use_epss: bool,
                     dtype: torch.dtype, device: torch.device, t_start: float = 0.0):
    """The schedule on ``device``, built once per (steps, sway, epss, dtype,
    device, t_start): the step times t_k [steps] in fp32 (for the AdaLN
    tables) and the step sizes dt_k [steps] in ``dtype``.  ``sample``
    indexes them instead of copying host values to the card on every call,
    which a CUDA graph capture cannot do; a captured graph reads them by
    address, so they are never evicted."""
    ts = timestep_schedule(steps, sway_sampling_coef, use_epss, t_start)
    return (torch.as_tensor(ts[:-1], device=device),
            torch.as_tensor(ts[1:] - ts[:-1], device=device).to(dtype))


@functools.lru_cache(maxsize=None)  # never evicted, as schedule_tensors
def picard_schedule(steps: int, sway_sampling_coef: float | None, use_epss: bool,
                    t_start: float, window: int, device: torch.device):
    """The Picard window's schedule on ``device``, fp32, padded by ``window``
    entries so every window slice is in bounds: the step times [steps + W]
    (the pad repeats t = 1) and the step sizes [steps + W] (the pad is 0, so
    padded rows change nothing)."""
    ts = timestep_schedule(steps, sway_sampling_coef, use_epss, t_start)
    t_pad = np.concatenate([ts[:-1], np.full(window, ts[-1], np.float32)])
    dt_pad = np.concatenate([ts[1:] - ts[:-1], np.zeros(window, np.float32)])
    return torch.as_tensor(t_pad, device=device), torch.as_tensor(dt_pad, device=device)


@dataclass(frozen=True)
class SampleOptions:
    """Inference knobs (defaults = reference utils_infer.py:52-65)."""

    steps: int = 32
    cfg_strength: float = 2.0
    sway_sampling_coef: float | None = -1.0
    use_epss: bool = True
    t_start: float = 0.0  # > 0 only with duplicate_test
    ode_method: str = "euler"  # "euler" | "midpoint"
    # the AdaLN modulations of the whole schedule ahead of the loop (DiT, Euler)
    precompute_adaln: bool = True
    # W > 0: the Picard sampler, W Euler steps per sweep as one W*b-row forward
    time_parallel_window: int = 0
    # a window entry is frozen once its masked RMS change between sweeps
    # falls below this; the leading entry is always exact, so <= steps sweeps
    picard_tol: float = 1e-3

    @property
    def n_steps(self) -> int:
        """Steps integrated: a ``t_start`` > 0 launch keeps the grid's density
        by taking only the remaining (1 - t_start) share of ``steps``."""
        return int(self.steps * (1.0 - self.t_start)) if self.t_start > 0.0 else self.steps


def lens_to_mask(lens: torch.Tensor, length: int) -> torch.Tensor:
    return torch.arange(length, device=lens.device)[None, :] < lens[:, None]


def _stream_kwargs(cfg: ArchConfig, text_ids: torch.Tensor) -> dict:
    """MMDiT keeps the text as its own stream and needs its valid mask."""
    return {"c_mask": text_ids != -1} if isinstance(cfg, MMDiTConfig) else {}


@dataclass
class _Setup:
    """What the sequential and the Picard integrators share: the masks, the
    conditioning, both text streams, y0 and the velocity's fixed inputs."""

    cond: torch.Tensor  # [b, n, d], zeroed under no_ref_audio
    cond_mask: torch.Tensor  # [b, n] frames fixed to the reference
    step_cond: torch.Tensor
    mask: torch.Tensor  # [b, n] frames < duration
    te_cond: torch.Tensor
    te_uncond: torch.Tensor | None  # None without CFG
    y0: torch.Tensor
    extra: dict


def _setup(model, cfg, cond, text_ids, duration, noise, lens, opts, edit_mask, no_ref_audio,
           duplicate_test) -> _Setup:
    b, n, _ = cond.shape
    dev = cond.device
    compute_dtype = cond.dtype
    if lens is None:
        lens = torch.full((b,), n, dtype=torch.int32, device=dev)
    cond_mask = lens_to_mask(lens, n)
    if edit_mask is not None:
        cond_mask = cond_mask & edit_mask
    if no_ref_audio:
        cond = torch.zeros_like(cond)
    step_cond = torch.where(cond_mask[..., None], cond, torch.zeros_like(cond))

    # duration >= max(text_len, lens) + 1 so something is generated, <= n
    text_len = (text_ids != -1).sum(dim=-1)
    duration = torch.maximum(torch.maximum(text_len, lens.long()) + 1, duration.long())
    duration = duration.clamp(max=n)
    mask = lens_to_mask(duration, n)

    bb = get_backbone(cfg)
    te_cond = bb.text_embedding(model, cfg, text_ids, n, lens=duration).to(compute_dtype)
    te_uncond = None
    if opts.cfg_strength >= 1e-5:
        te_uncond = bb.text_embedding(model, cfg, text_ids, n, lens=duration,
                                      drop_text=True).to(compute_dtype)
    zero = torch.zeros((), dtype=compute_dtype, device=dev)
    y0 = torch.where(mask[..., None], noise.to(compute_dtype), zero)
    if duplicate_test:
        # a second copy of the reference right after it, blended into y0,
        # and the ODE started at t_start (reference cfm.py:141-143, 205-209)
        if not opts.t_start > 0.0:
            raise ValueError("duplicate_test needs SampleOptions(t_start=t_inter > 0)")
        pos = torch.arange(n, device=dev)[None, :]
        lens_l = lens.long()[:, None]
        rolled = torch.gather(step_cond, 1, ((pos - lens_l) % n)[..., None].expand_as(step_cond))
        dup_region = (pos >= lens_l) & (pos < 2 * lens_l)
        test_cond = torch.where(dup_region[..., None], rolled, torch.zeros_like(rolled))
        y0 = (1.0 - opts.t_start) * y0 + opts.t_start * test_cond.to(compute_dtype)
    return _Setup(cond, cond_mask, step_cond, mask, te_cond, te_uncond, y0,
                  _stream_kwargs(cfg, text_ids))


def _velocity(model, cfg, opts, backend, x, step_cond, te_cond, te_uncond, time, mask, extra,
              adaln_mods=None, activation_constraint=None):
    """The (guided) flow at ``x`` and per-row ``time``."""
    bb = get_backbone(cfg)
    kw = dict(extra) if adaln_mods is None else dict(extra, adaln_mods=adaln_mods)
    if activation_constraint is not None:
        kw["activation_constraint"] = activation_constraint
    if te_uncond is not None:
        pred, null = bb.forward_cfg(model, cfg, x, step_cond, te_cond, te_uncond, time,
                                    mask=mask, backend=backend, **kw)
        return pred + (pred - null) * opts.cfg_strength
    return bb.forward(model, cfg, x, step_cond, te_cond, time, mask=mask, backend=backend, **kw)


def _finish(su: _Setup, y: torch.Tensor) -> torch.Tensor:
    out = torch.where(su.cond_mask[..., None], su.cond, y)
    return torch.where(su.mask[..., None], out, torch.zeros_like(out))


@torch.inference_mode()
def sample(model: nn.Module, cfg: ArchConfig, cond: torch.Tensor, text_ids: torch.Tensor,
           duration: torch.Tensor, noise: torch.Tensor, lens: torch.Tensor | None = None,
           opts: SampleOptions = SampleOptions(), edit_mask: torch.Tensor | None = None,
           no_ref_audio: bool = False, backend="auto", duplicate_test: bool = False,
           return_info: bool = False, activation_constraint=None):
    """CFM.sample (reference cfm.py:83-229) -> generated mel [b, n, d].

    cond [b, n, d]: reference mel zero-padded to the bucket length n;
    text_ids [b, nt] (-1 padded); duration [b] total frames; noise [b, n, d]
    N(0, 1); lens [b] reference frames; edit_mask [b, n] True where the
    reference audio is kept.  Frames past ``duration`` come back zero and the
    reference region is overwritten with ``cond``.  ``return_info`` also
    returns {"sweeps": forwards in sequence, "window": W} (the sequential
    sampler: one forward per step, W = 1).
    """
    if opts.ode_method not in ("euler", "midpoint"):
        raise ValueError(f"ode_method must be euler or midpoint, got {opts.ode_method!r}")
    if opts.time_parallel_window > 0:
        if activation_constraint is not None:
            raise ValueError("the Picard sampler runs on one device (JAX asserts the same, "
                             "cfm.py:292)")
        run = picard_begin(model, cfg, cond, text_ids, duration, noise, lens, opts, edit_mask,
                           no_ref_audio, backend, duplicate_test)
        while int(run.s) < run.T:  # the host's stop test: one 4-byte read per sweep
            picard_sweep(model, cfg, run)
        out = picard_finish(run)
        return (out, {"sweeps": int(run.sweeps), "window": run.W}) if return_info else out
    b, n, _ = cond.shape
    dev = cond.device
    compute_dtype = cond.dtype
    su = _setup(model, cfg, cond, text_ids, duration, noise, lens, opts, edit_mask, no_ref_audio,
                duplicate_test)
    steps = opts.n_steps
    ts = timestep_schedule(steps, opts.sway_sampling_coef, opts.use_epss, opts.t_start)
    t_dev, dt_dev = schedule_tensors(steps, opts.sway_sampling_coef, opts.use_epss,
                                     compute_dtype, dev, opts.t_start)

    def velocity(x, t_k, adaln_mods=None):
        time = torch.full((b,), float(t_k), dtype=torch.float32, device=dev).to(compute_dtype)
        return _velocity(model, cfg, opts, backend, x, su.step_cond, su.te_cond, su.te_uncond,
                         time, su.mask, su.extra, adaln_mods, activation_constraint)

    # the schedule is known ahead: every Euler step's AdaLN modulations in one
    # go, where the backbone has them as tables (DiT)
    bb = get_backbone(cfg)
    tables = None
    if opts.precompute_adaln and opts.ode_method == "euler" and hasattr(bb, "precompute_adaln"):
        tables = bb.precompute_adaln(model, cfg, t_dev, dtype=compute_dtype)

    x = su.y0
    for k in range(len(ts) - 1):
        t_k = np.float32(ts[k])
        dt_k = np.float32(ts[k + 1] - ts[k])
        dt_c = dt_dev[k]  # 0-dim, in the compute dtype: a Python float would round elsewhere
        if opts.ode_method == "midpoint":
            k1 = velocity(x, t_k)
            t_mid = np.float32(t_k + np.float32(0.5) * dt_k)
            x = x + dt_c * velocity(x + 0.5 * dt_c * k1, t_mid)
        else:
            mods = None if tables is None else (tables[0][k], tables[1][k])
            x = x + dt_c * velocity(x, t_k, adaln_mods=mods)
        x = x.to(compute_dtype)  # fp32 params with bf16 activations would promote
    out = _finish(su, x)
    return (out, {"sweeps": len(ts) - 1, "window": 1}) if return_info else out


@dataclass
class PicardRun:
    """One Picard integration's state on the device (JAX ``_picard_integrate``).

    ``Y`` [T + W + 1, b, n, d] holds the guesses of y(t_i), padded so every
    window slice is in bounds; entries up to ``s`` are frozen.  The rows
    fields are the conditioning tiled W times onto the batch axis (w-major,
    as the window's states reshape), ``mods`` the padded AdaLN tables.
    ``picard_sweep`` updates ``Y``, ``s`` and ``sweeps`` in place, so a CUDA
    graph captured over it replays on the same tensors."""

    setup: _Setup
    Y: torch.Tensor
    s: torch.Tensor  # [] int64: steps frozen
    sweeps: torch.Tensor  # [] int64
    t_pad: torch.Tensor  # [T + W] fp32
    dt_pad: torch.Tensor  # [T + W] fp32
    cond_r: torch.Tensor
    te_r: torch.Tensor
    teu_r: torch.Tensor | None
    mask_r: torch.Tensor
    extra_r: dict
    mods: tuple | None
    fmask: torch.Tensor  # [b, n, 1] fp32
    denom: torch.Tensor  # [] fp32: valid elements of one state
    T: int
    W: int
    opts: SampleOptions
    backend: str


@torch.inference_mode()
def picard_begin(model, cfg, cond, text_ids, duration, noise, lens=None,
                 opts: SampleOptions = SampleOptions(), edit_mask=None, no_ref_audio=False,
                 backend="auto", duplicate_test=False) -> PicardRun:
    """The Picard sampler's prelude (JAX ``sample`` :286-413): masks, text
    embeddings, y0, the window's tiled conditioning and AdaLN tables."""
    if opts.ode_method != "euler":
        raise ValueError("the time-parallel (Picard) sampler is Euler-only")
    b, n, d = cond.shape
    dev, dtype = cond.device, cond.dtype
    su = _setup(model, cfg, cond, text_ids, duration, noise, lens, opts, edit_mask, no_ref_audio,
                duplicate_test)
    T = opts.n_steps
    W = min(opts.time_parallel_window, T)
    t_pad, dt_pad = picard_schedule(T, opts.sway_sampling_coef, opts.use_epss, opts.t_start, W,
                                    dev)
    extra_r = {k: v.repeat(W, 1) for k, v in su.extra.items()}  # MMDiT's c_mask
    mods = None
    bb = get_backbone(cfg)
    if opts.precompute_adaln and hasattr(bb, "precompute_adaln"):
        blk, fin = bb.precompute_adaln(model, cfg, t_pad[:T], dtype=dtype)
        # padded window rows reuse the last step's mods (their dt = 0)
        mods = (torch.cat([blk, blk[-1:].expand(W, *blk.shape[1:])]),
                torch.cat([fin, fin[-1:].expand(W, *fin.shape[1:])]))
    fmask = su.mask[..., None].float()
    return PicardRun(
        setup=su, Y=su.y0[None].repeat(T + W + 1, 1, 1, 1),
        s=torch.zeros((), dtype=torch.int64, device=dev),
        sweeps=torch.zeros((), dtype=torch.int64, device=dev), t_pad=t_pad, dt_pad=dt_pad,
        cond_r=su.step_cond.repeat(W, 1, 1), te_r=su.te_cond.repeat(W, 1, 1),
        teu_r=None if su.te_uncond is None else su.te_uncond.repeat(W, 1, 1),
        mask_r=su.mask.repeat(W, 1), extra_r=extra_r, mods=mods, fmask=fmask,
        denom=torch.clamp(fmask.sum() * d, min=1.0), T=T, W=W, opts=opts, backend=backend)


@torch.inference_mode()
def picard_sweep(model, cfg, run: PicardRun) -> None:
    """One sweep, in place (JAX ``_picard_integrate`` body :127-163):
    Y'[s+j+1] = Y[s] + sum_{m<=j} dt_{s+m} v(Y[s+m], t_{s+m}) for the W window
    entries as one forward over W*b rows; freeze the longest prefix whose
    masked RMS change is below ``picard_tol`` after the always-exact first
    entry; warm-start the entries past the window from the new frontier."""
    Y, W = run.Y, run.W
    _, b, n, d = Y.shape
    dev, dtype = Y.device, Y.dtype
    win = run.s + torch.arange(W, device=dev)  # device indices: no host sync
    x_rows = Y.index_select(0, win).reshape(W * b, n, d)
    t_rows = run.t_pad.index_select(0, win).repeat_interleave(b).to(dtype)
    mods = None
    if run.mods is not None:  # w-major rows, as the reshape: [depth, W*b, 6 dim], [W*b, 2 dim]
        mods = (run.mods[0].index_select(0, win).transpose(0, 1).repeat_interleave(b, dim=1),
                run.mods[1].index_select(0, win).repeat_interleave(b, dim=0))
    v = _velocity(model, cfg, run.opts, run.backend, x_rows, run.cond_r, run.te_r, run.teu_r,
                  t_rows, run.mask_r, run.extra_r, mods).reshape(W, b, n, d)
    dw = run.dt_pad.index_select(0, win)
    incr = torch.cumsum(dw[:, None, None, None].to(dtype) * v, dim=0)
    y_new = Y.index_select(0, run.s.view(1)) + incr  # new guesses of Y[s+1 .. s+W]
    diff = (y_new - Y.index_select(0, win + 1)).float() * run.fmask
    err = torch.sqrt((diff * diff).sum(dim=(1, 2, 3)) / run.denom)  # [W]
    adv = 1 + torch.cumprod((err[1:] < run.opts.picard_tol).to(torch.int64), dim=0).sum()
    y_new = y_new.to(dtype)
    Y.index_copy_(0, win + 1, y_new)
    past = torch.arange(Y.shape[0], device=dev)[:, None, None, None] > run.s + W
    Y.copy_(torch.where(past, y_new[-1][None], Y))
    run.s.add_(adv)
    run.sweeps.add_(1)


@torch.inference_mode()
def picard_finish(run: PicardRun) -> torch.Tensor:
    """The generated mel from the final state Y[T]."""
    return _finish(run.setup, run.Y[run.T])



def _draw(fn, shape, rows, dev):
    """``fn(shape)`` for this rank's rows: drawn for the whole batch
    (``rows`` = (first row, batch rows)) and this rank's rows taken, the
    rows past the batch (the data-parallel padding) wrapping round."""
    if rows is None:
        return fn(shape)
    start, total = rows
    idx = (start + torch.arange(shape[0], device=dev)) % total
    return fn((total, *shape[1:])).index_select(0, idx)


def mask_from_frac_lengths(lens: torch.Tensor, length: int, generator: torch.Generator | None = None,
                           frac_range=(0.7, 1.0), rows=None) -> torch.Tensor:
    """Random contiguous span covering a fraction in ``frac_range`` of each
    row's length (reference model/utils.py:61-77) -> bool [b, length].
    ``rows``: as ``loss``'s."""
    b, dev = lens.shape[0], lens.device

    def rand(shape):
        return torch.rand(shape, generator=generator, device=dev)

    frac = _draw(rand, (b,), rows, dev) * (frac_range[1] - frac_range[0]) + frac_range[0]
    span = (frac * lens).to(torch.int32)
    max_start = lens - span
    start = (max_start * _draw(rand, (b,), rows, dev)).to(torch.int32)
    start = start.clamp(min=0)
    pos = torch.arange(length, device=dev)[None, :]
    return (pos >= start[:, None]) & (pos < (start + span)[:, None])


def loss(model: nn.Module, cfg: ArchConfig, mel: torch.Tensor, text_ids: torch.Tensor,
         lens: torch.Tensor, generator: torch.Generator | None = None,
         drop_generator: torch.Generator | None = None, audio_drop_prob: float = 0.3,
         cond_drop_prob: float = 0.2, frac_lengths_mask=(0.7, 1.0),
         backend="train_auto", valid: torch.Tensor | None = None,
         inject: dict | None = None, activation_constraint=None, rows=None,
         count_group=None) -> torch.Tensor:
    """CFM training loss (reference cfm.py:231-302): flow-matching MSE over a
    random infilling span, with CFG condition drops.

    mel [b, n, d] (x1), text_ids [b, nt] (-1 padded), lens [b].  ``generator``
    lives on mel's device, ``drop_generator`` on the CPU.  ``inject``
    overrides the draws: "x0" [b, n, d], "time" [b], "span_mask" [b, n] bool,
    "drop_audio" / "drop_both" bool.  ``valid`` [b] zeroes padded rows'
    contribution.  Returns the fp32 masked mean.

    Data parallelism: ``rows`` = (this rank's first row in the padded global
    batch, the global batch's real rows) makes the draws those of the
    one-process run for these rows; ``count_group`` sums the count of
    selected elements over the data ranks, so the return value is this
    rank's share of the global mean.  ``activation_constraint``: the
    sequence-parallel hook.
    """
    b, n, d = mel.shape
    dev = mel.device
    inject = inject or {}
    mask = lens_to_mask(lens, n)
    span = inject.get("span_mask")
    if span is None:
        span = mask_from_frac_lengths(lens, n, generator, frac_lengths_mask, rows)
    span = span.to(dev) & mask

    x1 = mel
    x0 = inject.get("x0")
    if x0 is None:
        x0 = _draw(lambda s: torch.randn(s, generator=generator, device=dev), x1.shape, rows, dev)
    x0 = x0.to(device=dev, dtype=x1.dtype)
    time = inject.get("time")
    if time is None:
        time = _draw(lambda s: torch.rand(s, generator=generator, device=dev), (b,), rows, dev)
    time = time.to(device=dev, dtype=x1.dtype)

    t = time[:, None, None]
    phi = (1.0 - t) * x0 + t * x1
    flow = x1 - x0
    cond = torch.where(span[..., None], torch.zeros((), dtype=x1.dtype, device=dev), x1)

    drop_audio = inject.get("drop_audio")
    if drop_audio is None:
        drop_audio = bool(torch.rand((), generator=drop_generator) < audio_drop_prob)
    drop_both = inject.get("drop_both")
    if drop_both is None:
        drop_both = bool(torch.rand((), generator=drop_generator) < cond_drop_prob)
    drop_audio = bool(drop_audio) or bool(drop_both)

    # every draw above comes before the backbone: its checkpointed blocks
    # (models/remat.py) draw none, so a recompute needs no RNG state
    # both text streams are computed and one is selected, as in JAX: every
    # text-encoder parameter then gets a gradient (zero or not) every step
    bb = get_backbone(cfg)
    te = bb.text_embedding(model, cfg, text_ids, n, lens=lens).to(x1.dtype)
    te_uncond = bb.text_embedding(model, cfg, text_ids, n, lens=lens, drop_text=True).to(x1.dtype)
    te = torch.where(torch.tensor(drop_both, device=dev), te_uncond, te)
    cond_in = torch.zeros_like(cond) if drop_audio else cond

    kw = _stream_kwargs(cfg, text_ids)
    if activation_constraint is not None:
        kw["activation_constraint"] = activation_constraint
    pred = bb.forward(model, cfg, phi, cond_in, te, time, mask=mask, backend=backend, **kw)

    sq = (pred - flow).square()
    w = span[..., None].float()
    if valid is not None:
        w = w * valid.to(dev).float()[:, None, None]
    total = (sq.float() * w).sum()
    count = w.sum() * d
    if count_group is not None:
        import torch.distributed as dist

        dist.all_reduce(count, group=count_group)
    return total / torch.clamp(count, min=1.0)
