"""Conditional flow matching: the zero-shot infilling sampler and the
training loss.

JAX counterpart: ``f5_tts_tpu/models/cfm.py`` (``timestep_schedule`` and
``SampleOptions`` :28-87, ``sample`` :174-457, ``mask_from_frac_lengths``
and ``loss`` :460-575).  Both run any backbone through
``backbones.get_backbone`` (JAX :227, :548); MMDiT also gets the text
stream's mask ``c_mask = text_ids != -1``.  The NFE loop is a Python loop of
fused-CFG forwards (cond and uncond as one 2B batch), with the AdaLN
modulations of the whole schedule precomputed before it where the backbone
has ``precompute_adaln`` (DiT; Euler) and the carry kept in the compute
dtype.  The time-parallel (Picard) window is not ported yet; asking
for it raises.

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
                      use_epss: bool = True) -> np.ndarray:
    """ODE timesteps [steps+1] with sway warping (coef -1: t' = 1 - cos(pi t / 2))."""
    if use_epss and steps in _EPSS:
        t = np.asarray(_EPSS[steps], dtype=np.float64) / 32.0
    else:
        t = np.linspace(0.0, 1.0, steps + 1, dtype=np.float64)
    if sway_sampling_coef is not None:
        t = t + sway_sampling_coef * (np.cos(np.pi / 2.0 * t) - 1.0 + t)
    return t.astype(np.float32)


@functools.lru_cache(maxsize=None)
def schedule_tensors(steps: int, sway_sampling_coef: float | None, use_epss: bool,
                     dtype: torch.dtype, device: torch.device):
    """The schedule on ``device``, built once per (steps, sway, epss, dtype,
    device): the step times t_k [steps] in fp32 (for the AdaLN tables) and
    the step sizes dt_k [steps] in ``dtype``.  ``sample`` indexes them
    instead of copying host values to the card on every call, which a CUDA
    graph capture cannot do; a captured graph reads them by address, so
    they are never evicted."""
    ts = timestep_schedule(steps, sway_sampling_coef, use_epss)
    return (torch.as_tensor(ts[:-1], device=device),
            torch.as_tensor(ts[1:] - ts[:-1], device=device).to(dtype))


@dataclass(frozen=True)
class SampleOptions:
    """Inference knobs (defaults = reference utils_infer.py:52-65)."""

    steps: int = 32
    cfg_strength: float = 2.0
    sway_sampling_coef: float | None = -1.0
    use_epss: bool = True
    ode_method: str = "euler"  # "euler" | "midpoint"
    time_parallel_window: int = 0  # Picard window: not ported yet


def lens_to_mask(lens: torch.Tensor, length: int) -> torch.Tensor:
    return torch.arange(length, device=lens.device)[None, :] < lens[:, None]


def _stream_kwargs(cfg: ArchConfig, text_ids: torch.Tensor) -> dict:
    """MMDiT keeps the text as its own stream and needs its valid mask."""
    return {"c_mask": text_ids != -1} if isinstance(cfg, MMDiTConfig) else {}


@torch.inference_mode()
def sample(model: nn.Module, cfg: ArchConfig, cond: torch.Tensor, text_ids: torch.Tensor,
           duration: torch.Tensor, noise: torch.Tensor, lens: torch.Tensor | None = None,
           opts: SampleOptions = SampleOptions(), edit_mask: torch.Tensor | None = None,
           no_ref_audio: bool = False, backend: str = "auto") -> torch.Tensor:
    """CFM.sample (reference cfm.py:83-229) -> generated mel [b, n, d].

    cond [b, n, d]: reference mel zero-padded to the bucket length n;
    text_ids [b, nt] (-1 padded); duration [b] total frames; noise [b, n, d]
    N(0, 1); lens [b] reference frames; edit_mask [b, n] True where the
    reference audio is kept.  Frames past ``duration`` come back zero and the
    reference region is overwritten with ``cond``.
    """
    if opts.time_parallel_window:
        raise NotImplementedError("the time-parallel (Picard) sampler is not ported yet; "
                                  "see ROADMAP.md")
    if opts.ode_method not in ("euler", "midpoint"):
        raise ValueError(f"ode_method must be euler or midpoint, got {opts.ode_method!r}")
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
    use_cfg = opts.cfg_strength >= 1e-5
    if use_cfg:
        te_uncond = bb.text_embedding(model, cfg, text_ids, n, lens=duration,
                                      drop_text=True).to(compute_dtype)

    x = torch.where(mask[..., None], noise.to(compute_dtype), torch.zeros((), dtype=compute_dtype,
                                                                          device=dev))

    ts = timestep_schedule(opts.steps, opts.sway_sampling_coef, opts.use_epss)
    t_dev, dt_dev = schedule_tensors(opts.steps, opts.sway_sampling_coef, opts.use_epss,
                                     compute_dtype, dev)

    extra = _stream_kwargs(cfg, text_ids)

    def velocity(x, t_k, adaln_mods=None):
        time = torch.full((b,), float(t_k), dtype=torch.float32, device=dev).to(compute_dtype)
        kw = dict(extra) if adaln_mods is None else dict(extra, adaln_mods=adaln_mods)
        if use_cfg:
            pred, null = bb.forward_cfg(model, cfg, x, step_cond, te_cond, te_uncond, time,
                                        mask=mask, backend=backend, **kw)
            return pred + (pred - null) * opts.cfg_strength
        return bb.forward(model, cfg, x, step_cond, te_cond, time, mask=mask, backend=backend,
                          **kw)

    # the schedule is known ahead: every Euler step's AdaLN modulations in one
    # go, where the backbone has them as tables (DiT)
    tables = None
    if opts.ode_method == "euler" and hasattr(bb, "precompute_adaln"):
        tables = bb.precompute_adaln(model, cfg, t_dev, dtype=compute_dtype)

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

    out = torch.where(cond_mask[..., None], cond, x)
    return torch.where(mask[..., None], out, torch.zeros_like(out))


def mask_from_frac_lengths(lens: torch.Tensor, length: int, generator: torch.Generator | None = None,
                           frac_range=(0.7, 1.0)) -> torch.Tensor:
    """Random contiguous span covering a fraction in ``frac_range`` of each
    row's length (reference model/utils.py:61-77) -> bool [b, length]."""
    b, dev = lens.shape[0], lens.device
    frac = torch.rand((b,), generator=generator, device=dev) * (frac_range[1] - frac_range[0]) \
        + frac_range[0]
    span = (frac * lens).to(torch.int32)
    max_start = lens - span
    start = (max_start * torch.rand((b,), generator=generator, device=dev)).to(torch.int32)
    start = start.clamp(min=0)
    pos = torch.arange(length, device=dev)[None, :]
    return (pos >= start[:, None]) & (pos < (start + span)[:, None])


def loss(model: nn.Module, cfg: ArchConfig, mel: torch.Tensor, text_ids: torch.Tensor,
         lens: torch.Tensor, generator: torch.Generator | None = None,
         drop_generator: torch.Generator | None = None, audio_drop_prob: float = 0.3,
         cond_drop_prob: float = 0.2, frac_lengths_mask=(0.7, 1.0),
         backend: str = "train_auto", valid: torch.Tensor | None = None,
         inject: dict | None = None) -> torch.Tensor:
    """CFM training loss (reference cfm.py:231-302): flow-matching MSE over a
    random infilling span, with CFG condition drops.

    mel [b, n, d] (x1), text_ids [b, nt] (-1 padded), lens [b].  ``generator``
    lives on mel's device, ``drop_generator`` on the CPU.  ``inject``
    overrides the draws: "x0" [b, n, d], "time" [b], "span_mask" [b, n] bool,
    "drop_audio" / "drop_both" bool.  ``valid`` [b] zeroes padded rows'
    contribution.  Returns the fp32 masked mean.
    """
    b, n, d = mel.shape
    dev = mel.device
    inject = inject or {}
    mask = lens_to_mask(lens, n)
    span = inject.get("span_mask")
    if span is None:
        span = mask_from_frac_lengths(lens, n, generator, frac_lengths_mask)
    span = span.to(dev) & mask

    x1 = mel
    x0 = inject.get("x0")
    if x0 is None:
        x0 = torch.randn(x1.shape, generator=generator, device=dev)
    x0 = x0.to(device=dev, dtype=x1.dtype)
    time = inject.get("time")
    if time is None:
        time = torch.rand((b,), generator=generator, device=dev)
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

    # both text streams are computed and one is selected, as in JAX: every
    # text-encoder parameter then gets a gradient (zero or not) every step
    bb = get_backbone(cfg)
    te = bb.text_embedding(model, cfg, text_ids, n, lens=lens).to(x1.dtype)
    te_uncond = bb.text_embedding(model, cfg, text_ids, n, lens=lens, drop_text=True).to(x1.dtype)
    te = torch.where(torch.tensor(drop_both, device=dev), te_uncond, te)
    cond_in = torch.zeros_like(cond) if drop_audio else cond

    pred = bb.forward(model, cfg, phi, cond_in, te, time, mask=mask, backend=backend,
                      **_stream_kwargs(cfg, text_ids))

    sq = (pred - flow).square()
    w = span[..., None].float()
    if valid is not None:
        w = w * valid.to(dev).float()[:, None, None]
    total = (sq.float() * w).sum()
    count = torch.clamp(w.sum() * d, min=1.0)
    return total / count
