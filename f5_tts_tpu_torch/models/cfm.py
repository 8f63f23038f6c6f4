"""Conditional flow matching: the zero-shot infilling sampler.

JAX counterpart: ``f5_tts_tpu/models/cfm.py`` (``timestep_schedule`` and
``SampleOptions`` :28-87, ``sample`` :174-457).  The NFE loop is a Python
loop of fused-CFG forwards (cond and uncond as one 2B batch), with the
AdaLN modulations of the whole schedule precomputed before it (Euler) and
the carry kept in the compute dtype.  The time-parallel (Picard) window and
the training loss are not ported yet; asking for the window raises.

``CFM`` is the reference's top-level module: its state dict holds the
backbone under ``transformer.``, as released checkpoints do.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn as nn

from f5_tts_tpu_torch.models import dit as D
from f5_tts_tpu_torch.models.configs import DiTConfig

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
    """Holds the DiT as ``transformer`` (reference cfm.py:34-80 naming)."""

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.transformer = D.DiT(cfg)


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


@torch.inference_mode()
def sample(model: D.DiT, cfg: DiTConfig, cond: torch.Tensor, text_ids: torch.Tensor,
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

    te_cond = D.text_embedding(model, cfg, text_ids, n, lens=duration).to(compute_dtype)
    use_cfg = opts.cfg_strength >= 1e-5
    if use_cfg:
        te_uncond = D.text_embedding(model, cfg, text_ids, n, lens=duration,
                                     drop_text=True).to(compute_dtype)

    x = torch.where(mask[..., None], noise.to(compute_dtype), torch.zeros((), dtype=compute_dtype,
                                                                          device=dev))

    ts = timestep_schedule(opts.steps, opts.sway_sampling_coef, opts.use_epss)

    def velocity(x, t_k, adaln_mods=None):
        time = torch.full((b,), float(t_k), dtype=torch.float32, device=dev).to(compute_dtype)
        if use_cfg:
            pred, null = D.forward_cfg(model, cfg, x, step_cond, te_cond, te_uncond, time,
                                       mask=mask, backend=backend, adaln_mods=adaln_mods)
            return pred + (pred - null) * opts.cfg_strength
        return D.forward(model, cfg, x, step_cond, te_cond, time, mask=mask, backend=backend,
                         adaln_mods=adaln_mods)

    # the schedule is known ahead: every Euler step's AdaLN modulations in one go
    tables = None
    if opts.ode_method == "euler":
        tables = D.precompute_adaln(model, cfg, torch.as_tensor(ts[:-1], device=dev),
                                    dtype=compute_dtype)

    for k in range(len(ts) - 1):
        t_k = np.float32(ts[k])
        dt_k = np.float32(ts[k + 1] - ts[k])
        dt_c = torch.tensor(float(dt_k), dtype=compute_dtype, device=dev)
        if opts.ode_method == "midpoint":
            k1 = velocity(x, t_k)
            t_mid = np.float32(t_k + np.float32(0.5) * dt_k)
            x = x + dt_c * velocity(x + 0.5 * dt_c * k1, t_mid)
        else:
            x = x + dt_c * velocity(x, t_k, adaln_mods=(tables[0][k], tables[1][k]))
        x = x.to(compute_dtype)  # fp32 params with bf16 activations would promote

    out = torch.where(cond_mask[..., None], cond, x)
    return torch.where(mask[..., None], out, torch.zeros_like(out))
