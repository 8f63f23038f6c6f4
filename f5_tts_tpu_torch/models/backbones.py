"""Backbone registry: one functional interface over DiT, UNetT and MMDiT.

JAX counterpart: ``f5_tts_tpu/models/backbones.py:17-26``.  Each backbone
module exposes ``text_embedding(model, cfg, text_ids, seq_len, lens=None,
drop_text=False)``, ``forward(model, cfg, x, cond, text_emb, time,
mask=None, drop_audio_cond=False, backend=...)``, ``forward_cfg`` and
``forward_with_text``; DiT also ``precompute_adaln``, DiT and UNetT also
``fuse_for_inference``, DiT and MMDiT also ``quantize_targets`` (W8A8).
Callers test for the first two with ``hasattr``, as the JAX sampler and
engine do.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from f5_tts_tpu_torch.models import dit, mmdit, unett
from f5_tts_tpu_torch.models.configs import DiTConfig, MMDiTConfig, UNetTConfig

_MODULES = {DiTConfig: (dit, dit.DiT), UNetTConfig: (unett, unett.UNetT),
            MMDiTConfig: (mmdit, mmdit.MMDiT)}


def _entry(arch_cfg):
    try:
        return _MODULES[type(arch_cfg)]
    except KeyError:
        raise ValueError(f"unknown backbone config {type(arch_cfg)}") from None


def get_backbone(arch_cfg):
    """The backbone module of an arch config."""
    return _entry(arch_cfg)[0]


def build_backbone(arch_cfg) -> nn.Module:
    """The backbone ``nn.Module`` of an arch config, reference-initialized."""
    return _entry(arch_cfg)[1](arch_cfg)


def quantize_targets(model: nn.Module, arch_cfg) -> list[tuple[str, nn.Module, str]]:
    """The linears W8A8 serving quantizes, as (name, module, weight
    attribute).  UNetT has none: the JAX ``quantize_dit_blocks`` reads
    ``params["blocks"]``, which UNetT's tree (``first`` / ``second``) lacks,
    so JAX cannot serve it quantized (a ``KeyError``)."""
    module = get_backbone(arch_cfg)
    if not hasattr(module, "quantize_targets"):
        raise ValueError(f"W8A8 quantization is not defined for {type(arch_cfg).__name__}: the "
                         "JAX package has no counterpart (quantize_dit_blocks reads "
                         "params['blocks'], which this backbone's tree lacks)")
    return module.quantize_targets(model)


def randomize_zero_init(model: nn.Module, generator: torch.Generator) -> None:
    """Give a backbone's zero-initialized projections (its
    ``zero_init_linears()``: AdaLN gates, final norm, ``proj_out``) uniform
    torch-default-scale weights.  With the gates at zero every block is the
    identity and the output is zero, which makes a comparison of two
    implementations vacuous."""
    with torch.no_grad():
        for lin in model.zero_init_linears():
            bound = lin.in_features ** -0.5
            for t in (lin.weight, lin.bias):
                r = torch.rand(t.shape, generator=generator, dtype=torch.float32)
                t.copy_((r * 2 - 1) * bound)
