"""Param + FLOP counts per backbone (reference src/f5_tts/scripts/count_params_gflops.py).

JAX counterpart: ``scripts/count_params_gflops.py``.  Counts the backbone's
parameters from the port's modules, built on the ``meta`` device (shapes
only: no memory, no init), and FLOPs analytically at the reference's
standard 20 s audio / 150 text-token operating point.  TWO conventions are
printed so the numbers reconcile:

- "true" FLOPs: the repo-wide MFU basis from ``utils/flops.py`` (2*m*n*k per
  matmul, attention QK^T+PV included) — this is what every benchmark's MFU
  line uses;
- thop-convention MACs: linear/conv MACs only, no factor 2, no attention —
  this is what the reference script reports (count_params_gflops.py:21-26;
  DiT Base 335.8 M / 363.4 G, UNetT Base 333.2 M / 622.1 G).

    python -m f5_tts_tpu_torch.scripts.count_params_gflops
"""

from __future__ import annotations

import torch

from f5_tts_tpu_torch.utils.flops import backbone_forward_flops


def count_params(module: torch.nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())


def main():
    from f5_tts_tpu_torch.models.backbones import build_backbone
    from f5_tts_tpu_torch.models.configs import MODEL_CONFIGS

    n = int(20 * 24000 / 256)  # 20 s of audio -> 1875 frames
    for name in ["F5TTS_v1_Base", "F5TTS_Base", "F5TTS_v1_Small", "E2TTS_Base"]:
        cfg = MODEL_CONFIGS[name]
        with torch.device("meta"):
            backbone = build_backbone(cfg.arch)
        fl = backbone_forward_flops(cfg.arch, n)
        # thop-convention (reference script): linear/conv MACs only, no attention
        inner = cfg.arch.heads * cfg.arch.dim_head
        m = n + (1 if cfg.arch.backbone == "UNetT" else 0)
        attn_fl = cfg.arch.depth * 2 * 2 * m * m * inner
        thop_g = (fl - attn_fl) / 2 / 1e9
        print(
            f"{name}: {count_params(backbone) / 1e6:.1f} M params, "
            f"{fl / 1e9:.1f} GFLOPs @20s (true, incl. attention — the MFU basis; "
            f"thop-convention MACs: {thop_g:.1f} G — reference reports this)"
        )


if __name__ == "__main__":
    main()
