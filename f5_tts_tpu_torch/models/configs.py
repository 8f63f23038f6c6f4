"""Model architecture configs.

JAX counterpart: ``f5_tts_tpu/models/configs.py:17-140``.  A copy rather than
an import, because the JAX module pulls in JAX through ``ops/mel.py``.  Only
the DiT backbone is ported so far; the UNetT and MMDiT entries come with
their backbones.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

from f5_tts_tpu_torch.ops.mel import MelConfig


@dataclass(frozen=True)
class DiTConfig:
    """DiT backbone arch (reference backbones/dit.py:170-235)."""

    dim: int = 1024
    depth: int = 22
    heads: int = 16
    dim_head: int = 64
    ff_mult: int = 2
    mel_dim: int = 100
    text_num_embeds: int = 2545  # vocab size (Emilia pinyin vocab)
    text_dim: int = 512
    text_mask_padding: bool = True
    text_embedding_average_upsampling: bool = False
    qk_norm: str | None = None
    conv_layers: int = 4
    conv_mult: int = 2
    pe_attn_head: int | None = None
    long_skip_connection: bool = False
    backbone: str = "DiT"
    # rope / abs-pos table horizon: 8192 frames ~ 87 s at 24 kHz, hop 256
    max_pos: int = 8192


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch: DiTConfig
    mel: MelConfig = MelConfig()
    tokenizer: str = "pinyin"


def _dit(name, tokenizer="pinyin", **kw) -> ModelConfig:
    return ModelConfig(name=name, arch=DiTConfig(**kw), tokenizer=tokenizer)


MODEL_CONFIGS: dict[str, ModelConfig] = {
    # F5TTS_v1_Base.yaml:20-44
    "F5TTS_v1_Base": _dit("F5TTS_v1_Base", dim=1024, depth=22, heads=16, ff_mult=2,
                          text_dim=512, text_mask_padding=True, conv_layers=4, pe_attn_head=None),
    # F5TTS_Base.yaml (legacy v0): pe_attn_head=1, no padding mask
    "F5TTS_Base": _dit("F5TTS_Base", dim=1024, depth=22, heads=16, ff_mult=2,
                       text_dim=512, text_mask_padding=False, conv_layers=4, pe_attn_head=1),
    "F5TTS_v1_Small": _dit("F5TTS_v1_Small", tokenizer="char", dim=768, depth=18, heads=12,
                           ff_mult=2, text_dim=512, text_mask_padding=True, conv_layers=4,
                           pe_attn_head=None),
    "F5TTS_Small": _dit("F5TTS_Small", dim=768, depth=18, heads=12, ff_mult=2,
                        text_dim=512, text_mask_padding=False, conv_layers=4, pe_attn_head=1),
    # test/smoke-only tiny config (not a released architecture)
    "F5TTS_Tiny": _dit("F5TTS_Tiny", tokenizer="char", dim=64, depth=2, heads=4,
                       ff_mult=2, text_dim=32, text_mask_padding=True, conv_layers=1,
                       pe_attn_head=None),
}


def with_vocab_size(cfg: ModelConfig, vocab_size: int) -> ModelConfig:
    return dataclasses.replace(cfg, arch=dataclasses.replace(cfg.arch, text_num_embeds=vocab_size))
