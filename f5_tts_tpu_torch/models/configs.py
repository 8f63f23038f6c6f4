"""Model architecture configs.

JAX counterpart: ``f5_tts_tpu/models/configs.py:17-181``.  A copy rather than
an import, because the JAX module pulls in JAX through ``ops/mel.py``.  The
three backbones' arch configs (DiT, UNetT, MMDiT) and the shipped
architectures; ``from_yaml_dict`` / ``to_yaml_dict`` read and write the
reference YAML's ``model:`` section for all three (the train CLI uses
them).
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
    # activation checkpointing of every block, under a remat policy
    # (nothing | dots | flash | dots_flash | auto; models/remat.py)
    checkpoint_activations: bool = False
    remat_policy: str = "auto"
    backbone: str = "DiT"
    # rope / abs-pos table horizon: 8192 frames ~ 87 s at 24 kHz, hop 256
    max_pos: int = 8192


@dataclass(frozen=True)
class UNetTConfig:
    """UNetT (E2-TTS) backbone arch (reference backbones/unett.py:108-307)."""

    dim: int = 1024
    depth: int = 24
    heads: int = 16
    dim_head: int = 64
    ff_mult: int = 4
    mel_dim: int = 100
    text_num_embeds: int = 2545
    text_dim: int | None = None  # None -> mel_dim
    text_mask_padding: bool = True
    qk_norm: str | None = None
    conv_layers: int = 0
    conv_mult: int = 2
    pe_attn_head: int | None = None
    skip_connect_type: str = "concat"  # "concat" | "add" | "none"
    checkpoint_activations: bool = False  # as DiTConfig's
    remat_policy: str = "auto"
    backbone: str = "UNetT"
    max_pos: int = 4096


@dataclass(frozen=True)
class MMDiTConfig:
    """MMDiT dual-stream backbone arch (reference backbones/mmdit.py:87-262)."""

    dim: int = 1024
    depth: int = 22
    heads: int = 16
    dim_head: int = 64
    ff_mult: int = 4
    mel_dim: int = 100
    text_num_embeds: int = 2545
    text_mask_padding: bool = True
    qk_norm: str | None = None
    checkpoint_activations: bool = False  # as DiTConfig's
    remat_policy: str = "auto"
    backbone: str = "MMDiT"
    max_pos: int = 4096
    text_max_pos: int = 1024  # the text stream's absolute-position table


ArchConfig = DiTConfig | UNetTConfig | MMDiTConfig
_BACKBONES = {"DiT": DiTConfig, "UNetT": UNetTConfig, "MMDiT": MMDiTConfig}


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch: ArchConfig
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
    "E2TTS_Base": ModelConfig(
        name="E2TTS_Base",
        arch=UNetTConfig(dim=1024, depth=24, heads=16, ff_mult=4,
                         text_mask_padding=False, pe_attn_head=1),
    ),
    "E2TTS_Small": ModelConfig(
        name="E2TTS_Small",
        arch=UNetTConfig(dim=768, depth=20, heads=12, ff_mult=4,
                         text_mask_padding=False, pe_attn_head=1),
    ),
    # experimental dual-stream config (the reference defines MMDiT but ships
    # no checkpoint for it)
    "F5TTS_MMDiT_Base": ModelConfig(
        name="F5TTS_MMDiT_Base",
        arch=MMDiTConfig(dim=1024, depth=22, heads=16, ff_mult=4),
    ),
    # test/smoke-only tiny config (not a released architecture)
    "F5TTS_Tiny": _dit("F5TTS_Tiny", tokenizer="char", dim=64, depth=2, heads=4,
                       ff_mult=2, text_dim=32, text_mask_padding=True, conv_layers=1,
                       pe_attn_head=None),
}


def with_vocab_size(cfg: ModelConfig, vocab_size: int) -> ModelConfig:
    return dataclasses.replace(cfg, arch=dataclasses.replace(cfg.arch, text_num_embeds=vocab_size))


def from_yaml_dict(model: dict) -> ModelConfig:
    """A ``ModelConfig`` from a reference-format ``model:`` YAML section."""
    backbone = model.get("backbone", "DiT")
    if backbone not in _BACKBONES:
        raise ValueError(f"unknown backbone {backbone!r} (one of {sorted(_BACKBONES)})")
    cls = _BACKBONES[backbone]
    arch_kw = dict(model.get("arch", {}))
    for k in ("attn_backend", "attn_mask_enabled"):  # reference-only knobs
        arch_kw.pop(k, None)
    valid = {f.name for f in dataclasses.fields(cls)}
    arch = cls(**{k: v for k, v in arch_kw.items() if k in valid})
    valid_mel = {f.name for f in dataclasses.fields(MelConfig)}
    mel = MelConfig(**{k: v for k, v in dict(model.get("mel_spec", {})).items() if k in valid_mel})
    return ModelConfig(name=model.get("name", "custom"), arch=arch, mel=mel,
                       tokenizer=model.get("tokenizer", "pinyin"))


def to_yaml_dict(cfg: ModelConfig) -> dict:
    """Inverse of ``from_yaml_dict``: the ``model:`` section of a config."""
    return {
        "name": cfg.name,
        "backbone": cfg.arch.backbone,
        "tokenizer": cfg.tokenizer,
        "arch": dataclasses.asdict(cfg.arch),
        "mel_spec": dataclasses.asdict(cfg.mel),
    }
