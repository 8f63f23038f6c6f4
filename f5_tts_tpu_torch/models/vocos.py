"""Vocos vocoder (mel -> waveform).

JAX counterpart: ``f5_tts_tpu/models/vocos.py``.  Module names follow
charactr/vocos-mel-24khz (``backbone.embed``, ``backbone.norm``,
``backbone.convnext.{i}``, ``backbone.final_layer_norm``, ``head.out``):
Conv1d embed -> LayerNorm -> ConvNeXt v1 blocks with layer scale ->
LayerNorm -> Linear to (log-magnitude, phase) -> ISTFT.  ``decode`` with
``lens`` masks at every conv boundary and leaves padded frames out of the
ISTFT envelope, so a bucket-padded batch decodes as each row's exact-length
mel would.  The engine runs it in fp32.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F

from f5_tts_tpu_torch.models import layers as L
from f5_tts_tpu_torch.ops.stft import STFTConfig, istft


@dataclass(frozen=True)
class VocosConfig:
    input_channels: int = 100
    dim: int = 512
    intermediate_dim: int = 1536
    num_layers: int = 8
    n_fft: int = 1024
    hop_length: int = 256
    sample_rate: int = 24_000

    @property
    def stft(self) -> STFTConfig:
        return STFTConfig(n_fft=self.n_fft, hop_length=self.hop_length, win_length=self.n_fft)


class ConvNeXtV1Block(nn.Module):
    """dwconv k7 -> LN -> pw1 -> GELU -> pw2, layer-scale gamma residual."""

    def __init__(self, dim: int, intermediate_dim: int, layer_scale: float):
        super().__init__()
        self.dwconv = nn.Conv1d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pwconv1 = nn.Linear(dim, intermediate_dim)
        self.pwconv2 = nn.Linear(intermediate_dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), layer_scale))


def convnext_v1(p: ConvNeXtV1Block, x):
    residual = x
    x = L.conv1d(p.dwconv, x, groups=x.shape[-1])
    x = L.layer_norm(x, p.norm.weight.to(x.dtype), p.norm.bias.to(x.dtype), eps=1e-6)
    x = L.linear(p.pwconv2, F.gelu(L.linear(p.pwconv1, x)))
    return residual + p.gamma.to(x.dtype) * x


class VocosBackbone(nn.Module):
    def __init__(self, cfg: VocosConfig):
        super().__init__()
        self.embed = nn.Conv1d(cfg.input_channels, cfg.dim, 7, padding=3)
        self.norm = nn.LayerNorm(cfg.dim, eps=1e-6)
        self.convnext = nn.ModuleList([
            ConvNeXtV1Block(cfg.dim, cfg.intermediate_dim, 1.0 / cfg.num_layers)
            for _ in range(cfg.num_layers)
        ])
        self.final_layer_norm = nn.LayerNorm(cfg.dim, eps=1e-6)


class ISTFTHead(nn.Module):
    def __init__(self, cfg: VocosConfig):
        super().__init__()
        self.out = nn.Linear(cfg.dim, cfg.n_fft + 2)


class Vocos(nn.Module):
    def __init__(self, cfg: VocosConfig = VocosConfig()):
        super().__init__()
        self.cfg = cfg
        self.backbone = VocosBackbone(cfg)
        self.head = ISTFTHead(cfg)


@torch.inference_mode()
def decode(voc: Vocos, mel: torch.Tensor, lens: torch.Tensor | None = None) -> torch.Tensor:
    """[b, n, n_mels] log-mel -> [b, (n-1)*hop] waveform."""
    cfg = voc.cfg
    bb = voc.backbone
    keep = None
    if lens is not None:
        keep = (torch.arange(mel.shape[1], device=mel.device)[None, :]
                < lens[:, None])[..., None].to(mel.dtype)
        mel = mel * keep
    x = L.conv1d(bb.embed, mel)
    if keep is not None:
        x = x * keep
    x = L.layer_norm(x, bb.norm.weight.to(x.dtype), bb.norm.bias.to(x.dtype), eps=1e-6)
    for blk in bb.convnext:
        if keep is not None:
            x = x * keep  # re-zero before each dwconv so padding never leaks
        x = convnext_v1(blk, x)
    x = L.layer_norm(x, bb.final_layer_norm.weight.to(x.dtype),
                     bb.final_layer_norm.bias.to(x.dtype), eps=1e-6)
    x = L.linear(voc.head.out, x)  # [b, n, n_fft + 2]
    n_freq = cfg.n_fft // 2 + 1
    mag, phase = x[..., :n_freq].float(), x[..., n_freq:].float()
    # magnitude cap after exp (vocos ISTFTHead: exp(x).clip(max=1e2)); the
    # inner clip only keeps exp finite
    mag = torch.clamp(torch.exp(torch.clamp(mag, max=20.0)), max=1e2)
    return istft(mag * torch.cos(phase), mag * torch.sin(phase), cfg.stft, frame_lens=lens)
