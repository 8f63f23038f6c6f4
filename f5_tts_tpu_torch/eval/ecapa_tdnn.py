"""ECAPA-TDNN speaker embedder for the SIM metric (torch, host-side eval tool).

Fresh implementation of the standard ECAPA-TDNN arch (Res2Net + SE blocks,
attentive statistics pooling) the reference vendors for WavLM-based speaker
similarity (reference src/f5_tts/eval/ecapa_tdnn.py, from microsoft/UniSpeech).
The WavLM feature extractor needs s3prl + local weights; pass any
``feature_extractor(wav [B,T]) -> [B, frames, feat_dim]`` callable, or use
fbank features.  Eval-only: the serving and training paths never run it.

JAX counterpart: ``f5_tts_tpu/eval/ecapa_tdnn.py`` (a copy with the imports
changed to the port's).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class SEModule(nn.Module):
    def __init__(self, channels: int, bottleneck: int = 128):
        super().__init__()
        self.se = nn.Sequential(
            nn.AdaptiveAvgPool1d(1),
            nn.Conv1d(channels, bottleneck, kernel_size=1),
            nn.ReLU(),
            nn.Conv1d(bottleneck, channels, kernel_size=1),
            nn.Sigmoid(),
        )

    def forward(self, x):
        return x * self.se(x)


class Res2Block(nn.Module):
    def __init__(self, channels: int, kernel_size: int, dilation: int, scale: int = 8):
        super().__init__()
        self.scale = scale
        width = channels // scale
        self.nums = scale - 1
        pad = dilation * (kernel_size - 1) // 2
        self.convs = nn.ModuleList(
            [nn.Conv1d(width, width, kernel_size, dilation=dilation, padding=pad) for _ in range(self.nums)]
        )
        self.bns = nn.ModuleList([nn.BatchNorm1d(width) for _ in range(self.nums)])

    def forward(self, x):
        chunks = torch.chunk(x, self.scale, dim=1)
        out = [chunks[0]]
        sp = None
        for i in range(self.nums):
            sp = chunks[i + 1] if sp is None else sp + chunks[i + 1]
            sp = F.relu(self.bns[i](self.convs[i](sp)))
            out.append(sp)
        return torch.cat(out, dim=1)


class SERes2Block(nn.Module):
    def __init__(self, channels: int, kernel_size: int, dilation: int):
        super().__init__()
        self.block = nn.Sequential(
            nn.Conv1d(channels, channels, kernel_size=1),
            nn.ReLU(),
            nn.BatchNorm1d(channels),
            Res2Block(channels, kernel_size, dilation),
            nn.Conv1d(channels, channels, kernel_size=1),
            nn.ReLU(),
            nn.BatchNorm1d(channels),
            SEModule(channels),
        )

    def forward(self, x):
        return x + self.block(x)


class AttentiveStatsPool(nn.Module):
    def __init__(self, in_dim: int, bottleneck: int = 128, global_context: bool = True):
        super().__init__()
        self.global_context = global_context
        in_att = in_dim * 3 if global_context else in_dim
        self.linear1 = nn.Conv1d(in_att, bottleneck, kernel_size=1)
        self.linear2 = nn.Conv1d(bottleneck, in_dim, kernel_size=1)

    def forward(self, x):
        if self.global_context:
            t = x.shape[-1]
            mean = x.mean(dim=-1, keepdim=True).expand(-1, -1, t)
            std = x.std(dim=-1, keepdim=True).clamp(min=1e-4).expand(-1, -1, t)
            attn_in = torch.cat([x, mean, std], dim=1)
        else:
            attn_in = x
        alpha = torch.softmax(self.linear2(torch.tanh(self.linear1(attn_in))), dim=-1)
        mean = torch.sum(alpha * x, dim=-1)
        var = torch.sum(alpha * x * x, dim=-1) - mean * mean
        std = torch.sqrt(var.clamp(min=1e-9))
        return torch.cat([mean, std], dim=1)


class ECAPA_TDNN(nn.Module):
    def __init__(self, feat_dim: int = 80, channels: int = 512, emb_dim: int = 256,
                 feature_extractor=None):
        super().__init__()
        self.feature_extractor = feature_extractor
        self.layer1 = nn.Sequential(
            nn.Conv1d(feat_dim, channels, kernel_size=5, padding=2),
            nn.ReLU(),
            nn.BatchNorm1d(channels),
        )
        self.layer2 = SERes2Block(channels, 3, 2)
        self.layer3 = SERes2Block(channels, 3, 3)
        self.layer4 = SERes2Block(channels, 3, 4)
        cat_dim = channels * 3
        self.conv = nn.Conv1d(cat_dim, cat_dim, kernel_size=1)
        self.pooling = AttentiveStatsPool(cat_dim)
        self.bn = nn.BatchNorm1d(cat_dim * 2)
        self.linear = nn.Linear(cat_dim * 2, emb_dim)

    def forward(self, wav_or_feats: torch.Tensor) -> torch.Tensor:
        """wav [B, T] (with feature_extractor) or feats [B, frames, feat_dim]."""
        if self.feature_extractor is not None:
            x = self.feature_extractor(wav_or_feats)
        else:
            x = wav_or_feats
        x = x.transpose(1, 2)  # [B, feat, frames]
        x = self.layer1(x)
        x1 = self.layer2(x)
        x2 = self.layer3(x1)
        x3 = self.layer4(x2)
        x = torch.cat([x1, x2, x3], dim=1)
        x = F.relu(self.conv(x))
        x = self.bn(self.pooling(x))
        return self.linear(x)


def ECAPA_TDNN_SMALL(feat_dim: int = 1024, emb_dim: int = 256, feat_type: str = "wavlm_large",
                     device="cpu"):
    """Factory mirroring the reference's entry point.  wavlm_large features
    require s3prl + local WavLM weights (not bundled, zero-egress image).
    ``device``: where the WavLM upstream runs (the port's addition; the
    returned module is moved by the caller, as JAX's)."""
    extractor = None
    if feat_type == "wavlm_large":
        try:
            from s3prl.nn import S3PRLUpstream  # noqa

            upstream = S3PRLUpstream("wavlm_large").to(device)

            def extractor(wav):
                hs, _ = upstream(wav, torch.full((wav.shape[0],), wav.shape[1],
                                                 device=wav.device))
                return hs[-1]
        except ImportError:
            raise RuntimeError(
                "feat_type=wavlm_large needs s3prl + WavLM weights; install s3prl"
                " or pass precomputed features with feat_type='features'"
            )
    return ECAPA_TDNN(feat_dim=feat_dim, channels=512, emb_dim=emb_dim, feature_extractor=extractor)
