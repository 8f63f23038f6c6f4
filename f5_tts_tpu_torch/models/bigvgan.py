"""BigVGAN v2 vocoder (mel -> waveform).

JAX counterpart: ``f5_tts_tpu/models/bigvgan.py`` (``BigVGANConfig`` :27-40,
``kaiser_sinc_filter1d`` :43-64, SnakeBeta :67-72, the alias-free 2x up-
and downsample :75-111, ``activation1d`` :119-124, the AMP block :139-146,
the transposed-conv upsample :149-164, ``decode`` :199-211).  The
architecture is nvidia/bigvgan_v2_24khz_100band_256x: ``conv_pre``, six
transposed-conv upsample stages (4, 4, 2, 2, 2, 2: 256x), each followed by
three parallel AMP resblocks (dilated convs between anti-aliased SnakeBeta
activations) whose outputs are averaged, then the anti-aliased
``activation_post``, ``conv_post`` and a clamp to [-1, 1].

The module names are the reference's (``conv_pre``, ``ups.{i}.0``,
``resblocks.{k}.convs{1,2}.{m}``, ``resblocks.{k}.activations.{m}.act.
{alpha,beta}``, ``activation_post.act.*``, ``conv_post``), so a reference
state dict loads by key (``utils/ckpt.load_bigvgan_state``).  It works in
PyTorch's [b, c, t] layout, with one transpose at the entry.

The anti-aliased activation (replicate pad, grouped ``conv_transpose1d``
by the kaiser sinc filter, SnakeBeta, replicate pad, grouped stride-2
``conv1d``) is plain PyTorch, as the JAX package runs it as XLA conv ops;
it has no Pallas kernel to port.  Each activation holds its two filters
as non-persistent buffers [c, 1, 12], built once on the host and moved
with the module, so a decode copies nothing from the host (a CUDA graph
capture forbids it) and no grouped weight is a stride-0 ``expand``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

_RATIO = 2  # the activation's up- and downsample factor
_FILTER_TAPS = 12


@dataclass(frozen=True)
class BigVGANConfig:
    """nvidia/bigvgan_v2_24khz_100band_256x config.json values."""

    num_mels: int = 100
    upsample_rates: tuple = (4, 4, 2, 2, 2, 2)
    upsample_kernel_sizes: tuple = (8, 8, 4, 4, 4, 4)
    upsample_initial_channel: int = 1536
    resblock_kernel_sizes: tuple = (3, 7, 11)
    resblock_dilation_sizes: tuple = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    activation: str = "snakebeta"
    snake_logscale: bool = True
    use_bias_at_final: bool = False
    use_tanh_at_final: bool = False
    sample_rate: int = 24_000


def kaiser_sinc_filter1d(cutoff: float, half_width: float, kernel_size: int) -> np.ndarray:
    """Kaiser-windowed sinc low-pass (alias-free-torch's resample filter)."""
    even = kernel_size % 2 == 0
    half_size = kernel_size // 2
    delta_f = 4 * half_width
    A = 2.285 * (half_size - 1) * np.pi * delta_f + 7.95
    if A > 50.0:
        beta = 0.1102 * (A - 8.7)
    elif A >= 21.0:
        beta = 0.5842 * (A - 21) ** 0.4 + 0.07886 * (A - 21.0)
    else:
        beta = 0.0
    window = np.kaiser(kernel_size, beta)
    time = np.arange(-half_size, half_size) + 0.5 if even else np.arange(kernel_size) - half_size
    if cutoff == 0:
        return np.zeros(kernel_size)
    f = 2 * cutoff * window * np.sinc(2 * cutoff * time)
    return (f / np.sum(f)).astype(np.float32)  # DC gain 1


def aa_filter() -> np.ndarray:
    """The activation's low-pass (cutoff 0.5 / ratio, half width 0.6 / ratio)."""
    return kaiser_sinc_filter1d(0.5 / _RATIO, 0.6 / _RATIO, _FILTER_TAPS)


def snake_beta(x, alpha, beta, logscale: bool):
    """SnakeBeta x + 1/(beta + eps) sin^2(alpha x), per channel ([b, c, t])."""
    alpha, beta = alpha[None, :, None], beta[None, :, None]
    if logscale:
        alpha, beta = torch.exp(alpha), torch.exp(beta)
    return x + (1.0 / (beta + 1e-9)) * torch.square(torch.sin(x * alpha))


def upsample2(x, filt):
    """[b, c, t] -> [b, c, 2t] alias-free 2x upsample (alias-free-torch
    UpSample1d): replicate pad k//2 - 1, grouped stride-2 transposed conv by
    the filter scaled by 2 (``filt`` [c, 1, k], already scaled), then a crop
    of exactly 2t samples (equal crops on both sides for k = 12)."""
    k = filt.shape[-1]
    pad = k // _RATIO - 1
    crop = pad * _RATIO + (k - _RATIO) // 2
    y = F.conv_transpose1d(F.pad(x, (pad, pad), mode="replicate"), filt, stride=_RATIO,
                           groups=x.shape[1])
    return y[..., crop: crop + _RATIO * x.shape[-1]]


def downsample2(x, filt):
    """[b, c, 2t] -> [b, c, t] (alias-free-torch LowPassFilter1d: replicate
    pad (k//2 - 1, k//2), grouped stride-2 conv; ``filt`` [c, 1, k])."""
    k = filt.shape[-1]
    pad_l = k // 2 - (1 if k % 2 == 0 else 0)
    return F.conv1d(F.pad(x, (pad_l, k // 2), mode="replicate"), filt, stride=_RATIO,
                    groups=x.shape[1])


class SnakeBeta(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(channels))  # log scale: exp(0) = 1
        self.beta = nn.Parameter(torch.zeros(channels))


class Activation1d(nn.Module):
    """Anti-aliased SnakeBeta: 2x upsample -> snake -> 2x downsample."""

    def __init__(self, channels: int, logscale: bool = True):
        super().__init__()
        self.act = SnakeBeta(channels)
        self.logscale = logscale
        f = torch.from_numpy(aa_filter())[None, None].repeat(channels, 1, 1)
        self.register_buffer("up_filter", f * float(_RATIO), persistent=False)
        self.register_buffer("down_filter", f.clone(), persistent=False)

    def forward(self, x):
        y = upsample2(x, self.up_filter.to(x.dtype))
        y = snake_beta(y, self.act.alpha.to(x.dtype), self.act.beta.to(x.dtype), self.logscale)
        return downsample2(y, self.down_filter.to(x.dtype))


def _pad(k: int, d: int = 1) -> int:
    return (k * d - d) // 2


class AMPBlock1(nn.Module):
    """len(d) dilated convs1 and len(d) undilated convs2, each after an
    anti-aliased activation (2 len(d) in all), with a residual per pair."""

    def __init__(self, channels: int, kernel_size: int, dilations=(1, 3, 5),
                 logscale: bool = True):
        super().__init__()
        self.convs1 = nn.ModuleList([nn.Conv1d(channels, channels, kernel_size, dilation=d,
                                               padding=_pad(kernel_size, d)) for d in dilations])
        self.convs2 = nn.ModuleList([nn.Conv1d(channels, channels, kernel_size,
                                               padding=_pad(kernel_size)) for _ in dilations])
        self.activations = nn.ModuleList([Activation1d(channels, logscale)
                                          for _ in range(2 * len(dilations))])

    def forward(self, x):
        for i, (c1, c2) in enumerate(zip(self.convs1, self.convs2)):
            xt = c2(self.activations[2 * i + 1](c1(self.activations[2 * i](x))))
            x = x + xt
        return x


class BigVGAN(nn.Module):
    """The generator; ``decode`` runs it on [b, n, num_mels] mels."""

    def __init__(self, cfg: BigVGANConfig = BigVGANConfig()):
        super().__init__()
        self.cfg = cfg
        ch = cfg.upsample_initial_channel
        self.conv_pre = nn.Conv1d(cfg.num_mels, ch, 7, padding=3)
        ups, res = [], []
        for r, k in zip(cfg.upsample_rates, cfg.upsample_kernel_sizes):
            ups.append(nn.ModuleList([nn.ConvTranspose1d(ch, ch // 2, k, stride=r,
                                                         padding=(k - r) // 2)]))
            ch //= 2
            res += [AMPBlock1(ch, rk, d, cfg.snake_logscale)
                    for rk, d in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes)]
        self.ups = nn.ModuleList(ups)
        self.resblocks = nn.ModuleList(res)
        self.activation_post = Activation1d(ch, cfg.snake_logscale)
        self.conv_post = nn.Conv1d(ch, 1, 7, padding=3, bias=cfg.use_bias_at_final)


def activations(voc: BigVGAN) -> list[Activation1d]:
    """Every anti-aliased activation of ``voc``, in the order a decode runs them."""
    out = [m for blk in voc.resblocks for m in blk.activations]
    return out + [voc.activation_post]


@torch.inference_mode()
def decode(voc: BigVGAN, mel: torch.Tensor) -> torch.Tensor:
    """[b, n, num_mels] log-mel -> [b, n * 256] waveform in [-1, 1]."""
    cfg = voc.cfg
    n_res = len(cfg.resblock_kernel_sizes)
    x = voc.conv_pre(mel.transpose(1, 2))
    for i, up in enumerate(voc.ups):
        x = up[0](x)
        acc = voc.resblocks[i * n_res](x)
        for j in range(1, n_res):
            acc = acc + voc.resblocks[i * n_res + j](x)
        x = acc / n_res
    x = voc.conv_post(voc.activation_post(x))
    x = torch.tanh(x) if cfg.use_tanh_at_final else torch.clamp(x, -1.0, 1.0)
    return x[:, 0]
