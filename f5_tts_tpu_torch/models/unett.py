"""UNetT backbone (E2-TTS): a flat U-Net transformer over mel frames.

JAX counterpart: ``f5_tts_tpu/models/unett.py``.  ``UNetT`` holds the
reference's module tree (``time_embed``, ``text_embed``, ``input_embed``,
``layers.{i}.[0 skip_proj, 1 attn_norm, 2 attn, 3 ff_norm, 4 ff]``,
``norm_out``, ``proj_out``; JAX ``utils/ckpt.py:213-275``), so a released
E2TTS state dict loads by key.  The functions below mirror the JAX ones:
``rms_norm_xt`` (x_transformers RMSNorm, param ``g``), ``text_embedding``
(ids + 1 with filler 0, the pad mask taken before ``drop_text``, no
per-sample length masking), ``forward`` (the time embedding prepended as a
sequence token, :136-139; the first half of the blocks pushes its pre-block
input, the second half pops LIFO and concatenates it through ``skip_proj``,
or adds it), ``forward_with_text``, the fused-CFG ``forward_cfg`` and the
serving qkv fusion ``fuse_for_inference``.

The JAX forward pads the n + 1 tokens to a 256-multiple so its Pallas
kernel stays eligible (:140-157), the padded rows masked out; the port's
kernels take any length, so it does not pad, which gives the same output.
The rotary table covers the n + 1 tokens even past ``max_pos`` (:155-157).
With ``checkpoint_activations`` each layer, its skip merge included, runs
under activation checkpointing with the config's ``remat_policy``
(``models/remat.py``).  Under tensor parallelism
(``parallel/mesh.shard_params``, as JAX serves UNetT over ``model``) each
layer's attention and feed-forward run their share of the heads and
columns (``layers.mha``, ``layers.feedforward``); the rest is replicated.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from f5_tts_tpu_torch.models import layers as L
from f5_tts_tpu_torch.models import remat
from f5_tts_tpu_torch.models.configs import UNetTConfig
from f5_tts_tpu_torch.ops.rope import device_table


class RMSNormXT(nn.Module):
    """x_transformers RMSNorm: y = normalize(x) * sqrt(dim) * g."""

    def __init__(self, dim: int):
        super().__init__()
        self.g = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return rms_norm_xt(self, x)


def rms_norm_xt(p: RMSNormXT, x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    norm = torch.sqrt(xf.square().sum(dim=-1, keepdim=True))
    y = xf / torch.clamp(norm, min=1e-12) * (x.shape[-1] ** 0.5)
    return y.to(x.dtype) * p.g.to(x.dtype)


class TextEmbedding(nn.Module):
    def __init__(self, cfg: UNetTConfig):
        super().__init__()
        text_dim = cfg.text_dim or cfg.mel_dim
        self.text_embed = nn.Embedding(cfg.text_num_embeds + 1, text_dim)
        self.text_blocks = nn.Sequential(*[
            L.ConvNeXtV2Block(text_dim, text_dim * cfg.conv_mult) for _ in range(cfg.conv_layers)
        ])


class InputEmbedding(nn.Module):
    def __init__(self, cfg: UNetTConfig):
        super().__init__()
        self.proj = nn.Linear(cfg.mel_dim * 2 + (cfg.text_dim or cfg.mel_dim), cfg.dim)
        self.conv_pos_embed = L.ConvPositionEmbedding(cfg.dim)


class UNetT(nn.Module):
    """Reference backbones/unett.py:108-307.  Each layer is a ModuleList of
    [skip_proj (second half, ``concat`` only; else None), attn_norm, attn,
    ff_norm, ff], as the reference's state dict numbers them."""

    def __init__(self, cfg: UNetTConfig):
        super().__init__()
        if cfg.depth % 2:
            raise ValueError(f"UNetT depth must be even, got {cfg.depth}")
        self.time_embed = L.TimestepEmbedding(cfg.dim)
        self.text_embed = TextEmbedding(cfg)
        self.input_embed = InputEmbedding(cfg)
        half = cfg.depth // 2
        self.layers = nn.ModuleList()
        for i in range(cfg.depth):
            skip = (nn.Linear(cfg.dim * 2, cfg.dim, bias=False)
                    if i >= half and cfg.skip_connect_type == "concat" else None)
            self.layers.append(nn.ModuleList([
                skip,
                RMSNormXT(cfg.dim),
                L.Attention(cfg.dim, cfg.heads, cfg.dim_head, qk_norm=cfg.qk_norm),
                RMSNormXT(cfg.dim),
                L.FeedForward(cfg.dim, mult=cfg.ff_mult),
            ]))
        self.norm_out = RMSNormXT(cfg.dim)
        self.proj_out = nn.Linear(cfg.dim, cfg.mel_dim)

    def zero_init_linears(self) -> list[nn.Linear]:
        return []  # the reference zero-initializes nothing in UNetT


def text_embedding(model: UNetT, cfg: UNetTConfig, text_ids: torch.Tensor, seq_len: int,
                   lens: torch.Tensor | None = None, drop_text: bool = False) -> torch.Tensor:
    """UNetT TextEmbedding (reference unett.py:54-84) -> [b, seq_len,
    text_dim].  ``lens`` is accepted for the backbones' common interface and
    unused, as the reference UNetT ignores per-sample speech lengths."""
    del lens
    te = model.text_embed
    ids = text_ids.long() + 1  # 0 becomes the filler token
    nt = ids.shape[1]
    ids = ids[:, :seq_len] if nt >= seq_len else F.pad(ids, (0, seq_len - nt))
    pad_mask = ids == 0
    if drop_text:
        ids = torch.zeros_like(ids)
    emb = L.embedding(te.text_embed, ids)
    if cfg.conv_layers > 0:
        text_dim = cfg.text_dim or cfg.mel_dim
        emb = emb + device_table("abs", cfg.max_pos, text_dim, emb.device)[:seq_len].to(emb.dtype)
        if cfg.text_mask_padding:
            keep = (~pad_mask)[..., None].to(emb.dtype)
            emb = emb * keep
            for blk in te.text_blocks:
                emb = L.convnext_v2(blk, emb) * keep
        else:
            for blk in te.text_blocks:
                emb = L.convnext_v2(blk, emb)
    return emb


def _block(layer: nn.ModuleList, x, mask, rope, cfg: UNetTConfig, backend: str):
    _, attn_norm, attn, ff_norm, ff = layer
    h = rms_norm_xt(attn_norm, x)
    x = L.mha(attn, h, cfg.heads, mask=mask, rope_freqs=rope, pe_attn_head=cfg.pe_attn_head,
              backend=backend) + x
    return L.feedforward(ff, rms_norm_xt(ff_norm, x)) + x


def forward(model: UNetT, cfg: UNetTConfig, x, cond, text_emb, time, mask=None,
            drop_audio_cond: bool = False, backend: str = "auto") -> torch.Tensor:
    """UNetT forward with the text embedding precomputed -> flow [b, n, mel_dim]."""
    b, n, _ = x.shape
    if time.ndim == 0:
        time = time.expand(b)
    t_emb = L.timestep_embed(model.time_embed, time, dtype=x.dtype)
    if drop_audio_cond:
        cond = torch.zeros_like(cond)
    ie = model.input_embed
    h = L.linear(ie.proj, torch.cat([x, cond, text_emb], dim=-1))
    h = L.conv_pos_embed(ie.conv_pos_embed, h) + h  # no audio mask (reference unett.py:96-102)

    # the time embedding as a leading token (reference unett.py:271-274)
    h = torch.cat([t_emb[:, None, :].to(h.dtype), h], dim=1)
    if mask is not None:
        mask = F.pad(mask, (1, 0), value=True)
    rope = device_table("rope", max(cfg.max_pos + 1, n + 1), cfg.dim_head, x.device)[:n + 1]

    def first(layer, h):
        return _block(layer, h, mask, rope, cfg, backend)

    def second(layer, h, skip):
        if cfg.skip_connect_type == "concat":
            h = L.linear(layer[0], torch.cat([h, skip], dim=-1))
        elif cfg.skip_connect_type == "add":
            h = h + skip
        return _block(layer, h, mask, rope, cfg, backend)

    # each layer (with its skip merge) checkpointed under checkpoint_activations (JAX :172-179)
    run = remat.block_runner(cfg, h.shape[0] * h.shape[1])
    half = cfg.depth // 2
    skips = []
    for i, layer in enumerate(model.layers):
        if i < half:
            skips.append(h)  # the PRE-block input: the reference appends before the block
            h = run(layer, first, h)
        else:
            h = run(layer, second, h, skips.pop())  # LIFO
    h = rms_norm_xt(model.norm_out, h)[:, 1:n + 1]
    return L.linear(model.proj_out, h)


def forward_with_text(model: UNetT, cfg: UNetTConfig, x, cond, text_ids, time, mask=None,
                      lens=None, drop_audio_cond: bool = False, drop_text: bool = False,
                      backend: str = "auto") -> torch.Tensor:
    """Training-path forward: the text encoder runs inline with the drop flags."""
    te = text_embedding(model, cfg, text_ids, x.shape[1], lens=lens, drop_text=drop_text)
    return forward(model, cfg, x, cond, te.to(x.dtype), time, mask=mask,
                   drop_audio_cond=drop_audio_cond, backend=backend)


def forward_cfg(model: UNetT, cfg: UNetTConfig, x, step_cond, text_emb_cond, text_emb_uncond,
                time, mask=None, backend: str = "auto"):
    """Fused classifier-free guidance: cond and uncond rows as one 2B batch.
    Returns (pred, null_pred)."""
    b = x.shape[0]
    x2 = torch.cat([x, x], dim=0)
    cond2 = torch.cat([step_cond, torch.zeros_like(step_cond)], dim=0)
    te2 = torch.cat([text_emb_cond, text_emb_uncond], dim=0)
    if time.ndim == 0:
        time = time.expand(b)
    t2 = torch.cat([time, time], dim=0)
    mask2 = None if mask is None else torch.cat([mask, mask], dim=0)
    out = forward(model, cfg, x2, cond2, te2, t2, mask=mask2, backend=backend)
    return out[:b], out[b:]


def fuse_for_inference(model: UNetT) -> UNetT:
    """Serving transform: fuse every layer's q/k/v projections into one
    matmul (JAX ``fuse_for_inference``).  The state dict is unchanged."""
    for layer in model.layers:
        layer[2].fuse_qkv()
    return model
