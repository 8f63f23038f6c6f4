"""MMDiT backbone: the SD3-style dual-stream (audio + text) joint-attention DiT.

JAX counterpart: ``f5_tts_tpu/models/mmdit.py``.  ``MMDiT`` holds the
reference's module tree (``time_embed``, ``text_embed.text_embed``,
``audio_embed.linear`` / ``.conv_pos_embed``, ``transformer_blocks.{i}``
with ``attn_norm_x``, ``attn_norm_c``, ``attn.to_q`` ... ``to_q_c``,
``to_k_c``, ``to_v_c``, ``to_out.0``, ``to_out_c``, the optional
``q_norm`` / ``k_norm`` / ``c_q_norm`` / ``c_k_norm``, ``ff_x``, ``ff_c``;
``norm_out``, ``proj_out``; JAX ``utils/ckpt.py:276-333``).  The functions
mirror the JAX ones: a separate AdaLN-zero modulation per stream; joint
attention over the concatenated [audio, text] sequence with separate rotary
tables; the last block ``context_pre_only`` (``adaln_final`` on the text
stream, no ``to_out_c``, no ``ff_c``); ``forward``, ``forward_with_text``
and the fused-CFG ``forward_cfg``, each with ``attn_mask_enabled``.

Joint attention (JAX :105-170): with ``attn_mask_enabled`` and a mask, the
keys are valid in the audio prefix [0, len_a) and the text prefix
[n, n + len_t), so the attention runs ``flash_attention_two_segment``
(kernel F) or, on the training backends, its differentiable
``flash_attention_two_segment_trainable`` (kernels C, D, E in the
two-segment mode), with ``seg = n``; ``"sdpa"`` runs the plain einsum with
the concatenated mask.  Without the mask, every key is valid and the
attention goes through ``ops/attention.attention`` with ``mask=None``
(kernel A, or C, D, E when training).

The text stream keeps its own length and adds the ``text_max_pos`` absolute
table; a longer text raises ``ValueError``, where the JAX function fails on
a broadcast (the serving engine pads the text to the bucket width, so MMDiT
serves buckets of at most ``text_max_pos`` frames).  Under tensor
parallelism (``parallel/mesh.shard_params``) the joint attention runs
``heads / tp`` heads of both streams, the text stream's ``*_c`` projections
split as the audio ones, and F (or C, D, E in the two-segment mode) at
those heads; the feed-forwards split their columns.  With
``checkpoint_activations`` each block runs under activation checkpointing
with the config's ``remat_policy`` (``models/remat.py``).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from f5_tts_tpu_torch.models import layers as L
from f5_tts_tpu_torch.models import remat
from f5_tts_tpu_torch.models.configs import MMDiTConfig
from f5_tts_tpu_torch.ops.attention import attention, sdpa
from f5_tts_tpu_torch.ops.flash_attention import (flash_attention_two_segment,
                                                  flash_attention_two_segment_trainable)
from f5_tts_tpu_torch.ops.rope import apply_rotary, device_table
from f5_tts_tpu_torch.parallel.tensor import tp_of

_TRAIN_BACKENDS = ("flash_train", "train_auto")


class TextEmbedding(nn.Module):
    def __init__(self, cfg: MMDiTConfig):
        super().__init__()
        self.text_embed = nn.Embedding(cfg.text_num_embeds + 1, cfg.dim)


class AudioEmbedding(nn.Module):
    def __init__(self, cfg: MMDiTConfig):
        super().__init__()
        self.linear = nn.Linear(cfg.mel_dim * 2, cfg.dim)
        self.conv_pos_embed = L.ConvPositionEmbedding(cfg.dim)


class JointAttention(nn.Module):
    """Joint-attention projections (reference modules.py:563-705)."""

    def __init__(self, dim: int, heads: int, dim_head: int, qk_norm: str | None,
                 context_pre_only: bool):
        super().__init__()
        inner = heads * dim_head
        for name in ("to_q", "to_k", "to_v", "to_q_c", "to_k_c", "to_v_c"):
            setattr(self, name, nn.Linear(dim, inner))
        self.to_out = nn.ModuleList([nn.Linear(inner, dim), nn.Dropout(0.0)])
        if not context_pre_only:
            self.to_out_c = nn.Linear(inner, dim)
        if qk_norm == "rms_norm":
            for name in ("q_norm", "k_norm", "c_q_norm", "c_k_norm"):
                setattr(self, name, L.RMSNorm(dim_head))
        elif qk_norm is not None:
            raise ValueError(f"unknown qk_norm {qk_norm!r}")


class MMDiTBlock(nn.Module):
    """Reference MMDiTBlock (modules.py:763-846)."""

    def __init__(self, cfg: MMDiTConfig, context_pre_only: bool):
        super().__init__()
        self.context_pre_only = context_pre_only
        self.attn_norm_c = (L.AdaLayerNormFinal(cfg.dim) if context_pre_only
                            else L.AdaLayerNorm(cfg.dim))
        self.attn_norm_x = L.AdaLayerNorm(cfg.dim)
        self.attn = JointAttention(cfg.dim, cfg.heads, cfg.dim_head, cfg.qk_norm,
                                   context_pre_only)
        if not context_pre_only:
            self.ff_c = L.FeedForward(cfg.dim, mult=cfg.ff_mult)
        self.ff_x = L.FeedForward(cfg.dim, mult=cfg.ff_mult)


class MMDiT(nn.Module):
    """Reference backbones/mmdit.py:87-262, with the AdaLN gates, the final
    norm and ``proj_out`` zero-initialized as the reference initializes them."""

    def __init__(self, cfg: MMDiTConfig):
        super().__init__()
        self.time_embed = L.TimestepEmbedding(cfg.dim)
        self.text_embed = TextEmbedding(cfg)
        self.audio_embed = AudioEmbedding(cfg)
        self.transformer_blocks = nn.ModuleList([
            MMDiTBlock(cfg, context_pre_only=i == cfg.depth - 1) for i in range(cfg.depth)
        ])
        self.norm_out = L.AdaLayerNormFinal(cfg.dim)
        self.proj_out = nn.Linear(cfg.dim, cfg.mel_dim)
        with torch.no_grad():
            for lin in self.zero_init_linears():
                lin.weight.zero_()
                lin.bias.zero_()

    def zero_init_linears(self) -> list[nn.Linear]:
        lins = []
        for blk in self.transformer_blocks:
            lins += [blk.attn_norm_x.linear, blk.attn_norm_c.linear]
        return lins + [self.norm_out.linear, self.proj_out]


def text_embedding(model: MMDiT, cfg: MMDiTConfig, text_ids: torch.Tensor, seq_len=None,
                   lens=None, drop_text: bool = False) -> torch.Tensor:
    """MMDiT TextEmbedding (reference mmdit.py:32-63) -> [b, nt, dim]: stays
    at TEXT length, the text runs as its own stream.  ``seq_len`` and
    ``lens`` are accepted for the backbones' common interface and unused."""
    del seq_len, lens
    nt = text_ids.shape[1]
    if nt > cfg.text_max_pos:
        raise ValueError(f"MMDiT text stream of {nt} tokens exceeds text_max_pos "
                         f"{cfg.text_max_pos}, the length of its absolute-position table")
    ids = text_ids.long() + 1
    pad_mask = ids == 0
    if drop_text:
        ids = torch.zeros_like(ids)
    emb = L.embedding(model.text_embed.text_embed, ids)
    emb = emb + device_table("abs", cfg.text_max_pos, cfg.dim, emb.device)[:nt].to(emb.dtype)
    if cfg.text_mask_padding:
        emb = emb * (~pad_mask)[..., None].to(emb.dtype)
    return emb


def audio_embedding(model: MMDiT, x, cond, drop_audio_cond: bool = False) -> torch.Tensor:
    ae = model.audio_embed
    if drop_audio_cond:
        cond = torch.zeros_like(cond)
    h = L.linear(ae.linear, torch.cat([x, cond], dim=-1))
    return L.conv_pos_embed(ae.conv_pos_embed, h) + h


def joint_attention(p: JointAttention, xn, cn, heads: int, rope_a, rope_t, mask, c_mask,
                    attn_mask_enabled: bool, backend: str):
    """-> (audio out [b, n, dim], text out [b, nt, dim] or None for the last
    block), both re-masked by their stream's mask.  Under tensor parallelism
    (``p.tp``) this rank runs its ``heads / tp`` heads of both streams (the
    ``*_c`` projections split as the audio ones) and the two ``to_out``
    projections are row-parallel."""
    b, n, _ = xn.shape
    nt = cn.shape[1]
    tp = tp_of(p)
    if tp is not None:
        heads = tp.local_heads(heads)
        xn, cn = tp.copy_in(xn), tp.copy_in(cn)

    def split(t):
        return t.reshape(b, -1, heads, t.shape[-1] // heads).transpose(1, 2)

    q, k, v = (split(L.linear(getattr(p, nm), xn)) for nm in ("to_q", "to_k", "to_v"))
    cq, ck, cv = (split(L.linear(getattr(p, nm), cn)) for nm in ("to_q_c", "to_k_c", "to_v_c"))
    if hasattr(p, "q_norm"):
        q, k = L.rms_norm(p.q_norm, q), L.rms_norm(p.k_norm, k)
        cq, ck = L.rms_norm(p.c_q_norm, cq), L.rms_norm(p.c_k_norm, ck)
    q, k = apply_rotary(q, rope_a), apply_rotary(k, rope_a)
    cq, ck = apply_rotary(cq, rope_t), apply_rotary(ck, rope_t)
    Q, K, V = (torch.cat(pair, dim=2) for pair in ((q, cq), (k, ck), (v, cv)))

    if attn_mask_enabled and mask is not None:
        cm = c_mask if c_mask is not None else torch.ones((b, nt), dtype=torch.bool,
                                                          device=xn.device)
        if backend == "sdpa":
            out = sdpa(Q, K, V, torch.cat([mask, cm], dim=1))
        elif backend in ("auto", "flash") + _TRAIN_BACKENDS:
            # both stream masks are prefixes (length-masked audio, trailing
            # text padding): keys valid in [0, len_a) U [n, n + len_t)
            fn = (flash_attention_two_segment_trainable if backend in _TRAIN_BACKENDS
                  else flash_attention_two_segment)
            out = fn(Q, K, V, mask.sum(dim=-1), cm.sum(dim=-1), seg=n)
        else:
            raise ValueError(f"unknown attention backend {backend!r}")
    else:
        out = attention(Q, K, V, mask=None, backend=backend)
    out = out.transpose(1, 2).reshape(b, n + nt, -1)
    xo = L.row_linear(p.to_out[0], out[:, :n], tp)
    co = L.row_linear(p.to_out_c, out[:, n:], tp) if hasattr(p, "to_out_c") else None
    if mask is not None:
        xo = xo * mask[..., None].to(xo.dtype)
    if co is not None and c_mask is not None:
        co = co * c_mask[..., None].to(co.dtype)
    return xo, co


def _block(bp: MMDiTBlock, x, c, t_emb, cfg: MMDiTConfig, rope_a, rope_t, mask, c_mask,
           attn_mask_enabled: bool, backend: str):
    if bp.context_pre_only:
        norm_c = L.adaln_final(bp.attn_norm_c, c, t_emb)
    else:
        norm_c, c_gate, c_shift, c_scale, c_gate_mlp = L.adaln(bp.attn_norm_c, c, t_emb)
    norm_x, x_gate, x_shift, x_scale, x_gate_mlp = L.adaln(bp.attn_norm_x, x, t_emb)
    xo, co = joint_attention(bp.attn, norm_x, norm_c, cfg.heads, rope_a, rope_t, mask, c_mask,
                             attn_mask_enabled, backend)
    if bp.context_pre_only:
        c = None
    else:
        c = c + c_gate[:, None] * co
        nc = L.layer_norm(c, eps=1e-6) * (1 + c_scale[:, None]) + c_shift[:, None]
        c = c + c_gate_mlp[:, None] * L.feedforward(bp.ff_c, nc)
    x = x + x_gate[:, None] * xo
    nx = L.layer_norm(x, eps=1e-6) * (1 + x_scale[:, None]) + x_shift[:, None]
    return x + x_gate_mlp[:, None] * L.feedforward(bp.ff_x, nx), c


def forward(model: MMDiT, cfg: MMDiTConfig, x, cond, text_emb, time, mask=None, c_mask=None,
            drop_audio_cond: bool = False, backend: str = "auto",
            attn_mask_enabled: bool = False) -> torch.Tensor:
    """MMDiT forward -> flow [b, n, mel_dim].  ``text_emb`` [b, nt, dim] at
    TEXT length; ``c_mask`` [b, nt] the text stream's valid mask."""
    b, n, _ = x.shape
    nt = text_emb.shape[1]
    if time.ndim == 0:
        time = time.expand(b)
    t_emb = L.timestep_embed(model.time_embed, time, dtype=x.dtype)
    h = audio_embedding(model, x, cond, drop_audio_cond=drop_audio_cond)
    table = device_table("rope", cfg.max_pos, cfg.dim_head, x.device)
    rope_a, rope_t = table[:n], table[:nt]
    c = text_emb

    def block(blk, h, c, t_emb):
        return _block(blk, h, c, t_emb, cfg, rope_a, rope_t, mask, c_mask, attn_mask_enabled,
                      backend)

    # each block checkpointed under checkpoint_activations (JAX :228-234)
    run = remat.block_runner(cfg, h.shape[0] * h.shape[1])
    for blk in model.transformer_blocks:
        h, c = run(blk, block, h, c, t_emb)
    h = L.adaln_final(model.norm_out, h, t_emb)
    return L.linear(model.proj_out, h)


def forward_with_text(model: MMDiT, cfg: MMDiTConfig, x, cond, text_ids, time, mask=None,
                      lens=None, drop_audio_cond: bool = False, drop_text: bool = False,
                      backend: str = "auto", attn_mask_enabled: bool = False) -> torch.Tensor:
    """Training-path forward: the text stream from the ids, its valid mask
    from the -1 padding."""
    te = text_embedding(model, cfg, text_ids, drop_text=drop_text)
    return forward(model, cfg, x, cond, te.to(x.dtype), time, mask=mask, c_mask=text_ids != -1,
                   drop_audio_cond=drop_audio_cond, backend=backend,
                   attn_mask_enabled=attn_mask_enabled)


def forward_cfg(model: MMDiT, cfg: MMDiTConfig, x, step_cond, text_emb_cond, text_emb_uncond,
                time, mask=None, c_mask=None, backend: str = "auto",
                attn_mask_enabled: bool = False):
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
    cm2 = None if c_mask is None else torch.cat([c_mask, c_mask], dim=0)
    out = forward(model, cfg, x2, cond2, te2, t2, mask=mask2, c_mask=cm2, backend=backend,
                  attn_mask_enabled=attn_mask_enabled)
    return out[:b], out[b:]


def quantize_targets(model: MMDiT) -> list[tuple[str, nn.Module, str]]:
    """The W8A8 linears of JAX ``quantize_dit_blocks`` on MMDiT's tree, as
    (name, module, weight attribute): it walks the stacked ``blocks`` only,
    i.e. every block but the last, and finds there the x-stream ``to_q``,
    ``to_k``, ``to_v`` and ``to_out`` (its ``ff`` key does not exist:
    ``ff_x`` and ``ff_c`` stay dense, as do the context projections)."""
    out = []
    for i, blk in enumerate(model.transformer_blocks[:-1]):
        pre, attn = f"transformer_blocks.{i}.attn.", blk.attn
        out += [(pre + f"{nm}.weight", getattr(attn, nm), "weight")
                for nm in ("to_q", "to_k", "to_v")]
        out.append((pre + "to_out.0.weight", attn.to_out[0], "weight"))
    return out
