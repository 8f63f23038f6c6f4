"""DiT backbone: AdaLN-zero diffusion transformer over mel frames.

JAX counterpart: ``f5_tts_tpu/models/dit.py``.  ``DiT`` holds the reference's
module tree (``time_embed``, ``text_embed``, ``input_embed``,
``transformer_blocks``, ``norm_out``, ``proj_out``); the functions below
mirror the JAX ones: ``text_embedding`` (ids + 1 with filler 0, pad mask
taken before ``drop_text``, abs-pos masked by the valid length, optional
average upsampling), ``input_embedding``, ``precompute_adaln``, ``forward``
the training forward ``forward_with_text`` and the fused-CFG ``forward_cfg``
(cond and uncond packed as one 2B batch).  ``forward`` is differentiable end
to end; with ``backend="train_auto"`` its attention runs the training
kernels.  ``fuse_for_inference`` is the serving qkv fusion.  With
``checkpoint_activations`` each block runs under activation checkpointing
with the config's ``remat_policy`` (``models/remat.py``; JAX :258-278).

``activation_constraint`` (JAX :169-182, 222-282, 306-351) is sequence
parallelism's hook (``parallel/sequence.make_seq_constraint``): ``forward``
computes the input embedding on all frames, calls the hook once to keep
this rank's frames, runs the blocks on them with the mask and the RoPE
table sliced alike (RoPE at global positions), and all-gathers the output
frames (``hook.gather``).  The blocks' attention is then the ring backend.

``block_scan`` (JAX :219-256) replaces the loop over the blocks, called as
``block_scan(blocks, h, t_emb, mask, rope) -> h``: the GPipe pipeline's
hook (``parallel/pipeline.make_dit_block_scan``).  Under tensor parallelism
(``parallel/mesh.shard_params``) every block's attention and feed-forward
run their share of the heads and columns; the rest is replicated.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from f5_tts_tpu_torch.models import layers as L
from f5_tts_tpu_torch.models import remat
from f5_tts_tpu_torch.models.configs import DiTConfig
from f5_tts_tpu_torch.ops.rope import device_table


class TextEmbedding(nn.Module):
    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.text_embed = nn.Embedding(cfg.text_num_embeds + 1, cfg.text_dim)
        self.text_blocks = nn.Sequential(*[
            L.ConvNeXtV2Block(cfg.text_dim, cfg.text_dim * cfg.conv_mult)
            for _ in range(cfg.conv_layers)
        ])


class InputEmbedding(nn.Module):
    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.proj = nn.Linear(cfg.mel_dim * 2 + cfg.text_dim, cfg.dim)
        self.conv_pos_embed = L.ConvPositionEmbedding(cfg.dim)


class DiT(nn.Module):
    """Reference backbones/dit.py:170-370, zero-initialized AdaLN gates and
    output projection as the reference initializes them."""

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.time_embed = L.TimestepEmbedding(cfg.dim)
        self.text_embed = TextEmbedding(cfg)
        self.input_embed = InputEmbedding(cfg)
        self.transformer_blocks = nn.ModuleList([
            L.DiTBlock(cfg.dim, cfg.heads, cfg.dim_head, ff_mult=cfg.ff_mult, qk_norm=cfg.qk_norm)
            for _ in range(cfg.depth)
        ])
        if cfg.long_skip_connection:
            self.long_skip_connection = nn.Linear(cfg.dim * 2, cfg.dim, bias=False)
        self.norm_out = L.AdaLayerNormFinal(cfg.dim)
        self.proj_out = nn.Linear(cfg.dim, cfg.mel_dim)
        with torch.no_grad():
            for blk in self.transformer_blocks:
                blk.attn_norm.linear.weight.zero_()
                blk.attn_norm.linear.bias.zero_()
            for lin in (self.norm_out.linear, self.proj_out):
                lin.weight.zero_()
                lin.bias.zero_()

    def zero_init_linears(self) -> list[nn.Linear]:
        """The projections the reference zero-initializes (AdaLN, final norm,
        ``proj_out``); ``backbones.randomize_zero_init`` fills them."""
        return [blk.attn_norm.linear for blk in self.transformer_blocks] + [
            self.norm_out.linear, self.proj_out]


def _avg_upsample(emb, text_lens, audio_lens, seq_len):
    """ZipVoice-style average upsampling (reference dit.py:55-84): token j of
    a row repeats base (+1 for the last ``rem`` tokens) times over its
    audio length."""
    p = torch.arange(seq_len, device=emb.device)[None, :]
    tl = text_lens.clamp(min=1)[:, None]
    al = audio_lens[:, None]
    base = al // tl
    rem = al % tl
    cut = (tl - rem) * base
    idx = torch.where(p < cut, p // base.clamp(min=1), (tl - rem) + (p - cut) // (base + 1))
    idx = torch.minimum(idx.clamp(min=0), tl - 1)
    out = torch.gather(emb, 1, idx[..., None].expand(-1, -1, emb.shape[-1]))
    keep = (p < al) & (text_lens > 0)[:, None]
    return torch.where(keep[..., None], out, torch.zeros_like(out))


def text_embedding(model: DiT, cfg: DiTConfig, text_ids: torch.Tensor, seq_len: int,
                   lens: torch.Tensor | None = None, drop_text: bool = False) -> torch.Tensor:
    """TextEmbedding forward (reference dit.py:86-139) -> [b, seq_len, text_dim].
    ``text_ids`` [b, nt] are -1 padded."""
    te = model.text_embed
    ids = text_ids.long() + 1  # 0 becomes the filler token
    nt = ids.shape[1]
    ids = ids[:, :seq_len] if nt >= seq_len else F.pad(ids, (0, seq_len - nt))
    valid = None
    if lens is not None:
        valid = torch.arange(seq_len, device=ids.device)[None, :] < lens[:, None]
        ids = torch.where(valid, ids, torch.zeros_like(ids))
    # pad mask taken BEFORE drop_text: the uncond stream keeps the cond
    # stream's padding geometry (reference dit.py:103-107)
    pad_mask = ids == 0
    if drop_text:
        ids = torch.zeros_like(ids)
    emb = L.embedding(te.text_embed, ids)
    if valid is not None:
        emb = torch.where(valid[..., None], emb, torch.zeros_like(emb))
    if cfg.conv_layers > 0:
        freqs = device_table("abs", cfg.max_pos, cfg.text_dim, emb.device)[:seq_len].to(emb.dtype)
        if valid is not None:
            freqs = freqs[None] * valid[..., None].to(emb.dtype)
        emb = emb + freqs
        if cfg.text_mask_padding:
            keep = (~pad_mask)[..., None].to(emb.dtype)
            emb = emb * keep
            for blk in te.text_blocks:
                emb = L.convnext_v2(blk, emb) * keep
        else:
            for blk in te.text_blocks:
                emb = L.convnext_v2(blk, emb)
    if cfg.text_embedding_average_upsampling:
        text_lens = (~pad_mask).sum(dim=1)
        target = lens if lens is not None else torch.full_like(text_lens, seq_len)
        emb = _avg_upsample(emb, text_lens, target, seq_len)
    return emb


def input_embedding(model: DiT, x, cond, text_emb, drop_audio_cond=False, mask=None):
    """InputEmbedding (reference dit.py:145-164)."""
    ie = model.input_embed
    if drop_audio_cond:
        cond = torch.zeros_like(cond)
    h = L.linear(ie.proj, torch.cat([x, cond, text_emb], dim=-1))
    return L.conv_pos_embed(ie.conv_pos_embed, h, mask=mask) + h


def precompute_adaln(model: DiT, cfg: DiTConfig, times: torch.Tensor, dtype=torch.float32):
    """AdaLN modulations for a known timestep schedule ``times`` [S]:
    (block_mods [S, depth, 6 dim], final_mods [S, 2 dim])."""
    t_emb = L.timestep_embed(model.time_embed, times.to(dtype), dtype=dtype)
    h = F.silu(t_emb)
    mods = torch.stack([
        F.linear(h, blk.attn_norm.linear.weight.to(dtype), blk.attn_norm.linear.bias.to(dtype))
        for blk in model.transformer_blocks
    ], dim=1)
    return mods, L.linear(model.norm_out.linear, h)


def forward(model: DiT, cfg: DiTConfig, x, cond, text_emb, time, mask=None,
            drop_audio_cond: bool = False, backend="auto", adaln_mods=None,
            activation_constraint=None, block_scan=None):
    """DiT forward with the text embedding precomputed -> flow [b, n, mel_dim].

    ``adaln_mods``: optional (block_mods [depth, 6 dim], final_mod [2 dim])
    from ``precompute_adaln`` for one shared timestep, or per row
    ([depth, b, 6 dim], [b, 2 dim]); ``time`` is then unused.
    ``activation_constraint``: the sequence-parallel hook, ``block_scan``
    the pipeline's (module docstring).
    """
    b, n, _ = x.shape
    if adaln_mods is None:
        if time.ndim == 0:
            time = time.expand(b)
        t_emb = L.timestep_embed(model.time_embed, time, dtype=x.dtype)
    else:
        t_emb = None
    h = input_embedding(model, x, cond, text_emb, drop_audio_cond=drop_audio_cond, mask=mask)
    rope = device_table("rope", cfg.max_pos, cfg.dim_head, x.device)[:n]
    seq = activation_constraint
    if seq is not None:  # this rank's frames from here to the gather
        h = seq(h)
        rope = seq.shard(rope, dim=0)
        mask = None if mask is None else seq.shard(mask, dim=1)
    residual = h if cfg.long_skip_connection else None

    def block(blk, h, t_emb, mod):
        return L.dit_block(blk, h, t_emb, cfg.heads, mask=mask, rope_freqs=rope,
                           pe_attn_head=cfg.pe_attn_head, backend=backend, mod=mod)

    if block_scan is not None:
        h = block_scan(model.transformer_blocks, h, t_emb, mask, rope)
    else:
        run = remat.block_runner(cfg, b * n)  # checkpointed under checkpoint_activations
        for i, blk in enumerate(model.transformer_blocks):
            mod = None if adaln_mods is None else adaln_mods[0][i].to(h.dtype)
            h = run(blk, block, h, t_emb, mod)
    if residual is not None:
        h = L.linear(model.long_skip_connection, torch.cat([h, residual], dim=-1))
    if adaln_mods is not None:
        h = L.adaln_final_from_mod(adaln_mods[1].to(h.dtype), h)
    else:
        h = L.adaln_final(model.norm_out, h, t_emb)
    out = L.linear(model.proj_out, h)
    return out if seq is None else seq.gather(out)


def forward_with_text(model: DiT, cfg: DiTConfig, x, cond, text_ids, time, mask=None, lens=None,
                      drop_audio_cond: bool = False, drop_text: bool = False,
                      backend="auto", activation_constraint=None, block_scan=None):
    """Training-path forward (JAX ``forward_with_text``, dit.py:293-316):
    the text encoder runs inline with the drop flags."""
    te = text_embedding(model, cfg, text_ids, x.shape[1], lens=lens, drop_text=drop_text)
    return forward(model, cfg, x, cond, te.to(x.dtype), time, mask=mask,
                   drop_audio_cond=drop_audio_cond, backend=backend,
                   activation_constraint=activation_constraint, block_scan=block_scan)


def forward_cfg(model: DiT, cfg: DiTConfig, x, step_cond, text_emb_cond, text_emb_uncond, time,
                mask=None, backend="auto", adaln_mods=None, activation_constraint=None,
                block_scan=None):
    """Fused classifier-free guidance: cond and uncond rows as one 2B batch
    (reference cfg_infer, dit.py:337-346).  Returns (pred, null_pred)."""
    b = x.shape[0]
    x2 = torch.cat([x, x], dim=0)
    cond2 = torch.cat([step_cond, torch.zeros_like(step_cond)], dim=0)
    te2 = torch.cat([text_emb_cond, text_emb_uncond], dim=0)
    if time.ndim == 0:
        time = time.expand(b)
    t2 = torch.cat([time, time], dim=0)
    mask2 = None if mask is None else torch.cat([mask, mask], dim=0)
    if adaln_mods is not None and adaln_mods[0].ndim == 3:
        # per-row mods ([depth, rows, 6 dim], [rows, 2 dim], the Picard
        # window's) double with the rows; shared-time mods broadcast
        adaln_mods = (torch.cat([adaln_mods[0], adaln_mods[0]], dim=1),
                      torch.cat([adaln_mods[1], adaln_mods[1]], dim=0))
    out = forward(model, cfg, x2, cond2, te2, t2, mask=mask2, backend=backend,
                  adaln_mods=adaln_mods, activation_constraint=activation_constraint,
                  block_scan=block_scan)
    return out[:b], out[b:]


def fuse_for_inference(model: DiT) -> DiT:
    """Serving transform: fuse every block's q/k/v projections into one
    matmul (JAX ``fuse_for_inference``).  The state dict is unchanged."""
    for blk in model.transformer_blocks:
        blk.attn.fuse_qkv()
    return model


def quantize_targets(model: DiT) -> list[tuple[str, nn.Module, str]]:
    """The W8A8 linears of JAX ``quantize_dit_blocks`` as (name, module,
    weight attribute): in every block the fused qkv (to_q, to_k, to_v when
    not fused), ``attn.to_out.0``, ``ff.ff.0.0`` and ``ff.ff.2``."""
    out = []
    for i, blk in enumerate(model.transformer_blocks):
        pre, attn = f"transformer_blocks.{i}.", blk.attn
        if attn.qkv_weight is not None:
            out.append((pre + "attn.qkv_weight", attn, "qkv_weight"))
        else:
            out += [(pre + f"attn.{nm}.weight", getattr(attn, nm), "weight")
                    for nm in ("to_q", "to_k", "to_v")]
        out += [(pre + "attn.to_out.0.weight", attn.to_out[0], "weight"),
                (pre + "ff.ff.0.0.weight", blk.ff.ff[0][0], "weight"),
                (pre + "ff.ff.2.weight", blk.ff.ff[2], "weight")]
    return out
