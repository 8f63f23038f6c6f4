"""Layer library: reference-named ``nn.Module``s and plain functions on them.

JAX counterpart: ``f5_tts_tpu/models/layers.py``.  Each module holds the
parameters under the reference's own names (``to_q``, ``to_out.0``,
``ff.0.0``, ``conv1d.0``, ``grn.gamma`` ...), so released checkpoints load
with no conversion; each ``forward`` calls the function of the same name
below, which mirrors the JAX function's numerics (LayerNorm statistics in
fp32, then cast; embedding ids clamped; output re-mask after attention).

Layout: sequences are [b, n, d] as in the JAX package; convolutions
transpose to torch's [b, d, n] internally.  The int8 ``kernel_q`` branch of
the JAX ``linear`` (W8A8 serving) is taken when a linear holds the
non-persistent buffers ``weight_q`` / ``w_scale`` (``qkv_weight_q`` /
``qkv_w_scale`` for the fused qkv) that ``ops.quant.quantize_dit_blocks``
sets; it runs ``ops.quant.linear_w8a8`` (kernel G on the card).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from f5_tts_tpu_torch.ops.attention import attention
from f5_tts_tpu_torch.ops import fused_convpos
from f5_tts_tpu_torch.ops.fused_convpos import conv_pos_fused, conv_pos_plain, kernel_taps
from f5_tts_tpu_torch.ops.quant import linear_w8a8
from f5_tts_tpu_torch.ops.rope import head_major, rope_qkv, rope_qkv_takes, rotate_heads
from f5_tts_tpu_torch.parallel.tensor import rotary_heads, tp_of

# ---------------------------------------------------------------------------
# primitives


def linear(p: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    w_q = getattr(p, "weight_q", None)
    if w_q is not None:  # W8A8 serving (EngineOptions.quantize)
        return linear_w8a8(x, w_q, p.w_scale, p.bias)
    return F.linear(x, p.weight, p.bias)


def row_linear(p: nn.Linear, x: torch.Tensor, tp) -> torch.Tensor:
    """A row-parallel linear: this rank's input features times its weight
    columns, summed over the ``model`` ranks, then the bias once."""
    if tp is None:
        return linear(p, x)
    y = tp.reduce(F.linear(x, p.weight))
    return y if p.bias is None else y + p.bias


def embedding(p: nn.Embedding, ids: torch.Tensor) -> torch.Tensor:
    # out-of-range ids clamp to the table, as JAX's take(mode="clip")
    return F.embedding(ids.clamp(0, p.num_embeddings - 1), p.weight)


def layer_norm(x, weight=None, bias=None, eps: float = 1e-6):
    """LayerNorm over the last axis with fp32 statistics, cast back to x's
    dtype before the affine part."""
    y = F.layer_norm(x.float(), (x.shape[-1],), eps=eps).to(x.dtype)
    if weight is not None:
        y = y * weight
    if bias is not None:
        y = y + bias
    return y


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return rms_norm(self, x)


def rms_norm(p: RMSNorm, x):
    var = x.float().pow(2).mean(dim=-1, keepdim=True)
    y = (x.float() * torch.rsqrt(var + p.eps)).to(x.dtype)
    return y * p.weight.to(x.dtype)


def conv1d(p: nn.Conv1d, x: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """x [b, n, d_in] -> [b, n, d_out], 'same' padding (odd kernel)."""
    k = p.weight.shape[-1]
    y = F.conv1d(x.transpose(1, 2), p.weight.to(x.dtype), None, padding=(k - 1) // 2,
                 groups=groups)
    y = y.transpose(1, 2)
    if p.bias is not None:
        y = y + p.bias.to(x.dtype)
    return y


def _conv(d_in, d_out, k, groups=1):
    return nn.Conv1d(d_in, d_out, k, padding=k // 2, groups=groups)


# ---------------------------------------------------------------------------
# F5-TTS layers


class GRN(nn.Module):
    """Global Response Norm (reference modules.py:236-245)."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(1, 1, dim))
        self.beta = nn.Parameter(torch.zeros(1, 1, dim))

    def forward(self, x):
        return grn(self, x)


def grn(p: GRN, x):
    # L2 norm over the sequence axis per channel, normalized by the channel mean
    gx = torch.sqrt(x.float().pow(2).sum(dim=1, keepdim=True))
    nx = (gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)).to(x.dtype)
    return p.gamma.to(x.dtype) * (x * nx) + p.beta.to(x.dtype) + x


class ConvNeXtV2Block(nn.Module):
    """dwconv k=7 -> LN -> pw -> GELU -> GRN -> pw, residual (modules.py:252-280)."""

    def __init__(self, dim: int, intermediate_dim: int):
        super().__init__()
        self.dwconv = nn.Conv1d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pwconv1 = nn.Linear(dim, intermediate_dim)
        self.grn = GRN(intermediate_dim)
        self.pwconv2 = nn.Linear(intermediate_dim, dim)

    def forward(self, x):
        return convnext_v2(self, x)


def convnext_v2(p: ConvNeXtV2Block, x):
    residual = x
    x = conv1d(p.dwconv, x, groups=x.shape[-1])
    x = layer_norm(x, p.norm.weight.to(x.dtype), p.norm.bias.to(x.dtype), eps=1e-6)
    x = F.gelu(linear(p.pwconv1, x))
    x = grn(p.grn, x)
    return residual + linear(p.pwconv2, x)


class ConvPositionEmbedding(nn.Module):
    """2x (grouped conv k=31 + Mish) with re-masking (modules.py:175-201)."""

    def __init__(self, dim: int, kernel_size: int = 31, groups: int = 16):
        super().__init__()
        self.groups = groups
        self.conv1d = nn.Sequential(
            _conv(dim, dim, kernel_size, groups), nn.Mish(),
            _conv(dim, dim, kernel_size, groups), nn.Mish(),
        )
        self.taps = None  # the kernel's weight copies, once frozen for serving

    def freeze_taps(self) -> None:
        """Make the kernel's tap-major weight copies once, from the weights as
        they are now (in their dtype and on their device); every later call
        passes them to the kernel instead of copying per call.  For weights
        that no longer change: a serving engine calls it after its cast.  A
        width that ``conv_pos_embed`` sends to the plain composition on the
        card needs no copies, and gets none."""
        c1, c2 = self.conv1d[0], self.conv1d[2]
        if not conv_pos_takes_kernel(c1.weight.device.type, c1.weight.shape[0], self.groups):
            self.taps = None
            return
        self.taps = tuple(kernel_taps(c.weight, self.groups, c.weight.dtype) for c in (c1, c2))

    def forward(self, x, mask=None):
        return conv_pos_embed(self, x, mask)


def conv_pos_takes_kernel(device_type: str, d: int, groups: int) -> bool:
    """Whether ``conv_pos_embed`` runs ``conv_pos_fused`` (kernel B on the
    card, its plain version behind the same op on the CPU) or the plain
    composition: JAX's gate (:276-290, ``conv_pos_supported``) on the device
    type and the static width alone.  On the card only a width in
    64-channel groups takes the kernel; the CPU keeps ``conv_pos_fused``."""
    return device_type != "cuda" or fused_convpos.kernel_takes(d, groups)


def conv_pos_embed(p: ConvPositionEmbedding, x, mask=None):
    """Runs ``ops/fused_convpos.py``: kernel B for CUDA tensors of a width
    it takes, the plain composition for other widths on the card (the
    768-dim Small configurations, as JAX runs XLA's convs there)."""
    b, n, d = x.shape
    if mask is None:
        lens = torch.full((b,), n, dtype=torch.int32, device=x.device)
    else:
        lens = mask.sum(dim=-1, dtype=torch.int32)
    c1, c2 = p.conv1d[0], p.conv1d[2]
    if not conv_pos_takes_kernel(x.device.type, d, p.groups):
        return conv_pos_plain(x, c1.weight, c1.bias, c2.weight, c2.bias, lens, p.groups)
    return conv_pos_fused(x, c1.weight, c1.bias, c2.weight, c2.bias, lens, groups=p.groups,
                          taps=p.taps)


# JAX ``conv_pos_embed_taps`` (:238-250): the per-tap form that JAX switches
# on over a data mesh.  Kernel B already reads the weights tap by tap, and its
# plain version is the CPU's, so the port has one function for both.
conv_pos_embed_taps = conv_pos_embed


def sinus_pos_embed(x: torch.Tensor, dim: int, scale: float = 1000.0) -> torch.Tensor:
    """SinusPositionEmbedding (modules.py:157-169): [b] -> [b, dim], cat(sin, cos)."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=x.device)
                      * -(math.log(10000.0) / (half - 1)))
    ang = scale * x.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class TimestepEmbedding(nn.Module):
    """Sinusoidal timestep features -> MLP (modules.py:852-862)."""

    def __init__(self, dim: int, freq_embed_dim: int = 256):
        super().__init__()
        self.freq_embed_dim = freq_embed_dim
        self.time_mlp = nn.Sequential(nn.Linear(freq_embed_dim, dim), nn.SiLU(), nn.Linear(dim, dim))

    def forward(self, t, dtype=torch.float32):
        return timestep_embed(self, t, dtype)


def timestep_embed(p: TimestepEmbedding, t: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    h = sinus_pos_embed(t, p.freq_embed_dim).to(dtype)
    h = F.silu(linear(p.time_mlp[0], h))
    return linear(p.time_mlp[2], h)


class AdaLayerNorm(nn.Module):
    """SiLU -> Linear(dim, 6 dim), zero-initialized in DiT blocks (modules.py:312-326)."""

    def __init__(self, dim: int):
        super().__init__()
        self.linear = nn.Linear(dim, dim * 6)


def adaln(p: AdaLayerNorm, x, emb):
    """Returns (modulated x, gate_msa, shift_mlp, scale_mlp, gate_mlp)."""
    e = linear(p.linear, F.silu(emb))
    shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = e.chunk(6, dim=-1)
    x = layer_norm(x, eps=1e-6) * (1 + scale_msa[:, None]) + shift_msa[:, None]
    return x, gate_msa, shift_mlp, scale_mlp, gate_mlp


class AdaLayerNormFinal(nn.Module):
    """AdaLayerNorm_Final (modules.py:333-347): SiLU -> Linear(dim, 2 dim)."""

    def __init__(self, dim: int):
        super().__init__()
        self.linear = nn.Linear(dim, dim * 2)


def adaln_final(p: AdaLayerNormFinal, x, emb):
    scale, shift = linear(p.linear, F.silu(emb)).chunk(2, dim=-1)
    return layer_norm(x, eps=1e-6) * (1 + scale[:, None]) + shift[:, None]


def adaln_final_from_mod(mod, x):
    """adaln_final from a precomputed modulation [2 dim] (one shared timestep)
    or [rows, 2 dim]."""
    m = mod if mod.ndim == 2 else mod[None]
    scale, shift = m.chunk(2, dim=-1)
    return layer_norm(x, eps=1e-6) * (1 + scale[:, None]) + shift[:, None]


class FeedForward(nn.Module):
    """Linear -> GELU(tanh) -> Linear (modules.py:353-364)."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        inner = int(dim * mult)
        self.ff = nn.Sequential(
            nn.Sequential(nn.Linear(dim, inner), nn.GELU(approximate="tanh")),
            nn.Dropout(0.0),
            nn.Linear(inner, dim),
        )

    def forward(self, x):
        return feedforward(self, x)


def feedforward(p: FeedForward, x):
    """Under tensor parallelism (``p.tp``) this rank's ``inner / tp``
    columns: ``ff.0.0`` column-, ``ff.2`` row-parallel."""
    tp = tp_of(p)
    if tp is not None:
        x = tp.copy_in(x)
    return row_linear(p.ff[2], F.gelu(linear(p.ff[0][0], x), approximate="tanh"), tp)


class Attention(nn.Module):
    """Self-attention projections (modules.py:371-427)."""

    def __init__(self, dim: int, heads: int, dim_head: int, qk_norm: str | None = None):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.to_q = nn.Linear(dim, inner)
        self.to_k = nn.Linear(dim, inner)
        self.to_v = nn.Linear(dim, inner)
        self.to_out = nn.ModuleList([nn.Linear(inner, dim), nn.Dropout(0.0)])
        if qk_norm == "rms_norm":
            self.q_norm = RMSNorm(dim_head)
            self.k_norm = RMSNorm(dim_head)
        elif qk_norm is not None:
            raise ValueError(f"unknown qk_norm {qk_norm!r}")
        # fused projection, set by fuse_qkv(), and its W8A8 form, set by
        # ops.quant.quantize_dit_blocks; not part of the state dict
        self.register_buffer("qkv_weight", None, persistent=False)
        self.register_buffer("qkv_bias", None, persistent=False)
        self.register_buffer("qkv_weight_q", None, persistent=False)
        self.register_buffer("qkv_w_scale", None, persistent=False)

    def fuse_qkv(self) -> None:
        """Serving transform (JAX ``layers.fuse_qkv``): one [3 inner, dim]
        projection instead of three.  Held as non-persistent buffers, so the
        state dict keeps the reference's separate names; call again after
        loading new weights (it drops a W8A8 form of the old ones)."""
        w = torch.cat([self.to_q.weight, self.to_k.weight, self.to_v.weight], dim=0)
        b = torch.cat([self.to_q.bias, self.to_k.bias, self.to_v.bias], dim=0)
        self.qkv_weight = w.detach().clone()
        self.qkv_bias = b.detach().clone()
        self.qkv_weight_q = self.qkv_w_scale = None


def mha(p: Attention, x, heads: int, mask=None, rope_freqs=None, pe_attn_head: int | None = None,
        backend: str = "auto", rope_cos_sin=None):
    """Self-attention with rotary embedding (AttnProcessor, modules.py:451-556):
    rotary on the first ``pe_attn_head`` heads when set; padding keys masked
    and the output re-masked.  ``heads`` is the model's; under tensor
    parallelism (``p.tp``) this rank runs its ``heads / tp`` of them, the
    rotary on those among the first ``pe_attn_head`` global heads, and the
    re-mask comes after the all-reduce and the single bias.  The fused
    projection's output goes to ``ops.rope.rope_qkv`` (one kernel on the
    card) where nothing but the rotary lies between it and kernel A: no
    tensor parallelism, no qk-norm, ``rope_cos_sin`` given (the rows of
    ``ops.rope.cos_sin_tables`` that ``rope_freqs`` holds, as the backbones
    pass them) and ``rope_qkv_takes``."""
    b, n, _ = x.shape
    tp = tp_of(p)
    if tp is not None:
        heads = tp.local_heads(heads)
        x = tp.copy_in(x)
    qkv = None
    if p.qkv_weight_q is not None:
        qkv = linear_w8a8(x, p.qkv_weight_q, p.qkv_w_scale, p.qkv_bias)
    elif p.qkv_weight is not None:
        qkv = F.linear(x, p.qkv_weight, p.qkv_bias)
    pn = heads if pe_attn_head is None else min(rotary_heads(pe_attn_head, tp, heads), heads)
    if (qkv is not None and tp is None and not hasattr(p, "q_norm") and rope_cos_sin is not None
            and rope_qkv_takes(qkv, heads, backend)):
        q, k, v = rope_qkv(qkv, *rope_cos_sin, heads, pn)  # contiguous [b, h, n, d]
    else:
        if qkv is not None:
            q, k, v = qkv.chunk(3, dim=-1)
        else:
            q, k, v = linear(p.to_q, x), linear(p.to_k, x), linear(p.to_v, x)
        q, k, v = (head_major(t, heads) for t in (q, k, v))  # [b, h, n, d]
        if hasattr(p, "q_norm"):
            q = rms_norm(p.q_norm, q)
            k = rms_norm(p.k_norm, k)
        if rope_freqs is not None:
            q, k = rotate_heads(q, k, torch.cos(rope_freqs).to(q.dtype),
                                torch.sin(rope_freqs).to(q.dtype), pn)
    o = attention(q, k, v, mask=mask, backend=backend)
    o = o.transpose(1, 2).reshape(b, n, -1)
    o = row_linear(p.to_out[0], o, tp)
    if mask is not None:
        o = o * mask[..., None].to(o.dtype)
    return o


class DiTBlock(nn.Module):
    """AdaLN-zero attention + gated FF (modules.py:711-757)."""

    def __init__(self, dim: int, heads: int, dim_head: int, ff_mult: int = 4, qk_norm=None):
        super().__init__()
        self.attn_norm = AdaLayerNorm(dim)
        self.attn = Attention(dim, heads, dim_head, qk_norm=qk_norm)
        self.ff = FeedForward(dim, mult=ff_mult)


def dit_block(p: DiTBlock, x, t_emb, heads: int, mask=None, rope_freqs=None, pe_attn_head=None,
              backend="auto", mod=None, rope_cos_sin=None):
    """``mod``: optional precomputed AdaLN modulation [6 dim] (or [rows, 6 dim])
    that replaces the block's adaln matmul."""
    if mod is not None:
        e = mod if mod.ndim == 2 else mod[None]
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = e.chunk(6, dim=-1)
        norm = layer_norm(x, eps=1e-6) * (1 + scale_msa[:, None]) + shift_msa[:, None]
    else:
        norm, gate_msa, shift_mlp, scale_mlp, gate_mlp = adaln(p.attn_norm, x, t_emb)
    attn_out = mha(p.attn, norm, heads, mask=mask, rope_freqs=rope_freqs,
                   pe_attn_head=pe_attn_head, backend=backend, rope_cos_sin=rope_cos_sin)
    x = x + gate_msa[:, None] * attn_out
    norm = layer_norm(x, eps=1e-6) * (1 + scale_mlp[:, None]) + shift_mlp[:, None]
    return x + gate_mlp[:, None] * feedforward(p.ff, norm)
