"""Plain fp32 reference of the benchmark's models, written from the published
description (SWivid/F5-TTS ``model/modules.py``, ``backbones/dit.py``,
``backbones/unett.py``, ``model/cfm.py``; charactr/vocos; torchaudio's
MelSpectrogram; ``torch.optim.AdamW``'s rule), on state dicts with the
upstream tensor names.  No kernels, caches or batching of rows: each
request runs alone at its bucket length, and a training batch runs in
blocks of rows under per-block activation checkpointing.

``Prec`` picks the arithmetic: fp32 (the reference), or a control one step
below what a configuration states (``quant="fp8"``: every matmul operand
rounded to float8 e4m3 with a per-tensor scale; ``dtype=bfloat16``: all of
it in bf16).  ``Prec.time`` is the dtype the sampler's step times and the
loss's drawn times are rounded to before they enter the model, as the
program rounds them to its compute dtype.  ``reference_mode()`` turns TF32
off.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


@dataclass(frozen=True)
class Prec:
    dtype: torch.dtype = torch.float32
    quant: str | None = None  # None | "fp8"
    # the dtype the step or draw times are rounded to before they enter the
    # model: the program hands the model its times in its compute dtype
    time: torch.dtype = torch.float32


FP32 = Prec()


@contextlib.contextmanager
def reference_mode():
    """TF32 off for matmuls and convolutions while the reference runs."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _q(x, p: Prec):
    """A matmul operand in the control's precision (forward rounded, the
    gradient passed straight through)."""
    if p.quant != "fp8":
        return x
    s = x.detach().abs().amax().clamp(min=1e-12) / 448.0
    r = (x.detach() / s).to(torch.float8_e4m3fn).to(x.dtype) * s
    return x + (r - x).detach()


def linear(W, name, x, p: Prec, bias=True):
    w = W[name + ".weight"].to(p.dtype)
    b = W[name + ".bias"].to(p.dtype) if bias else None
    return F.linear(_q(x, p), _q(w, p), b)


def layer_norm(x, w=None, b=None, eps=1e-6):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


# ------------------------------------------------------------------ shapes

def dit_shapes(a: dict) -> dict:
    d, td, cm = a["dim"], a["text_dim"], a.get("conv_mult", 2)
    inner, ff = a["heads"] * a["dim_head"], d * a["ff_mult"]
    s = {"time_embed.time_mlp.0.weight": (d, 256), "time_embed.time_mlp.0.bias": (d,),
         "time_embed.time_mlp.2.weight": (d, d), "time_embed.time_mlp.2.bias": (d,),
         "text_embed.text_embed.weight": (a["text_num_embeds"] + 1, td),
         "input_embed.proj.weight": (d, 2 * 100 + td), "input_embed.proj.bias": (d,),
         "norm_out.linear.weight": (2 * d, d), "norm_out.linear.bias": (2 * d,),
         "proj_out.weight": (100, d), "proj_out.bias": (100,)}
    for i in range(a["conv_layers"]):
        s.update(_convnext2_shapes(f"text_embed.text_blocks.{i}", td, td * cm))
    s.update(_convpos_shapes("input_embed.conv_pos_embed", d))
    for i in range(a["depth"]):
        pre = f"transformer_blocks.{i}."
        s[pre + "attn_norm.linear.weight"], s[pre + "attn_norm.linear.bias"] = (6 * d, d), (6 * d,)
        s.update(_attn_shapes(pre + "attn", d, inner))
        s.update(_ff_shapes(pre + "ff.ff", d, ff))
    return {"transformer." + k: v for k, v in s.items()}


def unett_shapes(a: dict) -> dict:
    d, td = a["dim"], 100
    inner, ff = a["heads"] * a["dim_head"], d * a["ff_mult"]
    s = {"time_embed.time_mlp.0.weight": (d, 256), "time_embed.time_mlp.0.bias": (d,),
         "time_embed.time_mlp.2.weight": (d, d), "time_embed.time_mlp.2.bias": (d,),
         "text_embed.text_embed.weight": (a["text_num_embeds"] + 1, td),
         "input_embed.proj.weight": (d, 2 * 100 + td), "input_embed.proj.bias": (d,),
         "norm_out.g": (d,), "proj_out.weight": (100, d), "proj_out.bias": (100,)}
    s.update(_convpos_shapes("input_embed.conv_pos_embed", d))
    for i in range(a["depth"]):
        pre = f"layers.{i}."
        if i >= a["depth"] // 2:
            s[pre + "0.weight"] = (d, 2 * d)
        s[pre + "1.g"], s[pre + "3.g"] = (d,), (d,)
        s.update(_attn_shapes(pre + "2", d, inner))
        s.update(_ff_shapes(pre + "4.ff", d, ff))
    return {"transformer." + k: v for k, v in s.items()}


def vocos_shapes(v: dict) -> dict:
    d, m = v["dim"], v["intermediate_dim"]
    s = {"backbone.embed.weight": (d, 100, 7), "backbone.embed.bias": (d,),
         "backbone.norm.weight": (d,), "backbone.norm.bias": (d,),
         "backbone.final_layer_norm.weight": (d,), "backbone.final_layer_norm.bias": (d,),
         "head.out.weight": (v["n_fft"] + 2, d), "head.out.bias": (v["n_fft"] + 2,)}
    for i in range(v["num_layers"]):
        pre = f"backbone.convnext.{i}."
        s.update({pre + "gamma": (d,), pre + "dwconv.weight": (d, 1, 7), pre + "dwconv.bias": (d,),
                  pre + "norm.weight": (d,), pre + "norm.bias": (d,),
                  pre + "pwconv1.weight": (m, d), pre + "pwconv1.bias": (m,),
                  pre + "pwconv2.weight": (d, m), pre + "pwconv2.bias": (d,)})
    return s


def backbone_shapes(cfg: dict) -> dict:
    return (dit_shapes if cfg["backbone"] == "DiT" else unett_shapes)(cfg["arch"])


def _convnext2_shapes(pre, d, m):
    return {pre + ".dwconv.weight": (d, 1, 7), pre + ".dwconv.bias": (d,),
            pre + ".norm.weight": (d,), pre + ".norm.bias": (d,),
            pre + ".pwconv1.weight": (m, d), pre + ".pwconv1.bias": (m,),
            pre + ".grn.gamma": (1, 1, m), pre + ".grn.beta": (1, 1, m),
            pre + ".pwconv2.weight": (d, m), pre + ".pwconv2.bias": (d,)}


def _convpos_shapes(pre, d):
    return {pre + f".conv1d.{j}.{k}": s for j in (0, 2)
            for k, s in (("weight", (d, d // 16, 31)), ("bias", (d,)))}


def _attn_shapes(pre, d, inner):
    s = {}
    for nm in ("to_q", "to_k", "to_v"):
        s[f"{pre}.{nm}.weight"], s[f"{pre}.{nm}.bias"] = (inner, d), (inner,)
    s[pre + ".to_out.0.weight"], s[pre + ".to_out.0.bias"] = (d, inner), (d,)
    return s


def _ff_shapes(pre, d, ff):
    return {pre + ".0.0.weight": (ff, d), pre + ".0.0.bias": (ff,),
            pre + ".2.weight": (d, ff), pre + ".2.bias": (d,)}


# ------------------------------------------------------------------ layers

def sinus(t, dim=256, scale=1000.0):
    half = dim // 2
    f = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                  * -(math.log(10000.0) / (half - 1)))
    a = scale * t.float()[:, None] * f[None]
    return torch.cat([a.sin(), a.cos()], dim=-1)


def time_embed(W, t, p):
    h = sinus(t.to(p.time).float()).to(p.dtype)
    h = F.silu(linear(W, "transformer.time_embed.time_mlp.0", h, p))
    return linear(W, "transformer.time_embed.time_mlp.2", h, p)


def conv1d(x, w, b, groups=1):
    """x [B, n, c] -> [B, n, c'], zero 'same' padding."""
    y = F.conv1d(x.transpose(1, 2), w.to(x.dtype), b.to(x.dtype), padding=w.shape[-1] // 2,
                 groups=groups)
    return y.transpose(1, 2)


def convnext_v2(W, pre, x, p):
    r = x
    x = conv1d(x, W[pre + ".dwconv.weight"], W[pre + ".dwconv.bias"], groups=x.shape[-1])
    x = layer_norm(x, W[pre + ".norm.weight"].to(p.dtype), W[pre + ".norm.bias"].to(p.dtype))
    x = F.gelu(linear(W, pre + ".pwconv1", x, p))
    gx = torch.sqrt((x * x).sum(dim=1, keepdim=True))
    nx = gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)
    x = W[pre + ".grn.gamma"].to(p.dtype) * (x * nx) + W[pre + ".grn.beta"].to(p.dtype) + x
    return r + linear(W, pre + ".pwconv2", x, p)


def conv_pos(W, x, keep, p):
    """Two (grouped conv k31, Mish) with the frames past the valid length
    zeroed before, between and after (``keep`` [B, n, 1] or None)."""
    pre = "transformer.input_embed.conv_pos_embed.conv1d."
    for j in (0, 2):
        if keep is not None:
            x = x * keep
        x = F.mish(conv1d(x, W[pre + f"{j}.weight"], W[pre + f"{j}.bias"], groups=16))
    return x if keep is None else x * keep


def rope_table(n, dh, device):
    inv = 1.0 / (10000.0 ** (torch.arange(0, dh, 2, dtype=torch.float64) / dh))
    ang = torch.outer(torch.arange(n, dtype=torch.float64), inv)
    ang = ang.repeat_interleave(2, dim=-1)  # interleaved pairs (x_transformers)
    return ang.cos().float().to(device), ang.sin().float().to(device)


def rotate(x, cos, sin):
    x2 = x.reshape(*x.shape[:-1], -1, 2)
    rot = torch.stack((-x2[..., 1], x2[..., 0]), dim=-1).reshape(x.shape)
    return x * cos.to(x.dtype) + rot * sin.to(x.dtype)


def attention(W, pre, x, heads, mask, rope, pe_heads, p):
    B, n, _ = x.shape
    q, k, v = (linear(W, f"{pre}.{nm}", x, p).reshape(B, n, heads, -1).transpose(1, 2)
               for nm in ("to_q", "to_k", "to_v"))
    cos, sin = rope
    ph = heads if pe_heads is None else pe_heads
    q = torch.cat([rotate(q[:, :ph], cos, sin), q[:, ph:]], dim=1)
    k = torch.cat([rotate(k[:, :ph], cos, sin), k[:, ph:]], dim=1)
    s = _q(q, p) @ _q(k, p).transpose(-1, -2) * q.shape[-1] ** -0.5
    s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
    o = (_q(s.softmax(dim=-1), p) @ _q(v, p)).transpose(1, 2).reshape(B, n, -1)
    return linear(W, pre + ".to_out.0", o, p) * mask[..., None].to(o.dtype)


def feed_forward(W, pre, x, p):
    return linear(W, pre + ".2", F.gelu(linear(W, pre + ".0.0", x, p), approximate="tanh"), p)


def text_embed(W, cfg, ids, n, valid_len, drop, p):
    """[B, n, text_dim]: ids (-1 padded) + 1, the filler 0 past the text;
    DiT zeroes the positions past ``valid_len`` [B], UNetT keeps them."""
    a, B = cfg["arch"], ids.shape[0]
    ids = ids.long() + 1
    ids = ids[:, :n] if ids.shape[1] >= n else F.pad(ids, (0, n - ids.shape[1]))
    dit = cfg["backbone"] == "DiT"
    valid = None
    if dit and valid_len is not None:
        valid = torch.arange(n, device=ids.device)[None] < valid_len[:, None]
        ids = ids * valid
    pad = ids == 0
    if drop:
        ids = torch.zeros_like(ids)
    e = W["transformer.text_embed.text_embed.weight"].to(p.dtype)[ids]
    if valid is not None:
        e = e * valid[..., None]
    if a.get("conv_layers", 0) > 0:
        td = e.shape[-1]
        inv = 1.0 / (10000.0 ** (torch.arange(0, td, 2, dtype=torch.float64)[: td // 2] / td))
        ang = torch.outer(torch.arange(n, dtype=torch.float64), inv)
        pos = torch.cat([ang.cos(), ang.sin()], dim=-1).to(e)
        e = e + pos[None] * (valid[..., None] if valid is not None else 1)
        keep = (~pad)[..., None].to(e.dtype) if a["text_mask_padding"] else None
        if keep is not None:
            e = e * keep
        for i in range(a["conv_layers"]):
            e = convnext_v2(W, f"transformer.text_embed.text_blocks.{i}", e, p)
            if keep is not None:
                e = e * keep
    return e


def _ckpt(fn, train, *args):
    return checkpoint(fn, *args, use_reentrant=False) if train else fn(*args)


def dit_forward(W, a, x, cond, te, t, mask, p, train=False):
    B, n, _ = x.shape
    d = a["dim"]
    temb = time_embed(W, t, p)
    h = linear(W, "transformer.input_embed.proj", torch.cat([x, cond, te], dim=-1), p)
    h = conv_pos(W, h, mask[..., None].to(h.dtype), p) + h
    rope = rope_table(n, a["dim_head"], x.device)

    def block(h, temb, i):
        pre = f"transformer.transformer_blocks.{i}."
        e = linear(W, pre + "attn_norm.linear", F.silu(temb), p)
        sh_a, sc_a, g_a, sh_f, sc_f, g_f = e[:, None].chunk(6, dim=-1)
        nrm = layer_norm(h) * (1 + sc_a) + sh_a
        h = h + g_a * attention(W, pre + "attn", nrm, a["heads"], mask, rope, a["pe_attn_head"], p)
        nrm = layer_norm(h) * (1 + sc_f) + sh_f
        return h + g_f * feed_forward(W, pre + "ff.ff", nrm, p)

    for i in range(a["depth"]):
        h = _ckpt(block, train, h, temb, i)
    sc, sh = linear(W, "transformer.norm_out.linear", F.silu(temb), p)[:, None].chunk(2, dim=-1)
    h = layer_norm(h) * (1 + sc) + sh
    return linear(W, "transformer.proj_out", h, p)


def rms_xt(x, g):
    return x / x.norm(dim=-1, keepdim=True).clamp(min=1e-12) * x.shape[-1] ** 0.5 * g.to(x.dtype)


def unett_forward(W, a, x, cond, te, t, mask, p, train=False):
    B, n, _ = x.shape
    temb = time_embed(W, t, p)
    h = linear(W, "transformer.input_embed.proj", torch.cat([x, cond, te], dim=-1), p)
    h = conv_pos(W, h, None, p) + h  # no audio mask in UNetT
    h = torch.cat([temb[:, None], h], dim=1)
    m = F.pad(mask, (1, 0), value=True)
    rope = rope_table(n + 1, a["dim_head"], x.device)

    def block(h, skip, i):
        pre = f"transformer.layers.{i}."
        if skip is not None:
            h = F.linear(_q(torch.cat([h, skip], dim=-1), p), _q(W[pre + "0.weight"].to(p.dtype), p))
        h = attention(W, pre + "2", rms_xt(h, W[pre + "1.g"]), a["heads"], m, rope,
                      a["pe_attn_head"], p) + h
        return feed_forward(W, pre + "4.ff", rms_xt(h, W[pre + "3.g"]), p) + h

    skips, half = [], a["depth"] // 2
    for i in range(a["depth"]):
        if i < half:
            skips.append(h)
            h = _ckpt(block, train, h, None, i)
        else:
            h = _ckpt(block, train, h, skips.pop(), i)
    h = rms_xt(h, W["transformer.norm_out.g"])[:, 1:]
    return linear(W, "transformer.proj_out", h, p)


def backbone(cfg):
    return dit_forward if cfg["backbone"] == "DiT" else unett_forward


# ------------------------------------------------------------------ mel, vocos

def mel_fbank(sr=24_000, n_fft=1024, n_mels=100):
    """torchaudio ``melscale_fbanks`` (htk scale, no norm): [n_freq, n_mels]."""
    freqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)

    def h2m(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    m = np.linspace(h2m(0.0), h2m(sr / 2.0), n_mels + 2)
    f = 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    slopes = f[None, :] - freqs[:, None]
    down = -slopes[:, :-2] / np.diff(f)[:-1]
    up = slopes[:, 2:] / np.diff(f)[1:]
    return torch.from_numpy(np.maximum(0.0, np.minimum(down, up)))


def log_mel(wav: torch.Tensor) -> torch.Tensor:
    """torchaudio MelSpectrogram(24 kHz, n_fft 1024, hop 256, 100 mels,
    power 1, center, reflect) then clamp(1e-5).log(): [B, L] -> [B, frames, 100]."""
    win = torch.hann_window(1024, dtype=torch.float64, device=wav.device)
    spec = torch.stft(wav.double(), 1024, 256, 1024, window=win, center=True,
                      pad_mode="reflect", return_complex=True).abs()
    mel = mel_fbank().to(wav.device).T @ spec
    return mel.clamp(min=1e-5).log().transpose(1, 2).float()


def vocos(V, mel, p=FP32):
    """[B, m, 100] log-mel -> [B, (m - 1) * 256] waveform (``dtype`` of p)."""
    x = conv1d(mel.to(p.dtype), V["backbone.embed.weight"], V["backbone.embed.bias"])
    x = layer_norm(x, V["backbone.norm.weight"].to(p.dtype), V["backbone.norm.bias"].to(p.dtype))
    i = 0
    while f"backbone.convnext.{i}.gamma" in V:
        pre = f"backbone.convnext.{i}."
        r = x
        x = conv1d(x, V[pre + "dwconv.weight"], V[pre + "dwconv.bias"], groups=x.shape[-1])
        x = layer_norm(x, V[pre + "norm.weight"].to(p.dtype), V[pre + "norm.bias"].to(p.dtype))
        x = linear(V, pre + "pwconv2", F.gelu(linear(V, pre + "pwconv1", x, p)), p)
        x = r + V[pre + "gamma"].to(p.dtype) * x
        i += 1
    x = layer_norm(x, V["backbone.final_layer_norm.weight"].to(p.dtype),
                   V["backbone.final_layer_norm.bias"].to(p.dtype))
    x = linear(V, "head.out", x, p).float()
    nf = x.shape[-1] // 2
    mag = torch.exp(x[..., :nf]).clamp(max=1e2)
    spec = torch.polar(mag, x[..., nf:]).transpose(1, 2)
    win = torch.hann_window(1024, device=mel.device)
    return torch.istft(spec, 1024, 256, 1024, window=win, center=True)


# ------------------------------------------------------------------ sampler

EPSS = {5: [0, 2, 4, 8, 16, 32], 6: [0, 2, 4, 6, 8, 16, 32], 7: [0, 2, 4, 6, 8, 16, 24, 32],
        10: [0, 2, 4, 6, 8, 12, 16, 20, 24, 28, 32],
        12: [0, 2, 4, 6, 8, 10, 12, 14, 16, 20, 24, 28, 32],
        16: [0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 14, 16, 20, 24, 28, 32]}


def schedule(nfe: int, sway: float | None) -> np.ndarray:
    """Step times [nfe + 1]: the Empirically Pruned Step Sampling table where
    one exists (upstream ``model/utils.py``), else uniform; then sway."""
    t = np.asarray(EPSS[nfe], np.float64) / 32 if nfe in EPSS else np.linspace(0, 1, nfe + 1)
    if sway is not None:
        t = t + sway * (np.cos(np.pi / 2 * t) - 1 + t)
    return t


@torch.no_grad()
def sample(W, cfg, ref_mel, ids, duration, n, noise, nfe, cfg_strength, sway, p=FP32):
    """One request: ref_mel [lens, 100], ids [nt], the asked total frames,
    the bucket n, noise [n, 100] -> mel [n, 100] (fp32): the reference
    region kept, frames past the duration zero."""
    a, dev = cfg["arch"], noise.device
    lens = ref_mel.shape[0]
    dur = min(max(max(int(ids.shape[0]), lens) + 1, int(duration)), n)
    pos = torch.arange(n, device=dev)
    mask, cmask = (pos < dur)[None], (pos < lens)[None]
    cond = torch.zeros(1, n, 100, device=dev)
    cond[0, :lens] = ref_mel
    ids = ids[None].to(dev)
    dl = torch.tensor([dur], device=dev)
    te = torch.cat([text_embed(W, cfg, ids, n, dl, False, p), text_embed(W, cfg, ids, n, dl, True, p)])
    cond2 = torch.cat([cond, torch.zeros_like(cond)]).to(p.dtype)
    x = (noise[None] * mask[..., None]).to(p.dtype)
    fwd = backbone(cfg)
    ts = schedule(nfe, sway)
    for k in range(nfe):
        t = torch.full((2,), float(ts[k]), device=dev)
        out = fwd(W, a, torch.cat([x, x]), cond2, te.to(p.dtype), t, mask.expand(2, -1), p)
        v = out[:1] + (out[:1] - out[1:]) * cfg_strength
        x = x + float(ts[k + 1] - ts[k]) * v
    out = torch.where(cmask[..., None], cond, x.float())
    return (out * mask[..., None])[0]


# ------------------------------------------------------------------ training

def loss_draws(b, n, lens, seed, device):
    """The loss's random draws for a micro-step seeded ``seed``, in the
    program's order and generators (the benchmark hands both sides the same
    seed): span fraction and start, x0, time on the device; the two CFG drops
    on the CPU."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    frac = torch.rand((b,), generator=gen, device=device) * 0.3 + 0.7
    span = (frac * lens).to(torch.int32)
    start = ((lens - span) * torch.rand((b,), generator=gen, device=device)).to(torch.int32)
    start = start.clamp(min=0)
    x0 = torch.randn((b, n, 100), generator=gen, device=device)
    t = torch.rand((b,), generator=gen, device=device)
    cpu = torch.Generator().manual_seed(int(seed))
    drop_audio = bool(torch.rand((), generator=cpu) < 0.3)
    drop_both = bool(torch.rand((), generator=cpu) < 0.2)
    pos = torch.arange(n, device=device)[None]
    spanm = (pos >= start[:, None]) & (pos < (start + span)[:, None]) & (pos < lens[:, None])
    return dict(x0=x0, t=t, span=spanm, drop_audio=drop_audio or drop_both, drop_both=drop_both)


def loss_and_grads(W, cfg, mel, ids, lens, draws, p=FP32, rows_per_block=8):
    """The flow-matching loss (masked MSE over the span) and its gradients
    [name -> tensor] for the parameters in ``W`` (leaf tensors), summed over
    blocks of rows."""
    a = cfg["arch"]
    b, n, _ = mel.shape
    count = draws["span"].sum() * 100
    fwd = backbone(cfg)
    names = [k for k in W if W[k].requires_grad]
    grads = {k: torch.zeros_like(W[k]) for k in names}
    total = 0.0
    for s in range(0, b, rows_per_block):
        r = slice(s, min(b, s + rows_per_block))
        x1, x0, span = mel[r], draws["x0"][r], draws["span"][r]
        t = draws["t"][r].to(p.time).float()
        mask = torch.arange(n, device=mel.device)[None] < lens[r][:, None]
        phi = (1 - t[:, None, None]) * x0 + t[:, None, None] * x1
        cond = torch.where(span[..., None], torch.zeros_like(x1), x1)
        if draws["drop_audio"]:
            cond = torch.zeros_like(cond)
        te = text_embed(W, cfg, ids[r], n, lens[r], draws["drop_both"], p)
        pred = fwd(W, a, phi.to(p.dtype), cond.to(p.dtype), te, t, mask, p, train=True)
        part = (((pred.float() - (x1 - x0)) ** 2) * span[..., None]).sum() / count
        gs = torch.autograd.grad(part, [W[k] for k in names], allow_unused=True)
        for k, g in zip(names, gs):
            if g is not None:
                grads[k] += g
        total += float(part.detach())
    return total, grads


class AdamW:
    """clip_by_global_norm(max_norm) then AdamW (decoupled decay), with the
    learning rate linear from 0 over the warm-up, then linear to 0.  The
    schedule starts at update ``start`` (a resumed run); the moments and
    their bias correction start empty."""

    def __init__(self, W, lr, warmup, total, max_norm=1.0, betas=(0.9, 0.999), eps=1e-8,
                 wd=0.01, start=0):
        self.W, self.lr, self.warm, self.total = W, lr, warmup, total
        self.max_norm, self.b1, self.b2, self.eps, self.wd = max_norm, *betas, eps, wd
        self.m = {k: torch.zeros_like(v) for k, v in W.items()}
        self.v = {k: torch.zeros_like(v) for k, v in W.items()}
        self.t, self.count = 0, start

    def rate(self, count):
        if count < self.warm:
            return self.lr * count / self.warm
        return self.lr * (1 - min(count - self.warm, self.total - self.warm)
                          / max(self.total - self.warm, 1))

    @torch.no_grad()
    def step(self, grads):
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).float()
        f = 1.0 if norm < self.max_norm else self.max_norm / float(norm)
        lr = self.rate(self.count)
        self.t, self.count = self.t + 1, self.count + 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, g in grads.items():
            g = g * f
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            w = self.W[k]
            w.mul_(1 - lr * self.wd)
            w.addcdiv_(self.m[k], (self.v[k] / c2).sqrt() + self.eps, value=-lr / c1)
        return float(norm)


@torch.no_grad()
def ema_update(E, W, update, decay, after, every):
    """The EMA rule of ema_pytorch (the upstream trainer's), after optimizer
    update number ``update``: nothing unless it is a multiple of ``every``;
    a copy of the weights up to ``after``; past it E = decay E + (1 - decay) W."""
    if update % every:
        return
    for k, e in E.items():
        if update <= after:
            e.copy_(W[k])
        else:
            e.mul_(decay).add_(W[k].detach(), alpha=1.0 - decay)
