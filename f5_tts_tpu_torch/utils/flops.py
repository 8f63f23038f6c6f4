"""Analytic model-FLOP accounting: the one MFU basis of every port benchmark.

JAX counterpart: ``f5_tts_tpu/utils/flops.py`` (the same functions and the
same arithmetic; only the peaks differ).

Stated basis (used by ``runtime/benchmark.py``, ``scripts/bench_train.py``
and ``chip_smoke.py``):

- a matmul / linear / conv contracting k elements into an m x n output counts
  ``2*m*n*k`` FLOPs (one multiply + one add per MAC);
- attention counts the QK^T and PV batched matmuls explicitly:
  ``2 * 2 * n_q * n_kv * heads * dim_head`` per layer (softmax / norms /
  elementwise are NOT counted — they are noise at these shapes);
- a training step counts forward + backward as ``3x`` forward FLOPs
  (the standard MFU convention; rematerialization recompute is NOT counted
  because MFU measures useful math, not executed math);
- classifier-free-guidance inference evaluates the backbone on 2 fused rows
  per sample per NFE step and IS counted as executed (2x fwd per step),
  because both evaluations are required by the algorithm, unlike remat;
- conversely, work the fused sampler hoists OUT of the NFE loop (the
  text-embedding ConvNeXt stack — computed once per call, not per step) is
  counted once, so inference MFU reflects FLOPs actually executed.

The BigVGAN vocoder is not counted (``sampling_flops`` adds nothing for it,
as in JAX): an MFU of a BigVGAN request undercounts its work.

Peaks: one NVIDIA H100 SXM, dense tensor-core math (no sparsity): bf16
989 TFLOP/s, int8 1,979 TOP/s, TF32 495 TFLOP/s, and fp32 outside the
tensor cores 67 TFLOP/s.  ``mfu`` divides by the bf16 peak unless told
otherwise.
"""

from __future__ import annotations

H100_BF16_PEAK_FLOPS = 989e12
H100_INT8_PEAK_OPS = 1979e12
H100_TF32_PEAK_FLOPS = 495e12
H100_FP32_PEAK_FLOPS = 67e12


def dit_text_embed_flops(cfg, n: int) -> float:
    """The text-embedding ConvNeXt stack at seq len ``n`` — depends only on
    the text, so the sampler hoists it OUT of the NFE loop
    (``models/cfm.py`` computes te_cond / te_uncond once before the loop)."""
    td = cfg.text_dim
    fl = 0.0
    for _ in range(cfg.conv_layers):
        fl += n * (7 * td + 2 * 2 * td * td * cfg.conv_mult)
    return fl


def dit_forward_flops(cfg, n: int) -> float:
    """One DiT forward pass at mel seq len ``n`` (text padded to n frames)."""
    d, td = cfg.dim, cfg.text_dim
    fl = dit_text_embed_flops(cfg, n)
    # input embed proj + conv position embedding (k=31, groups=16, twice)
    fl += n * 2 * (2 * cfg.mel_dim + td) * d
    fl += 2 * n * (31 * d / 16 * d) * 2
    inner = cfg.heads * cfg.dim_head
    for _ in range(cfg.depth):
        fl += n * 2 * d * inner * 4  # qkv + out proj
        fl += 2 * 2 * n * n * inner  # QK^T and PV
        fl += n * 2 * d * (d * cfg.ff_mult) * 2  # ff in + out
        fl += 2 * d * 6 * d  # adaln table (per sample, not per token)
    fl += n * 2 * d * cfg.mel_dim
    return fl


def unett_forward_flops(cfg, n: int) -> float:
    """One UNetT forward pass at mel seq len ``n`` (time token appended)."""
    d = cfg.dim
    td = cfg.text_dim or cfg.mel_dim
    fl = n * 2 * (2 * cfg.mel_dim + td) * d
    inner = cfg.heads * cfg.dim_head
    m = n + 1
    for i in range(cfg.depth):
        if i >= cfg.depth // 2 and cfg.skip_connect_type == "concat":
            fl += m * 2 * (2 * d) * d
        fl += m * 2 * d * inner * 4
        fl += 2 * 2 * m * m * inner
        fl += m * 2 * d * (d * cfg.ff_mult) * 2
    fl += n * 2 * d * cfg.mel_dim
    return fl


def mmdit_forward_flops(cfg, n: int, nt: int) -> float:
    """One MMDiT forward at mel len ``n`` / text len ``nt`` (joint attention
    over n+nt; the final block has no text-stream FF/out)."""
    d = cfg.dim
    inner = cfg.heads * cfg.dim_head
    fl = n * 2 * (2 * cfg.mel_dim) * d  # audio embed proj
    fl += 2 * n * (31 * d / 16 * d) * 2  # conv position embedding
    m = n + nt
    for i in range(cfg.depth):
        last = i == cfg.depth - 1
        fl += n * 2 * d * inner * 4  # audio-stream qkv + out
        fl += nt * 2 * d * inner * (3 if last else 4)  # text qkv (+out unless last)
        fl += 2 * 2 * m * m * inner  # joint QK^T and PV
        fl += n * 2 * d * (d * cfg.ff_mult) * 2
        if not last:
            fl += nt * 2 * d * (d * cfg.ff_mult) * 2
        fl += 2 * d * 6 * d
    fl += n * 2 * d * cfg.mel_dim
    return fl


def backbone_forward_flops(arch, n: int, nt: int | None = None) -> float:
    kind = getattr(arch, "backbone", "DiT")
    if kind == "DiT":
        return dit_forward_flops(arch, n)
    if kind == "UNetT":
        return unett_forward_flops(arch, n)
    if kind == "MMDiT":
        return mmdit_forward_flops(arch, n, nt if nt is not None else n // 4)
    raise ValueError(f"unknown backbone {kind}")


def vocos_forward_flops(n: int, dim: int = 512, intermediate_dim: int = 1536,
                        num_layers: int = 8, n_fft: int = 1024,
                        input_channels: int = 100) -> float:
    """Vocos decode at ``n`` frames: embed conv k7 -> ConvNeXt stack ->
    (n_fft+2) head -> ISTFT counted as a matmul."""
    fl = n * 2 * 7 * input_channels * dim
    for _ in range(num_layers):
        fl += n * 2 * 7 * dim  # depthwise k7
        fl += n * 2 * dim * intermediate_dim * 2  # pw1 + pw2
    fl += n * 2 * dim * (n_fft + 2)  # head
    fl += n * 2 * (n_fft + 2) * n_fft  # ISTFT as matmul + overlap-add
    return fl


def sampling_flops(model_cfg, nfe: int, n_frames: int, batch: int = 1,
                   cfg_fused: bool = True, vocoder: str = "vocos") -> float:
    """Total executed model FLOPs for one engine call: NFE Euler loop with
    fused-CFG (2 backbone rows per sample per step) + vocoder decode (Vocos
    only; BigVGAN counts nothing)."""
    rows = 2 if cfg_fused else 1
    fl = nfe * rows * batch * backbone_forward_flops(model_cfg.arch, n_frames)
    if getattr(model_cfg.arch, "backbone", "DiT") == "DiT":
        # the sampler computes the text-embedding ConvNeXt stack ONCE per
        # call (cond + uncond rows), not per NFE step — counting it per step
        # would inflate executed FLOPs (and MFU) by ~3%
        fl -= (nfe - 1) * rows * batch * dit_text_embed_flops(model_cfg.arch, n_frames)
    if vocoder == "vocos":
        fl += batch * vocos_forward_flops(n_frames)
    return fl


def train_step_flops(model_cfg, n_frames: int, batch: int = 1) -> float:
    """fwd + bwd = 3x forward (remat recompute not counted — see module doc)."""
    return 3.0 * batch * backbone_forward_flops(model_cfg.arch, n_frames)


def mfu(achieved_flops_per_s: float, peak: float = H100_BF16_PEAK_FLOPS) -> float:
    """Model FLOPs utilization as a fraction of the card's peak."""
    return achieved_flops_per_s / peak
