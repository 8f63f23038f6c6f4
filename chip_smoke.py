#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA card.

Run from the repository root:  python3 chip_smoke.py

1. Prints the card's name and power limit, builds every CUDA kernel from
   ``f5_tts_tpu_torch/csrc`` (nvcc, sm_90a, one process per source), and
   each kernel instance's registers, spills and whether ptxas serialised
   its wgmma (it must not, nor spill, for any instance of kernel H).
2. Kernel A (masked flash attention) against its plain version at the
   F5TTS_v1_Base shapes [2, 16, n, 64] bf16, n in {256, 512, 1000, 1024, 4096},
   ragged lens and a row with no valid key, and in every configuration
   built (``flash_attention.FWD_CONFIGS``) at n = 1, 63, 65, 127, 129 and
   256 with lengths of 0 and lengths that end on a tile edge or inside one;
   every launch twice, bitwise equal; times every configuration, the plain
   version and one ``scaled_dot_product_attention`` call (a yardstick the
   port never calls) beside the H100 bound.
3. Kernel B (fused ConvPositionEmbedding) likewise at [2, n, 1024] bf16,
   16 groups (every configuration of ``fused_convpos.CONFIGS`` at the edge
   lengths, its fp32 instance against fp32 with TF32 off); the yardstick is
   the cuDNN grouped-conv composition in bf16.
4. One full-width F5TTS_v1_Base ``forward_cfg`` at n=256 in fp32, on the card
   through the kernels against the CPU through the plain versions.
5. End to end: ``F5TTS(model="F5TTS_v1_Base", init_random=True)`` in bf16,
   after one warm-up request, serves a short request, a long one that is
   chunked into a batch of rows, and a streamed one; checks the wavs, that
   every attention and ConvPositionEmbedding call of the run went through
   the kernels, and that no request copied the ConvPositionEmbedding
   weights into kernel B's layout (the engine does it once).
6. Kernels C, D, E (flash attention forward with logsumexp, dq, dk/dv)
   against their plain versions at [2, 16, n, 64] bf16, n in {256, 1000,
   1024, 4096}, ragged lens and a row with no valid key; checks the zero
   gradients of that row and of the key tiles past lens, and that two
   launches of D and E give bitwise-equal gradients; times kernel, plain
   version, bound and the ``scaled_dot_product_attention`` forward (C) and
   backward (D + E, with the ratio of D + E to it); and again at the
   training shape [37, 16, 1024, 64], where every tile configuration of C,
   D and E built (``FWD_CONFIGS``, ``BWD_CONFIGS``) is timed beside the one
   the wrappers launch.  Kernel C also in every configuration at the edge
   lengths of phase 2, and every launch of C twice, bitwise equal.
7. Full-width gradient check: one F5TTS_v1_Base ``cfm.loss`` + backward in
   fp32 at b=2, n=256 with injected draws, on the card through kernels
   B, C, D, E against the CPU through the plain versions.
8. Training: ``Trainer(F5TTS_v1_Base, device="cuda")`` in mixed precision on
   a seeded synthetic mel dataset at 38,400 frames per update; checks the
   log, the EMA rule, the checkpoints and the launch counts; then ~8
   updates on one fixed batch, whose loss must fall, and a profile of one
   of them (the shares of device time of B, C, D and E, valid frames per
   second).
9. Kernel F (two-segment flash attention, MMDiT's joint-attention mask)
   and kernels C, D, E in the two-segment mode against their plain versions:
   the MMDiT serving shape under CFG [2, 16, 2048, 64] with seg 1024, a
   training-like shape [8, 16, 1280, 64] with ragged segments, an odd
   boundary (n 1077, seg 1000) in bf16 and fp32, seg and both segments'
   ends on tile edges, and rows with an empty text segment or no valid key,
   every kernel launched twice, bitwise equal; times each (F and C in every
   configuration) beside its bound, its plain version, kernel A at the same
   valid-key count, and ``scaled_dot_product_attention`` forward / backward
   with the same boolean key mask.
10. Full-width fp32 forwards, card vs CPU: F5TTS_MMDiT_Base
    ``forward_with_text(attn_mask_enabled=True)`` (22 launches of F, none
    of A) and E2TTS_Base ``forward_cfg`` (24 of A, 1 of B).
11. Full-width F5TTS_MMDiT_Base masked gradient, card vs CPU, fp32, on the
    training kernels (22 launches each of C, D, E in the two-segment mode).
12. End to end: ``F5TTS(model="E2TTS_Base")`` serves a short and a long
    request, ``F5TTS(model="F5TTS_MMDiT_Base")`` a short one (bucket <= 1024);
    the launch counts prove every attention and ConvPositionEmbedding call
    ran a kernel; a profile of the short request (the shares of device time
    of the forward flash kernel and of B).
13. Training: ``Trainer(E2TTS_Base, device="cuda")`` in mixed precision, 3
    updates on seeded synthetic mels at ``E2TTS_TRAIN_FRAMES`` per update;
    peak memory and valid frames per second.
14. Kernel G's two instances against their plain versions, bitwise, in
    bf16 and fp32 x, at the F5TTS_v1_Base serving shapes (m = 1024 with the
    fused qkv, out, ff in and ff out (k, n)), at m = 1 and 4096 and three
    ragged shapes (k % 16 != 0 in two): the TPU kernel's function
    (``int8_matmul``) against ``int8_matmul_plain``, and the serving linear
    (``linear_w8a8``: row quantization, product, cast and bias in one
    launch; also its two-launch form, and its row phase alone against
    ``quantize_rows``) against the plain composition on the card; a row
    holding a NaN gives a NaN scale and output row on both sides.  Where
    PyTorch's division of the scale by a Python scalar rounds differently
    from the true division.  Times both instances beside their bounds,
    ``torch._int_mm`` plus the scale epilogue and the unfused serving
    composition on it (yardsticks), and dense bf16 ``F.linear``, with the
    split of k per shape; both instances at every split of k at qkv and ff
    out (and ff out at k = 3968); the host's time to issue one eager call
    of the serving linear in its one- and two-launch forms and of
    ``F.linear`` at each serving shape.
15. W8A8 serving: a dense and a W8A8 F5TTS_v1_Base engine serve the same
    short request with the same seed; the generated mels must differ, by
    less than ``MEL_MAE_GATE``; G's serving instance launches 4 x depth x
    NFE times per W8A8 engine call and never in the dense one, its
    TPU-function instance never, A and B as often in both, the
    experiments' H and I in neither; device time, kernel count and busy
    share of both.  One W8A8 F5TTS_MMDiT_Base request (G = 4 x (depth - 1)
    x NFE); E2TTS_Base refuses ``quantize=True``.
16. One full-width W8A8 F5TTS_v1_Base ``forward_cfg`` in fp32, card vs CPU,
    with the share of int8 activations that the two quantize differently
    (each quantized linear's input captured on both sides and quantized by
    the plain ``quantize_rows``).
17. Kernels H (warp-specialised pipelined flash attention) and I (fused
    LayerNorm-modulate matmul, K = 1024, 2048 and 4096 and ragged shapes),
    the two experiments, against their plain versions.  Every instance of
    H (``exp_pipelined_flash.CONFIGS``) in six cases (``H_CASES``: ragged n,
    lens of 0, a length across a tile edge, b*h = 128), bitwise in two
    launches and in a CUDA-graph replay; timed at [2, 16, 1024, 64] and
    [2, 16, 4096, 64] beside kernel A, SDPA and the plain version, each with
    its share of the bound.  I timed beside the unfused composition.
18. Prints the kernels' JSON line, then the result line.

Every time of a kernel, its plain version and its library yardstick is
device time per call, from CUDA-graph replays (``utils.device.device_ms``).
Any failed phase exits non-zero without the result line.  Weights are
random, made from fixed seeds.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (dense): bf16 and int8 tensor cores, HBM3
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
HBM_BPS = 3.35e12

REF_WAV = os.path.join(REPO, "examples", "assets", "basic_ref_en.wav")
REF_TEXT = "Some call me nature, others call me mother nature."
NFE = 32
SHORT_TEXT = "I don't really care what you call me."
LONG_TEXT = " ".join([
    "I've been a silent spectator, watching species evolve, empires rise and fall.",
    "But always remember, I am mighty and enduring.",
    "Respect me and I'll nurture you; ignore me and you shall face the consequences.",
    "The rivers carve the valleys, the winds shape the mountains, and the seasons turn.",
    "Every creature that walks, swims or flies is part of the story I keep telling.",
    "When you plant a tree, you speak my language; when you poison a river, I listen.",
    "Take only what you need, give back what you can, and the balance will hold.",
])

# kernel vs plain tolerances (bf16 inputs; both kernels round to bf16 where
# the TPU kernels do: q, k, v and p for attention, the intermediate and the
# output for convpos); the plain versions compute in fp32 on the same values
FLASH_TOL = (2e-2, 2e-3)  # (max abs, mean abs), as tests/test_flash_attention.py
CONVPOS_TOL = (2e-2, 2e-3)
# kernel B's fp32 instance (three bf16 products per tap, the dropped lo.lo
# term ~2^-16 of a product) against the fp32 plain version with TF32 off:
# max error over the largest reference value
CONVPOS_FP32_REL_TOL = 1e-4
# training kernels vs plain: o as FLASH_TOL; L (natural log) max abs, from
# log2-domain scores of bf16-rounded q and k; the gradients, which also
# round do, p and ds to bf16, relative to the largest reference value
LSE_TOL = 1e-2
GRAD_TOL = (2e-2, 4e-3)
# full-width loss + gradient, card vs CPU, fp32 except the attention kernels'
# bf16 operands: relative loss error and relative L2 error of the gradient
FULL_GRAD_REL_TOL = 1e-2
TRAIN_FRAMES = 38_400  # configs/F5TTS_v1_Base.yaml batch_size_per_gpu
TRAIN_B = TRAIN_FRAMES // 1024  # rows of a 1024-frame batch at that budget
E2TTS_TRAIN_FRAMES = 38_400  # configs/E2TTS_Base.yaml batch_size_per_gpu
# kernel G vs its plain version: the int32 sum is exact and the epilogue
# rounds as the plain version does, so only fp32 rounding may differ
INT8_REL_TOL = 1e-6
SERVING_KN = ((1024, 3072), (1024, 1024), (1024, 4096), (4096, 1024))  # qkv, out, ff in, ff out
# W8A8 serving: generated-mel MAE, dense vs W8A8 engine (scripts/quant_ab.py's gate)
MEL_MAE_GATE = 0.10
# full-width W8A8 forward, card vs CPU, fp32: an upstream fp32 difference can
# move an activation across an int8 rounding boundary, one step of its row's
# scale (~1/127 of the row max), which the remaining layers carry
W8A8_FULL_REL_TOL = 1e-2
# kernel I vs its plain version, relative to the largest reference value: the
# kernel rounds the product + bias once to bf16, the plain version (JAX
# xla_ref) rounds the product, then the sum
LN_MATMUL_TOL = (2e-2, 2e-3)
# full-width fp32 forward, card vs CPU: max abs error over the output's peak.
# Kernel B runs fp32 there; kernel A still rounds q, k, v, p to bf16 (2^-9
# relative), which the gated residual stream carries to the output damped
FULL_WIDTH_REL_TOL = 1e-3


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bound_ms(flops: float, nbytes: float, peak: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak, nbytes / HBM_BPS
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def _configs_ms(fn, configs, iters):
    """Device ms of ``fn(config)`` for every configuration, keyed "rows x stages"."""
    from f5_tts_tpu_torch.utils.device import device_ms

    return {f"{c[0]}x{c[1]}": device_ms(lambda: fn(c), iters) for c in configs}


def _print_configs_ms(tag, name, t, chosen):
    print(f"{tag}: {name} every configuration (rows x stages), device ms: "
          + ", ".join(f"{c} {ms:.4f}" for c, ms in t.items())
          + f" (chosen {chosen[0]}x{chosen[1]})", flush=True)


def _check_twice(torch, tag, fn):
    """fn() launched twice on the same inputs must give bitwise-equal results
    (one owner per output tile, no atomics); returns the first."""
    a, b = fn(), fn()
    for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
        if not torch.equal(x, y):
            fail(f"{tag}: two launches gave different results")
    return a


def phase_flash(torch):
    """Kernel A against its plain version (every configuration built at the
    edge lengths), bitwise determinism, and device times."""
    from f5_tts_tpu_torch.ops import flash_attention as FA
    from f5_tts_tpu_torch.utils.device import device_ms

    gen = torch.Generator(device="cuda").manual_seed(0)
    b, h, dh = 2, 16, 64
    rows, worst = [], 0.0
    # edge lengths: n around the 64-row tiles, lengths of 0, lengths that end
    # on a tile edge beside ones that end inside a tile
    edge = [(1, [1, 0]), (63, [63, 17]), (65, [65, 64]), (127, [127, 0]), (129, [129, 128]),
            (256, [256, 128]), (256, [192, 0])]
    for n, lens_l in edge:
        q, k, v = (torch.randn((b, h, n, dh), generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
        want = FA.flash_attention_plain(q.float(), k.float(), v.float(), lens)
        errs = []
        for cfg in FA.FWD_CONFIGS:
            got = _check_twice(torch, f"flash n={n} lens={lens_l} {cfg}",
                               lambda: FA.flash_attention_cuda(q, k, v, lens, config=cfg))
            torch.cuda.synchronize()
            err = (got.float() - want).abs()
            max_err, mean_err = err.max().item(), err.mean().item()
            if not (max_err <= FLASH_TOL[0] and mean_err <= FLASH_TOL[1]):
                fail(f"flash n={n} lens={lens_l} {cfg}: max {max_err} mean {mean_err}")
            for i, ln in enumerate(lens_l):
                if ln == 0 and got[i].abs().max().item() != 0.0:
                    fail("flash: a row with no valid key must give 0")
            worst = max(worst, max_err)
            errs.append(max_err)
        print(f"flash_attention n={n} lens={lens_l}: every configuration within {FLASH_TOL}, "
              f"two launches bitwise equal; max_abs_err {max(errs):.3e}", flush=True)
    for n in (256, 512, 1000, 1024, 4096):  # 512: the short request's bucket
        q, k, v = (torch.randn((b, h, n, dh), generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        cases = [[n, n - 37]] + ([[0, n - 37]] if n == 1000 else [])
        for lens_l in cases:
            lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
            got = _check_twice(torch, f"flash n={n} lens={lens_l}",
                               lambda: FA.flash_attention_cuda(q, k, v, lens))
            torch.cuda.synchronize()
            want = FA.flash_attention_plain(q.float(), k.float(), v.float(), lens)
            err = (got.float() - want).abs()
            max_err, mean_err = err.max().item(), err.mean().item()
            if not (max_err <= FLASH_TOL[0] and mean_err <= FLASH_TOL[1]):
                fail(f"flash n={n} lens={lens_l}: max {max_err} mean {mean_err} > {FLASH_TOL}")
            if 0 in lens_l and got[lens_l.index(0)].abs().max().item() != 0.0:
                fail("flash: a row with no valid key must give 0")
            worst = max(worst, max_err)
            print(f"flash_attention n={n} lens={lens_l}: max_abs_err={max_err:.3e} "
                  f"mean_abs_err={mean_err:.3e} (tol {FLASH_TOL})", flush=True)
        lens = torch.tensor([n, n - 37], dtype=torch.int32, device="cuda")
        iters = 50 if n <= 1024 else 10
        configs = _configs_ms(lambda c: FA.flash_attention_cuda(q, k, v, lens, config=c),
                              FA.FWD_CONFIGS, iters)
        ms = configs["{}x{}".format(*FA.FWD_CONFIG)]
        plain_ms = device_ms(lambda: FA.flash_attention_plain(q.float(), k.float(),
                                                                    v.float(), lens), 3)
        keep = (torch.arange(n, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
        lib_ms = device_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=keep), iters)
        flops = sum(4.0 * h * n * kv * dh for kv in (n, n - 37))
        nbytes = 4.0 * b * h * n * dh * 2 + 4 * b
        bms, by = bound_ms(flops, nbytes, PEAK_BF16)
        rows.append(dict(n=n, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
                         bound_by=by, flops=flops, configs_ms=configs, over_library=ms / lib_ms))
        print(f"flash_attention n={n}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"sdpa {lib_ms:.4f} ms, bound {bms:.4f} ms ({by}), kernel over sdpa "
              f"{ms / lib_ms:.3f}, {flops / ms / 1e9:.1f} TFLOP/s", flush=True)
        _print_configs_ms(f"flash_attention n={n}", "A", configs, FA.FWD_CONFIG)
    return rows, worst


def _convpos_weights(torch, gen, d=1024, k=31):
    bound = (64 * k) ** -0.5  # torch's default conv init scale
    w1, w2 = ((torch.rand((d, 64, k), generator=gen, device="cuda") * 2 - 1) * bound
              for _ in range(2))
    b1, b2 = ((torch.rand((d,), generator=gen, device="cuda") * 2 - 1) * bound for _ in range(2))
    return w1, b1, w2, b2


def phase_convpos(torch):
    """Kernel B against its plain version (every configuration built at the
    edge lengths; the fp32 instance), bitwise determinism, device times."""
    from f5_tts_tpu_torch.ops import fused_convpos as FC
    from f5_tts_tpu_torch.utils.device import device_ms

    gen = torch.Generator(device="cuda").manual_seed(1)
    b, d, groups, k = 2, 1024, 16, 31
    w1, b1, w2, b2 = (t.to(torch.bfloat16) for t in _convpos_weights(torch, gen, d, k))
    # the kernel's weight layout, made once as a serving engine makes it
    taps = tuple(FC.kernel_taps(w, groups, torch.bfloat16) for w in (w1, w2))
    rows, worst = [], 0.0
    edge = [(1, [1, 0]), (63, [63, 17]), (65, [65, 64]), (127, [127, 0]), (129, [129, 128]),
            (256, [256, 128]), (300, [0, 0])]
    for n, lens_l in edge:
        x = torch.randn((b, n, d), generator=gen, device="cuda").to(torch.bfloat16)
        lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
        want = FC.conv_pos_plain(*(t.float() for t in (x, w1, b1, w2, b2)), lens, groups)
        errs = []
        for cfg in FC.CONFIGS:
            got = _check_twice(torch, f"convpos n={n} lens={lens_l} {cfg}",
                               lambda: FC.conv_pos_cuda(x, w1, b1, w2, b2, lens, groups, taps,
                                                        cfg))
            torch.cuda.synchronize()
            err = (got.float() - want).abs()
            max_err, mean_err = err.max().item(), err.mean().item()
            if not (max_err <= CONVPOS_TOL[0] and mean_err <= CONVPOS_TOL[1]):
                fail(f"convpos n={n} lens={lens_l} {cfg}: max {max_err} mean {mean_err}")
            if any(torch.count_nonzero(got[i, ln:]) for i, ln in enumerate(lens_l)):
                fail(f"convpos n={n} lens={lens_l} {cfg}: rows past len must be 0")
            worst = max(worst, max_err)
            errs.append(max_err)
        print(f"fused_convpos n={n} lens={lens_l}: every configuration within {CONVPOS_TOL}, "
              f"two launches bitwise equal; max_abs_err {max(errs):.3e}", flush=True)
    # the fp32 instance (three bf16 products per tap) against fp32, TF32 off
    w32 = _convpos_weights(torch, gen, d, k)
    x32 = torch.randn((b, 333, d), generator=gen, device="cuda")
    lens = torch.tensor([333, 250], dtype=torch.int32, device="cuda")
    torch.backends.cudnn.allow_tf32 = False  # the fp32 references from here on are fp32
    want = FC.conv_pos_plain(x32, *w32, lens, groups)
    rel32 = max(((FC.conv_pos_cuda(x32, *w32, lens, groups, config=cfg) - want).abs().max()
                 / want.abs().max()).item() for cfg in FC.CONFIGS)
    print(f"fused_convpos fp32 n=333: max error relative to max |reference| {rel32:.3e} "
          f"(tol {CONVPOS_FP32_REL_TOL}), every configuration", flush=True)
    if rel32 > CONVPOS_FP32_REL_TOL:
        fail("convpos fp32 instance disagrees with the fp32 plain version")
    for n in (256, 512, 1000, 1024, 4096):
        x = torch.randn((b, n, d), generator=gen, device="cuda").to(torch.bfloat16)
        lens = torch.tensor([n, n - 37], dtype=torch.int32, device="cuda")
        got = FC.conv_pos_cuda(x, w1, b1, w2, b2, lens, groups, taps)
        torch.cuda.synchronize()
        f32 = [t.float() for t in (x, w1, b1, w2, b2)]
        want = FC.conv_pos_plain(*f32, lens, groups)
        err = (got.float() - want).abs()
        max_err, mean_err = err.max().item(), err.mean().item()
        if not (max_err <= CONVPOS_TOL[0] and mean_err <= CONVPOS_TOL[1]):
            fail(f"convpos n={n}: max {max_err} mean {mean_err} > {CONVPOS_TOL}")
        worst = max(worst, max_err)
        iters = 20 if n <= 1024 else 5
        configs = _configs_ms(lambda c: FC.conv_pos_cuda(x, w1, b1, w2, b2, lens, groups, taps, c),
                              FC.CONFIGS, iters)
        ms = configs["{}x{}".format(*FC.CONFIG)]
        copy_ms = device_ms(lambda: FC.conv_pos_cuda(x, w1, b1, w2, b2, lens, groups), iters)
        plain_ms = device_ms(lambda: FC.conv_pos_plain(*f32, lens, groups), 3)
        lib_ms = device_ms(lambda: FC.conv_pos_plain(x, w1, b1, w2, b2, lens, groups),
                           iters)
        flops = sum(2 * 2.0 * k * 64 * d * ln for ln in (n, n - 37))
        nbytes = 2.0 * b * n * d * 2 + 2 * (d * 64 * k + d) * 2 + 4 * b
        bms, by = bound_ms(flops, nbytes, PEAK_BF16)
        rows.append(dict(n=n, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
                         bound_by=by, flops=flops, configs_ms=configs, with_copy_ms=copy_ms,
                         over_library=ms / lib_ms))
        print(f"fused_convpos n={n}: max_abs_err={max_err:.3e} mean_abs_err={mean_err:.3e} "
              f"(tol {CONVPOS_TOL}); kernel {ms:.4f} ms (with the per-call weight copy "
              f"{copy_ms:.4f}), plain(fp32) {plain_ms:.4f} ms, cudnn bf16 {lib_ms:.4f} ms, bound "
              f"{bms:.4f} ms ({by}), kernel over cudnn {ms / lib_ms:.3f}, "
              f"{flops / ms / 1e9:.1f} TFLOP/s", flush=True)
        _print_configs_ms(f"fused_convpos n={n}", "B", configs, FC.CONFIG)
    return rows, worst


def _full_width_dit(torch):
    """(cfg, seeded F5TTS_v1_Base DiT on the CPU with its gates randomized,
    run(model, device) -> its fp32 forward_cfg output on fixed inputs)."""
    from f5_tts_tpu_torch.models import dit as D
    from f5_tts_tpu_torch.models.backbones import randomize_zero_init
    from f5_tts_tpu_torch.models.configs import MODEL_CONFIGS

    cfg = MODEL_CONFIGS["F5TTS_v1_Base"].arch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = D.DiT(cfg).eval()
    randomize_zero_init(model, torch.Generator().manual_seed(2))
    gen = torch.Generator().manual_seed(3)
    b, n = 1, 256
    x = torch.randn((b, n, cfg.mel_dim), generator=gen)
    cond = torch.randn((b, n, cfg.mel_dim), generator=gen)
    cond[:, 80:] = 0
    text = torch.randint(0, cfg.text_num_embeds, (b, 60), generator=gen)
    lens = torch.tensor([200])
    mask = torch.arange(n)[None, :] < lens[:, None]
    times = torch.tensor([0.3])

    def run(m, dev):
        with torch.inference_mode():
            args = [t.to(dev) for t in (x, cond, text, lens, mask, times)]
            xx, cc, tt, ll, mm, ts = args
            te_c = D.text_embedding(m, cfg, tt, n, lens=ll)
            te_u = D.text_embedding(m, cfg, tt, n, lens=ll, drop_text=True)
            mods, fin = D.precompute_adaln(m, cfg, ts)
            pred, null = D.forward_cfg(m, cfg, xx, cc, te_c, te_u, ts, mask=mm,
                                       adaln_mods=(mods[0], fin[0]))
            return torch.cat([pred, null]).float().cpu()

    return cfg, model, run


def phase_full_width(torch):
    """F5TTS_v1_Base forward_cfg, fp32: card (kernels) vs CPU (plain)."""
    import copy

    from f5_tts_tpu_torch.ops import flash_attention as FA
    from f5_tts_tpu_torch.ops import fused_convpos as FC

    cfg, model, run = _full_width_dit(torch)
    n = 256
    a0, b0 = FA.KERNEL.launches, FC.KERNEL.launches
    t0 = time.perf_counter()
    got = run(copy.deepcopy(model).cuda(), "cuda")
    t_card = time.perf_counter() - t0
    if FA.KERNEL.launches - a0 != cfg.depth or FC.KERNEL.launches - b0 != 1:
        fail("full-width forward did not run the kernels")
    t0 = time.perf_counter()
    want = run(model, "cpu")
    t_cpu = time.perf_counter() - t0
    err = (got - want).abs()
    scale = want.abs().max().item()
    rel = err.max().item() / scale
    print(f"full-width forward_cfg fp32 n={n}: max_abs_err={err.max().item():.3e} "
          f"mean_abs_err={err.mean().item():.3e} max|ref|={scale:.3e} rel={rel:.3e} "
          f"(card {t_card:.2f} s, cpu {t_cpu:.2f} s)", flush=True)
    if not torch.isfinite(got).all():
        fail("full-width forward: non-finite output")
    return rel


def phase_e2e(torch):
    import numpy as np

    from f5_tts_tpu_torch.audio.preprocess import preprocess_ref_audio_text
    from f5_tts_tpu_torch.infer.api import F5TTS
    from f5_tts_tpu_torch.infer.pipeline import PipelineOptions, infer_batch_process
    from f5_tts_tpu_torch.models.backbones import randomize_zero_init
    from f5_tts_tpu_torch.ops import flash_attention as FA
    from f5_tts_tpu_torch.ops import fused_convpos as FC
    from f5_tts_tpu_torch.text.chunk import chunk_text

    t0 = time.perf_counter()
    tts = F5TTS(model="F5TTS_v1_Base", init_random=True, nfe_step=NFE)
    eng = tts.engine
    randomize_zero_init(eng.model.transformer, torch.Generator().manual_seed(4))
    print(f"e2e: built F5TTS_v1_Base on {eng.device} in {eng.dtype} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    sr, hop = tts.target_sample_rate, eng.hop
    depth = tts.model_cfg.arch.depth

    calls = []  # (rows, gen_frames, wav lengths) of every engine call
    inner = eng.generate_batch_from_wavs

    def recording(*a, **kw):
        mels, wavs, gfs = inner(*a, **kw)
        calls.append((len(gfs), list(gfs), [len(w) for w in wavs]))
        return mels, wavs, gfs

    eng.generate_batch_from_wavs = recording
    quiet = lambda *a, **k: None  # noqa: E731
    short, long = SHORT_TEXT, LONG_TEXT

    def expected_len(lengths):
        total = lengths[0]
        for ln in lengths[1:]:
            total += ln - min(int(0.15 * sr), total, ln)
        return total

    # one warm-up request first: the first call of each shape pays one-time
    # library setup (cuBLAS / cuDNN handles and heuristics), not serving time
    t0 = time.perf_counter()
    tts.infer(REF_WAV, REF_TEXT, short, show_info=quiet, seed=1)
    torch.cuda.synchronize()
    print(f"e2e warm-up request: {time.perf_counter() - t0:.2f} s wall", flush=True)
    calls.clear()

    FA.KERNEL.launches = FC.KERNEL.launches = 0
    copies = FC.TAP_COPIES  # the engine made the kernel's weight layout when it was built
    results = []
    for name, text in (("short", short), ("long", long)):
        before = len(calls)
        t0 = time.perf_counter()
        wav, out_sr, _ = tts.infer(REF_WAV, REF_TEXT, text, show_info=quiet, seed=7)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        new = calls[before:]
        rows = sum(c[0] for c in new)
        for _, gfs, lns in new:
            if lns != [max(g - 1, 0) * hop for g in gfs]:
                fail(f"{name}: row lengths {lns} != (frames-1)*hop for frames {gfs}")
        want = expected_len([ln for c in new for ln in c[2]])
        if wav is None or len(wav) != want or not np.isfinite(wav).all():
            fail(f"{name}: wav of {None if wav is None else len(wav)} samples, want {want}")
        if name == "long" and rows < 2:
            fail("long request was not chunked into a batch of >= 2 rows")
        results.append((name, wall, len(wav) / out_sr, rows, len(new)))

    (ref_wav, ref_sr), ref_text = preprocess_ref_audio_text(REF_WAV, REF_TEXT, show_info=quiet)
    before = len(calls)
    t0 = time.perf_counter()
    chunks = chunk_text(long, max_chars=200)
    pieces = list(infer_batch_process(eng, (ref_wav, ref_sr), ref_text, chunks, tts.vocab,
                                      tokenizer=tts.tokenizer, opts=PipelineOptions(seed=7),
                                      streaming=True))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    new = calls[before:]
    streamed = np.concatenate([p for p, _ in pieces])
    want = sum(ln for c in new for ln in c[2])
    if len(new) < 2 or len(streamed) != want or not np.isfinite(streamed).all():
        fail(f"stream: {len(new)} calls, {len(streamed)} samples, want {want}")
    results.append(("stream", wall, len(streamed) / sr, sum(c[0] for c in new), len(new)))

    forward_calls = len(calls) * NFE  # euler: one fused-CFG forward per step
    a, c = FA.KERNEL.launches, FC.KERNEL.launches
    print(f"e2e launches: flash_attention {a} (want {depth} x {NFE} x {len(calls)}), "
          f"fused_convpos {c} (want {NFE} x {len(calls)})", flush=True)
    if a != depth * forward_calls or c != forward_calls:
        fail("an attention or ConvPositionEmbedding call bypassed its kernel")
    print(f"e2e: {FC.TAP_COPIES - copies} weight copies into kernel B's layout over "
          f"{c} ConvPositionEmbedding calls (want 0: made once per engine)", flush=True)
    if FC.TAP_COPIES != copies:
        fail("a served request copied the ConvPositionEmbedding weights")
    for name, wall, audio_s, rows, n_calls in results:
        print(f"e2e {name}: {n_calls} engine call(s), {rows} row(s), {audio_s:.2f} s audio "
              f"in {wall:.2f} s wall, RTF {wall / audio_s:.4f}", flush=True)
    return a, c



def _rel_err(got, want):
    scale = want.abs().max().clamp(min=1e-12)
    err = (got.float() - want).abs() / scale
    return err.max().item(), err.mean().item()


def _time_train_kernels(torch, FA, q, k, v, do, lens, iters, configs=False):
    """ms of C, D, E, of their plain versions and of SDPA fwd / bwd; with
    ``configs``, of C, D and E in every tile configuration built
    (``C_configs`` / ``D_configs`` / ``E_configs``, keyed "rows x stages")."""
    from f5_tts_tpu_torch.utils.device import device_ms

    o, L = FA.flash_attention_fwd_stats_cuda(q, k, v, lens)
    D = (do.float() * o.float()).sum(-1).contiguous()
    t = {"C": device_ms(lambda: FA.flash_attention_fwd_stats_cuda(q, k, v, lens), iters),
         "D": device_ms(lambda: FA.flash_attention_bwd_dq_cuda(q, k, v, do, L, D, lens),
                       iters),
         "E": device_ms(lambda: FA.flash_attention_bwd_dkv_cuda(q, k, v, do, L, D, lens),
                       iters)}
    if configs:
        t["C_configs"] = _configs_ms(lambda c: FA.flash_attention_fwd_stats_cuda(
            q, k, v, lens, config=c), FA.FWD_CONFIGS, iters)
        t["D_configs"], t["E_configs"] = {}, {}
        for cfg in FA.BWD_CONFIGS:
            key = f"{cfg[0]}x{cfg[1]}"
            t["D_configs"][key] = device_ms(lambda: FA.flash_attention_bwd_dq_cuda(
                q, k, v, do, L, D, lens, config=cfg), iters)
            t["E_configs"][key] = device_ms(lambda: FA.flash_attention_bwd_dkv_cuda(
                q, k, v, do, L, D, lens, config=cfg), iters)
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    t["C_plain"] = device_ms(lambda: FA.flash_attention_fwd_stats_plain(qf, kf, vf, lens), 3)
    t["DE_plain"] = device_ms(lambda: FA.flash_attention_bwd_plain(qf, kf, vf, dof, L, D,
                                                                         lens), 3)
    n = q.shape[2]
    keep = (torch.arange(n, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    xs = [x.detach().requires_grad_(True) for x in (q, k, v)]
    t["C_lib"] = device_ms(lambda: sdpa(q, k, v, attn_mask=keep), iters)
    fwd_g = device_ms(lambda: sdpa(*xs, attn_mask=keep), iters)
    both = device_ms(lambda: torch.autograd.grad(sdpa(*xs, attn_mask=keep), xs, do), iters)
    t["DE_lib"] = both - fwd_g  # the SDPA backward alone
    return t


def _check_deterministic(torch, FA, tag, grads, q, k, v, do, L, D, lens, seg=None):
    """Kernels D and E launched again on the same inputs must give
    bitwise-equal dq, dk, dv (one owner per output tile, no atomics)."""
    again = (FA.flash_attention_bwd_dq_cuda(q, k, v, do, L, D, lens, seg),
             *FA.flash_attention_bwd_dkv_cuda(q, k, v, do, L, D, lens, seg))
    for name, a, b in zip(("dq", "dk", "dv"), grads, again):
        if not torch.equal(a, b):
            fail(f"{tag}: two launches of the backward kernels gave different {name}")


def _print_configs(tag, t):
    from f5_tts_tpu_torch.ops import flash_attention as FA

    chosen = {"D": "{}x{}".format(*FA.DQ_CONFIG), "E": "{}x{}".format(*FA.DKV_CONFIG)}
    _print_configs_ms(tag, "C", t["C_configs"], FA.FWD_CONFIG)
    print(f"{tag}: tile configurations (rows x stages), device ms: D "
          + ", ".join(f"{c} {ms:.4f}" for c, ms in t["D_configs"].items())
          + f" (chosen {chosen['D']}); E "
          + ", ".join(f"{c} {ms:.4f}" for c, ms in t["E_configs"].items())
          + f" (chosen {chosen['E']})", flush=True)


def _train_bounds(b, h, n, dh, kvs):
    """(bound_ms, bound_by) of C, D, E for the valid key counts ``kvs``."""
    flops = {name: sum(c * h * n * kv * dh for kv in kvs) for name, c in
             (("C", 4.0), ("D", 6.0), ("E", 8.0))}
    t16, t32 = b * h * n * dh * 2.0, b * h * n * 4.0
    nbytes = {"C": 4 * t16 + t32, "D": 5 * t16 + 2 * t32, "E": 6 * t16 + 2 * t32}
    return {name: bound_ms(flops[name], nbytes[name] + 4 * b, PEAK_BF16) for name in flops}


def phase_flash_train(torch):
    """Kernels C, D, E against their plain versions, zero-gradient rules, times."""
    from f5_tts_tpu_torch.ops import flash_attention as FA

    gen = torch.Generator(device="cuda").manual_seed(5)
    h, dh = 16, 64
    rows, worst = [], {"C": 0.0, "D": 0.0, "E": 0.0}
    # kernel C at the edge lengths, every configuration, two launches each
    for n, lens_l in ((1, [1, 0]), (63, [63, 17]), (65, [65, 64]), (127, [127, 0]),
                      (129, [129, 128]), (256, [256, 128])):
        q, k, v = (torch.randn((2, h, n, dh), generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
        o_ref, L_ref = FA.flash_attention_fwd_stats_plain(q.float(), k.float(), v.float(), lens)
        for cfg in FA.FWD_CONFIGS:
            o, L = _check_twice(torch, f"kernel C n={n} lens={lens_l} {cfg}",
                                lambda: FA.flash_attention_fwd_stats_cuda(q, k, v, lens,
                                                                          config=cfg))
            err = (o.float() - o_ref).abs()
            l_max = (L - L_ref).abs().max().item()
            if not (err.max().item() <= FLASH_TOL[0] and err.mean().item() <= FLASH_TOL[1]
                    and l_max <= LSE_TOL):
                fail(f"kernel C n={n} lens={lens_l} {cfg} disagrees with its plain version")
            worst["C"] = max(worst["C"], err.max().item())
        print(f"flash train kernel C n={n} lens={lens_l}: every configuration within "
              f"{FLASH_TOL} (L within {LSE_TOL}), two launches bitwise equal", flush=True)
    for b, n in ((2, 256), (2, 1000), (2, 1024), (2, 4096), (TRAIN_B, 1024)):
        q, k, v, do = (torch.randn((b, h, n, dh), generator=gen, device="cuda").to(torch.bfloat16)
                       for _ in range(4))
        if b == 2:
            cases = [[n, n - 37]] + ([[0, n - 37]] if n == 1000 else [])
        else:  # the training shape: ragged rows as a 1024-frame bucket holds them
            cases = [[n - (37 * i) % 256 for i in range(b)]]
        for lens_l in cases:
            lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
            tag = f"flash train b={b} n={n} lens={lens_l if b == 2 else 'ragged'}"
            o, L = _check_twice(torch, tag + " kernel C",
                                lambda: FA.flash_attention_fwd_stats_cuda(q, k, v, lens))
            D = (do.float() * o.float()).sum(-1).contiguous()
            dq = FA.flash_attention_bwd_dq_cuda(q, k, v, do, L, D, lens)
            dk, dv = FA.flash_attention_bwd_dkv_cuda(q, k, v, do, L, D, lens)
            torch.cuda.synchronize()
            _check_deterministic(torch, FA, tag, (dq, dk, dv), q, k, v, do, L, D, lens)
            qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
            o_ref, L_ref = FA.flash_attention_fwd_stats_plain(qf, kf, vf, lens)
            ref = FA.flash_attention_bwd_plain(qf, kf, vf, dof, L, D, lens)
            err = (o.float() - o_ref).abs()
            o_max, o_mean = err.max().item(), err.mean().item()
            l_max = (L - L_ref).abs().max().item()
            errs = [_rel_err(g, r) for g, r in zip((dq, dk, dv), ref)]
            del ref, o_ref
            print(f"{tag}: o max {o_max:.3e} mean {o_mean:.3e} (tol {FLASH_TOL}); L max "
                  f"{l_max:.3e} (tol {LSE_TOL}); dq/dk/dv rel max/mean "
                  + " ".join(f"{a:.3e}/{m:.3e}" for a, m in errs) + f" (tol {GRAD_TOL})",
                  flush=True)
            if not (o_max <= FLASH_TOL[0] and o_mean <= FLASH_TOL[1] and l_max <= LSE_TOL):
                fail(f"{tag}: kernel C disagrees with its plain version")
            for name, (a, m) in zip(("dq", "dk", "dv"), errs):
                if not (a <= GRAD_TOL[0] and m <= GRAD_TOL[1]):
                    fail(f"{tag}: {name} disagrees with the plain backward ({a}, {m})")
            for i, ln in enumerate(lens_l):
                if torch.count_nonzero(dk[i, :, ln:]) or torch.count_nonzero(dv[i, :, ln:]):
                    fail(f"{tag}: keys past lens must get dk = dv = 0 exactly")
                if ln == 0 and (o[i].abs().max().item() or dq[i].abs().max().item()
                                or (L[i] != FA.NO_KEY_LSE).any().item()):
                    fail(f"{tag}: a row with no valid key must give o = 0, L = -1e30 and "
                         "zero gradients")
            worst["C"] = max(worst["C"], o_max)
            worst["D"] = max(worst["D"], errs[0][0])
            worst["E"] = max(worst["E"], errs[1][0], errs[2][0])
        lens = torch.tensor(cases[0], dtype=torch.int32, device="cuda")
        t = _time_train_kernels(torch, FA, q, k, v, do, lens, 20 if n * b <= 4096 else 5,
                                configs=b == TRAIN_B)
        bounds = _train_bounds(b, h, n, dh, cases[0])
        row = dict(b=b, n=n, **t, bounds=bounds, DE_over_lib=(t["D"] + t["E"]) / t["DE_lib"],
                   C_over_lib=t["C"] / t["C_lib"])
        rows.append(row)
        print(f"flash train b={b} n={n}: C {t['C']:.4f} ms (plain {t['C_plain']:.4f}, sdpa fwd "
              f"{t['C_lib']:.4f}, bound {bounds['C'][0]:.4f} {bounds['C'][1]}, C over sdpa fwd "
              f"{row['C_over_lib']:.3f}); D {t['D']:.4f} ms "
              f"(bound {bounds['D'][0]:.4f}); E {t['E']:.4f} ms (bound {bounds['E'][0]:.4f}); "
              f"plain bwd {t['DE_plain']:.4f} ms, sdpa bwd {t['DE_lib']:.4f} ms; D + E over "
              f"sdpa bwd {row['DE_over_lib']:.3f}", flush=True)
        if b == TRAIN_B:
            _print_configs(f"flash train b={b} n={n}", t)
        del q, k, v, do
    torch.cuda.empty_cache()
    return rows, worst


def _fresh_cfm(torch, arch, seed: int, device: str = "cpu"):
    """A seeded CFM built on ``device`` (on the card, the init of a full-width
    model takes well under a second; on the CPU several)."""
    from f5_tts_tpu_torch.models.cfm import CFM

    with torch.random.fork_rng(devices=[0]), torch.device(device):
        torch.manual_seed(seed)
        return CFM(arch)


def phase_grad_check(torch):
    """F5TTS_v1_Base loss + backward in fp32: card (kernels) vs CPU (plain)."""
    import copy

    import numpy as np

    from f5_tts_tpu_torch.models.backbones import randomize_zero_init
    from f5_tts_tpu_torch.models.configs import MODEL_CONFIGS
    from f5_tts_tpu_torch.ops import flash_attention as FA
    from f5_tts_tpu_torch.ops import fused_convpos as FC

    arch = MODEL_CONFIGS["F5TTS_v1_Base"].arch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = _fresh_cfm(torch, arch, 10)
    randomize_zero_init(model.transformer, torch.Generator().manual_seed(11))
    rng = np.random.default_rng(12)
    b, n, lens_l = 2, 256, [256, 201]
    mel = torch.from_numpy(rng.standard_normal((b, n, arch.mel_dim)).astype(np.float32))
    text = rng.integers(0, arch.text_num_embeds, (b, 90)).astype(np.int32)
    text[1, 70:] = -1
    lens = torch.tensor(lens_l, dtype=torch.int32)
    span = np.zeros((b, n), bool)
    span[0, 40:220] = True
    span[1, 10:160] = True
    inject = {"x0": torch.from_numpy(rng.standard_normal((b, n, arch.mel_dim)).astype(np.float32)),
              "time": torch.tensor([0.3, 0.8]), "span_mask": torch.from_numpy(span),
              "drop_audio": False, "drop_both": False}

    def run(m, dev):
        inj = {k: (v.to(dev) if torch.is_tensor(v) else v) for k, v in inject.items()}
        loss = m(mel.to(dev), torch.from_numpy(text).to(dev), lens.to(dev), inject=inj,
                 backend="train_auto")
        loss.backward()
        return loss.item(), {k: p.grad.detach().float().cpu() for k, p in m.named_parameters()}

    card = copy.deepcopy(model).cuda()
    FA.KERNEL.launches = FA.KERNEL_STATS.launches = FA.KERNEL_DQ.launches = 0
    FA.KERNEL_DKV.launches = FC.KERNEL.launches = 0
    t0 = time.perf_counter()
    loss_card, g_card = run(card, "cuda")
    t_card = time.perf_counter() - t0
    counts = (FA.KERNEL_STATS.launches, FA.KERNEL_DQ.launches, FA.KERNEL_DKV.launches,
              FC.KERNEL.launches, FA.KERNEL.launches)
    del card
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    loss_cpu, g_cpu = run(model, "cpu")
    t_cpu = time.perf_counter() - t0
    names = list(g_cpu)
    gc = torch.cat([g_card[k].flatten() for k in names])
    gr = torch.cat([g_cpu[k].flatten() for k in names])
    rel_g = ((gc - gr).norm() / gr.norm()).item()
    rel_l = abs(loss_card - loss_cpu) / abs(loss_cpu)
    per = {k: ((g_card[k] - g_cpu[k]).norm() / g_cpu[k].norm().clamp(min=1e-30)).item()
           for k in names}
    worst = max(per, key=per.get)
    print(f"full-width loss+grad fp32 b={b} n={n}: loss card {loss_card:.6f} cpu {loss_cpu:.6f} "
          f"rel {rel_l:.3e}; gradient rel L2 {rel_g:.3e} over {gr.numel()} values "
          f"(tol {FULL_GRAD_REL_TOL}); worst tensor {worst} rel {per[worst]:.3e}; launches "
          f"C/D/E/B/A {counts} (card {t_card:.2f} s, cpu {t_cpu:.2f} s)", flush=True)
    if counts != (arch.depth, arch.depth, arch.depth, 1, 0):
        fail(f"gradient check launches C/D/E/B/A {counts}, want {arch.depth} x 3, 1, 0")
    if not (rel_l <= FULL_GRAD_REL_TOL and rel_g <= FULL_GRAD_REL_TOL) or not torch.isfinite(gc).all():
        fail("full-width loss or gradient: card and CPU disagree")
    return dict(loss_rel=rel_l, grad_rel=rel_g, worst=worst, worst_rel=per[worst])


def _synthetic_dataset(np, vocab, n_rows: int, seed: int):
    """Seeded mel rows of 3-15 s with texts drawn from the vocab's characters."""
    from f5_tts_tpu_torch.train.dataset import CustomDataset

    rng = np.random.default_rng(seed)
    chars = sorted(c for c in vocab if len(c) == 1 and c.isalpha() and c.isascii())
    rows = []
    for dur in rng.uniform(3.0, 15.0, n_rows):
        frames = int(dur * 24_000 / 256)
        mel = (rng.standard_normal((frames, 100)) * 2.0 - 5.0).astype(np.float32)
        words = ["".join(rng.choice(chars, int(rng.integers(2, 8)))) for _ in range(int(dur * 2.5))]
        rows.append({"mel_spec": mel, "text": " ".join(words), "duration": frames * 256 / 24_000})
    return CustomDataset(rows, preprocessed_mel=True)


def _profile_update(torch, fn, label: str = "one fixed-batch update", host: bool = True) -> dict:
    """Device time by kernel over one call of ``fn`` (torch.profiler): the
    shares of kernels C+D+E (or A) and B, and the device busy share of wall.
    ``host=False`` records device activity only (the host-side op records
    of a request of ~50k small launches would slow it several times)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host else [ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        fn()
    wall_ms = (time.perf_counter() - t0) * 1e3
    groups = {"C": ("flash_fwd_kernel",), "D": ("flash_bwd_dq_kernel",),  # C: every forward instance
              "E": ("flash_bwd_dkv_kernel",), "B": ("convpos_fwd_kernel",),
              "G": ("int8_gemm_kernel",), "gemm": ("gemm", "nvjet")}  # cuBLAS kernels
    ms = dict.fromkeys(groups, 0.0)
    total = 0.0
    kernels = []
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", 0.0) / 1e3
        if ev.device_type.name != "CUDA" or t <= 0:
            continue
        total += t
        kernels.append((t, ev.count, ev.key))
        for g, pats in groups.items():  # the first group that matches
            if any(pat in ev.key.lower() for pat in pats):
                ms[g] += t
                break
    out = {"wall_ms": wall_ms, "device_ms": total, "kernels": sum(c for _, c, _ in kernels),
           "busy_share": total / wall_ms if wall_ms else None, **{f"{g}_ms": v for g, v in ms.items()},
           "other_ms": total - sum(ms.values())}
    if total:
        out["CDE_share"] = (ms["C"] + ms["D"] + ms["E"]) / total
        out["D_share"], out["E_share"] = ms["D"] / total, ms["E"] / total
        # "C" sums every forward instance: A and F when serving, C when training
        out["fwd_share"], out["B_share"] = ms["C"] / total, ms["B"] / total
    print(f"profile of {label}: " + ", ".join(
        f"{k} {v:.3f}" for k, v in out.items() if v is not None), flush=True)
    for t, count, key in sorted(kernels, reverse=True)[:12]:
        print(f"  {t:9.3f} ms {count:6d}x {key[:110]}", flush=True)
    return out


def phase_train(torch):
    """Trainer at full width on the card; then ~8 updates on one fixed batch."""
    import json as _json
    import shutil
    import tempfile

    import numpy as np

    from f5_tts_tpu_torch.models.cfm import CFM
    from f5_tts_tpu_torch.models.configs import MODEL_CONFIGS, with_vocab_size
    from f5_tts_tpu_torch.ops import flash_attention as FA
    from f5_tts_tpu_torch.ops import fused_convpos as FC
    from f5_tts_tpu_torch.text.tokenizer import get_tokenizer
    from f5_tts_tpu_torch.train import step as S
    from f5_tts_tpu_torch.train.dataset import DynamicBatchSampler, collate_batch
    from f5_tts_tpu_torch.train.trainer import Trainer
    from f5_tts_tpu_torch.utils.ckpt import load_dit_state, load_torch_state

    vocab, vocab_size = get_tokenizer(None, "pinyin")
    cfg = with_vocab_size(MODEL_CONFIGS["F5TTS_v1_Base"], vocab_size)
    depth = cfg.arch.depth
    ds = _synthetic_dataset(np, vocab, 320, seed=20)
    opt = S.OptimConfig(mixed_precision=True, num_warmup_updates=1, ema_update_after_step=1,
                        ema_update_every=1, ema_decay=0.99)
    os.makedirs(os.path.join(REPO, ".cache"), exist_ok=True)  # git-ignored scratch
    workdir = tempfile.mkdtemp(prefix="chip_smoke_train_", dir=os.path.join(REPO, ".cache"))
    try:
        trainer = Trainer(cfg, vocab, opt, ckpt_dir=workdir, batch_size_per_device=TRAIN_FRAMES,
                          max_samples=64, save_per_updates=3, last_per_updates=10**9,
                          keep_last_n_checkpoints=1, log_every_updates=1, device="cuda", seed=21)
        model = _fresh_cfm(torch, cfg.arch, 22)
        start = {k: p.detach().clone() for k, p in model.named_parameters()}
        probe = "transformer.proj_out.bias"  # a tensor the EMA rule is checked on
        snaps = []
        from torch.optim.optimizer import register_optimizer_step_post_hook

        hook = register_optimizer_step_post_hook(
            lambda o, a, kw: snaps.append(dict(model.named_parameters())[probe].detach().clone()))
        FA.KERNEL.launches = FA.KERNEL_STATS.launches = FA.KERNEL_DQ.launches = 0
        FA.KERNEL_DKV.launches = FC.KERNEL.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model, ema, update = trainer.train(model, ds, epochs=1, resume=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        hook.remove()
        counts = (FA.KERNEL_STATS.launches, FA.KERNEL_DQ.launches, FA.KERNEL_DKV.launches,
                  FC.KERNEL.launches, FA.KERNEL.launches)
        log = [_json.loads(x) for x in open(os.path.join(workdir, "train_log.jsonl"))]
        micro = log[-1]["micro_step"]
        for rec in log:
            print(f"train update {rec['update']}: {rec['step_time_s']:.3f} s wall, "
                  f"{rec['valid_frames']} frames ({rec['frames']} padded), "
                  f"{rec['valid_frames'] / rec['step_time_s']:.0f} frames/s, "
                  f"loss {rec['loss']:.4f}, grad_norm {rec['grad_norm']:.4f}, max_memory_allocated "
                  f"{rec['max_memory_allocated'] / 2**30:.2f} GiB", flush=True)
        print(f"train: {update} updates ({micro} micro-steps) in {wall:.1f} s with 2 checkpoint "
              f"writes; launches C/D/E/B/A {counts}", flush=True)
        if update < 3 or len(log) != update:
            fail(f"training ran {update} updates, logged {len(log)}; want >= 3, each logged")
        if not all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in log):
            fail("training log holds a non-finite loss or grad_norm")
        if counts != (depth * micro, depth * micro, depth * micro, micro, 0):
            fail(f"training launches C/D/E/B/A {counts}, want {depth} x {micro} x 3, {micro}, 0")
        moved = sum(int(not torch.equal(start[k], p.detach().cpu()))
                    for k, p in model.named_parameters())
        if moved != len(start):
            fail(f"only {moved} of {len(start)} parameter tensors moved")
        want = None
        for u, snap in enumerate(snaps, start=1):  # ema_update_every=1: every update
            want = snap if u <= opt.ema_update_after_step else \
                want * opt.ema_decay + snap * (1 - opt.ema_decay)
        ema_err = (dict(ema.named_parameters())[probe] - want).abs().max().item()
        print(f"train: EMA of {probe} vs the rule over {len(snaps)} updates: max abs {ema_err:.3e}",
              flush=True)
        if len(snaps) != update or ema_err > 1e-6:
            fail("the EMA did not follow its rule")
        files = sorted(os.listdir(workdir))  # save_per_updates=3, keep_last_n_checkpoints=1
        if files != sorted([f"model_{update - update % 3}.pt", "model_last.pt",
                            "train_log.jsonl"]):
            fail(f"checkpoints after {update} updates: {files}")
        for use_ema, src in ((True, ema), (False, model)):
            fresh = CFM(cfg.arch)
            load_dit_state(fresh, load_torch_state(os.path.join(workdir, "model_last.pt"),
                                                   use_ema=use_ema))
            ref = src.state_dict()
            bad = [k for k, v in fresh.state_dict().items() if not torch.equal(v, ref[k].cpu())]
            if bad:
                fail(f"model_last.pt (ema={use_ema}) does not read back: {bad[:3]}")
        print(f"train: {files} read back through load_torch_state (EMA and raw)", flush=True)
        steps = [r for r in log if r["update"] > 1]  # update 1 pays one-time setup
        step_s = sum(r["step_time_s"] for r in steps) / len(steps)
        result = dict(update_s=step_s, frames_per_s=sum(r["valid_frames"] for r in steps)
                      / sum(r["step_time_s"] for r in steps),
                      peak_gib=log[-1]["max_memory_allocated"] / 2**30, updates=update,
                      launches=dict(zip("CDE", counts)))
        del trainer, ema, start, snaps
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    # one fixed batch, fixed draws: the loss must fall
    sampler = DynamicBatchSampler(ds, TRAIN_FRAMES, max_samples=64, random_seed=21)
    batch = collate_batch([ds[i] for i in next(iter(sampler))], vocab, cfg.tokenizer)
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    b, n, d = batch["mel"].shape
    g = torch.Generator(device="cuda").manual_seed(23)
    from f5_tts_tpu_torch.models.cfm import mask_from_frac_lengths

    inject = {"x0": torch.randn((b, n, d), generator=g, device="cuda"),
              "time": torch.rand((b,), generator=g, device="cuda"),
              "span_mask": mask_from_frac_lengths(batch["lens"], n, g),
              "drop_audio": False, "drop_both": False}
    fixed = S.OptimConfig(mixed_precision=True, num_warmup_updates=1, learning_rate=3e-4)
    optim = S.make_optimizer(list(model.parameters()), fixed)
    params = dict(model.named_parameters())
    losses = []
    t0 = time.perf_counter()
    for _ in range(8):
        low = {k: p.to(torch.bfloat16) for k, p in params.items()}
        loss = torch.func.functional_call(
            model, low, (batch["mel"].to(torch.bfloat16), batch["text_ids"], batch["lens"]),
            {"inject": inject})
        optim.step(torch.autograd.grad(loss, list(params.values())))
        losses.append(loss.item())
    fixed_s = (time.perf_counter() - t0) / 8
    print(f"fixed batch [{b}, {n}]: losses {[round(x, 5) for x in losses]} ({fixed_s:.3f} s "
          "per update)", flush=True)
    if not losses[-1] < losses[0]:
        fail("the loss on a fixed batch did not fall")
    result.update(fixed_first=losses[0], fixed_last=losses[-1])

    def one_update():
        low = {k: p.to(torch.bfloat16) for k, p in params.items()}
        loss = torch.func.functional_call(
            model, low, (batch["mel"].to(torch.bfloat16), batch["text_ids"], batch["lens"]),
            {"inject": inject})
        optim.step(torch.autograd.grad(loss, list(params.values())))
        torch.cuda.synchronize()

    result["profile"] = _profile_update(torch, one_update)
    valid = int(batch["lens"].sum().item())
    result["fixed_frames_per_s"] = valid / fixed_s
    prof = result["profile"]
    print(f"fixed-batch update: C {prof['fwd_share']:.1%} ({prof['C_ms']:.1f} ms), B "
          f"{prof['B_share']:.1%} ({prof['B_ms']:.1f} ms), D {prof['D_share']:.1%} and E "
          f"{prof['E_share']:.1%} of "
          f"{prof['device_ms']:.1f} ms device time; {valid} valid frames at "
          f"{result['fixed_frames_per_s']:.0f} frames/s ({fixed_s * 1e3:.1f} ms per update)",
          flush=True)
    del model, optim, params
    torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------------------
# the UNetT / MMDiT slice: kernel F, the two-segment mode of C, D, E, and the
# two backbones end to end


def _single_kernels() -> dict:
    """The kernels outside flash_attention.KERNELS, by letter: B, G (the
    serving instance, ``linear_w8a8``), G_tpu (the TPU-function instance,
    ``int8_matmul``), H, I."""
    from f5_tts_tpu_torch.ops import fused_convpos as FC
    from f5_tts_tpu_torch.ops import quant as Q
    from f5_tts_tpu_torch.scripts import exp_fused_ln_matmul as XI
    from f5_tts_tpu_torch.scripts import exp_pipelined_flash as XH

    return {"B": FC.KERNEL, "G": Q.KERNEL_LINEAR, "G_tpu": Q.KERNEL, "H": XH.KERNEL,
            "I": XI.KERNEL}


def reset_counts() -> None:
    """Every kernel instance's launch count to 0."""
    from f5_tts_tpu_torch.ops import flash_attention as FA

    for kern in (*FA.KERNELS, *_single_kernels().values()):
        kern.launches = 0


def counts() -> dict:
    from f5_tts_tpu_torch.ops import flash_attention as FA

    names = ("A", "C", "D", "E", "F", "C_seg", "D_seg", "E_seg")
    out = {n: k.launches for n, k in zip(names, FA.KERNELS)}
    out.update({n: k.launches for n, k in _single_kernels().items()})
    return out


def _seg_case(torch, gen, b, n, seg, la, lt, dtype):
    h, dh = 16, 64
    q, k, v, do = (torch.randn((b, h, n, dh), generator=gen, device="cuda").to(dtype)
                   for _ in range(4))
    lens2 = torch.tensor([la, lt], dtype=torch.int32, device="cuda").T.contiguous()
    return q, k, v, do, lens2


def _check_seg(torch, FA, tag, q, k, v, do, lens2, seg):
    """F and C, D, E (two-segment mode) against their plain versions, each
    launched twice (bitwise equal): errors."""
    o_f = _check_twice(torch, tag + " kernel F",
                       lambda: FA.flash_attention_cuda(q, k, v, lens2, seg))
    o, L = _check_twice(torch, tag + " kernel C",
                        lambda: FA.flash_attention_fwd_stats_cuda(q, k, v, lens2, seg))
    D = (do.float() * o.float()).sum(-1).contiguous()
    dq = FA.flash_attention_bwd_dq_cuda(q, k, v, do, L, D, lens2, seg)
    dk, dv = FA.flash_attention_bwd_dkv_cuda(q, k, v, do, L, D, lens2, seg)
    torch.cuda.synchronize()
    _check_deterministic(torch, FA, tag, (dq, dk, dv), q, k, v, do, L, D, lens2, seg)
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    o_ref, L_ref = FA.flash_attention_fwd_stats_plain(qf, kf, vf, lens2, seg)
    ref = FA.flash_attention_bwd_plain(qf, kf, vf, dof, L, D, lens2, seg)
    f_err = (o_f.float() - o_ref).abs()
    c_err = (o.float() - o_ref).abs()
    l_max = (L - L_ref).abs().max().item()
    errs = [_rel_err(g, r) for g, r in zip((dq, dk, dv), ref)]
    del ref, o_ref
    f_max, f_mean = f_err.max().item(), f_err.mean().item()
    c_max, c_mean = c_err.max().item(), c_err.mean().item()
    print(f"{tag}: F max {f_max:.3e} mean {f_mean:.3e}; C o max {c_max:.3e} mean {c_mean:.3e} "
          f"(tol {FLASH_TOL}); L max {l_max:.3e} (tol {LSE_TOL}); dq/dk/dv rel max/mean "
          + " ".join(f"{a:.3e}/{m:.3e}" for a, m in errs) + f" (tol {GRAD_TOL})", flush=True)
    for name, mx, mean in (("F", f_max, f_mean), ("C", c_max, c_mean)):
        if not (mx <= FLASH_TOL[0] and mean <= FLASH_TOL[1]):
            fail(f"{tag}: kernel {name} disagrees with its plain version")
    if l_max > LSE_TOL:
        fail(f"{tag}: kernel C's logsumexp disagrees with its plain version")
    for name, (a, m) in zip(("dq", "dk", "dv"), errs):
        if not (a <= GRAD_TOL[0] and m <= GRAD_TOL[1]):
            fail(f"{tag}: {name} disagrees with the plain backward ({a}, {m})")
    valid = FA.key_valid(lens2, q.shape[2], seg)
    for i in range(q.shape[0]):
        if torch.count_nonzero(dk[i][:, ~valid[i]]) or torch.count_nonzero(dv[i][:, ~valid[i]]):
            fail(f"{tag}: keys outside both segments must get dk = dv = 0 exactly")
        if not valid[i].any() and (o_f[i].abs().max().item() or o[i].abs().max().item()
                                   or dq[i].abs().max().item()
                                   or (L[i] != FA.NO_KEY_LSE).any().item()):
            fail(f"{tag}: a row with no valid key must give o = 0, L = -1e30, zero gradients")
    return {"F": f_max, "C": c_max, "D": errs[0][0], "E": max(errs[1][0], errs[2][0])}


def _time_seg(torch, FA, q, k, v, do, lens2, seg, iters):
    """ms of F, C, D, E (two-segment), of A, C, D, E over a prefix of the same
    valid-key count (``*_same_kv``), of the plain versions and of SDPA
    fwd / bwd."""
    from f5_tts_tpu_torch.utils.device import device_ms

    o, L = FA.flash_attention_fwd_stats_cuda(q, k, v, lens2, seg)
    D = (do.float() * o.float()).sum(-1).contiguous()
    kv = (lens2[:, 0] + lens2[:, 1]).contiguous()
    o_p, L_p = FA.flash_attention_fwd_stats_cuda(q, k, v, kv)
    D_p = (do.float() * o_p.float()).sum(-1).contiguous()
    t = {"F": device_ms(lambda: FA.flash_attention_cuda(q, k, v, lens2, seg),
                       iters),
         "A_same_kv": device_ms(lambda: FA.flash_attention_cuda(q, k, v, kv), iters),
         "C": device_ms(lambda: FA.flash_attention_fwd_stats_cuda(q, k, v, lens2, seg),
                       iters),
         "D": device_ms(lambda: FA.flash_attention_bwd_dq_cuda(q, k, v, do, L, D, lens2,
                                                                     seg), iters),
         "E": device_ms(lambda: FA.flash_attention_bwd_dkv_cuda(q, k, v, do, L, D, lens2,
                                                                      seg), iters),
         "C_same_kv": device_ms(lambda: FA.flash_attention_fwd_stats_cuda(q, k, v, kv),
                               iters),
         "D_same_kv": device_ms(lambda: FA.flash_attention_bwd_dq_cuda(q, k, v, do, L_p,
                                                                             D_p, kv), iters),
         "E_same_kv": device_ms(lambda: FA.flash_attention_bwd_dkv_cuda(q, k, v, do, L_p,
                                                                              D_p, kv), iters)}
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    t["F_plain"] = device_ms(lambda: FA.flash_attention_two_segment_plain(qf, kf, vf, lens2,
                                                                                seg), 3)
    t["C_plain"] = device_ms(lambda: FA.flash_attention_fwd_stats_plain(qf, kf, vf, lens2,
                                                                              seg), 3)
    t["DE_plain"] = device_ms(lambda: FA.flash_attention_bwd_plain(qf, kf, vf, dof, L, D,
                                                                         lens2, seg), 3)
    keep = FA.key_valid(lens2, q.shape[2], seg)[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    xs = [x.detach().requires_grad_(True) for x in (q, k, v)]
    t["F_lib"] = device_ms(lambda: sdpa(q, k, v, attn_mask=keep), iters)
    fwd_g = device_ms(lambda: sdpa(*xs, attn_mask=keep), iters)
    both = device_ms(lambda: torch.autograd.grad(sdpa(*xs, attn_mask=keep), xs, do), iters)
    t["DE_lib"] = both - fwd_g
    t["F_configs"] = _configs_ms(lambda c: FA.flash_attention_cuda(q, k, v, lens2, seg, config=c),
                                 FA.FWD_CONFIGS, iters)
    t["C_configs"] = _configs_ms(lambda c: FA.flash_attention_fwd_stats_cuda(
        q, k, v, lens2, seg, config=c), FA.FWD_CONFIGS, iters)
    return t


def phase_flash_seg(torch):
    """Kernel F and the two-segment C, D, E against their plain versions,
    zero rules, times."""
    from f5_tts_tpu_torch.ops import flash_attention as FA

    gen = torch.Generator(device="cuda").manual_seed(30)
    bf16 = torch.bfloat16
    train_b = 8
    cases = [  # (tag, b, n, seg, lens_a, lens_t, dtype, timed)
        ("serving", 2, 2048, 1024, [1024, 812], [180, 97], bf16, True),
        ("training", train_b, 1024 + 256, 1024,
         [1024 - 33 * i for i in range(train_b)], [256 - 19 * i for i in range(train_b)],
         bf16, True),
        ("odd", 2, 1077, 1000, [1000, 811], [77, 30], bf16, False),
        ("tile edges", 2, 1152, 1024, [1024, 960], [128, 64], bf16, False),
        ("odd fp32", 2, 1077, 1000, [1000, 811], [77, 30], torch.float32, False),
        ("empty", 2, 1077, 1000, [1000, 0], [0, 0], bf16, False),
    ]
    worst = {"F": 0.0, "C": 0.0, "D": 0.0, "E": 0.0}
    rows = {}
    for tag, b, n, seg, la, lt, dtype, timed in cases:
        q, k, v, do, lens2 = _seg_case(torch, gen, b, n, seg, la, lt, dtype)
        errs = _check_seg(torch, FA, f"flash seg {tag} b={b} n={n} seg={seg}", q, k, v, do,
                          lens2, seg)
        for key, e in errs.items():
            worst[key] = max(worst[key], e)
        if timed:
            t = _time_seg(torch, FA, q, k, v, do, lens2, seg, 20 if b * n <= 4096 else 10)
            kvs = [a + c for a, c in zip(la, lt)]
            bounds = _train_bounds(b, 16, n, 64, kvs)
            bounds["F"] = bound_ms(sum(4.0 * 16 * n * kv * 64 for kv in kvs),
                                   4.0 * b * 16 * n * 64 * 2 + 8 * b, PEAK_BF16)
            rows[tag] = dict(b=b, n=n, seg=seg, **t, bounds=bounds,
                             DE_over_lib=(t["D"] + t["E"]) / t["DE_lib"],
                             F_over_lib=t["F"] / t["F_lib"], C_over_lib=t["C"] / t["F_lib"])
            print(f"flash seg {tag} [{b}, 16, {n}, 64] seg={seg}: F {t['F']:.4f} ms (kernel A "
                  f"at the same valid keys {t['A_same_kv']:.4f}, plain {t['F_plain']:.4f}, sdpa "
                  f"{t['F_lib']:.4f}, bound {bounds['F'][0]:.4f} {bounds['F'][1]}, F over sdpa "
                  f"{t['F'] / t['F_lib']:.3f}); C "
                  f"{t['C']:.4f} ms (prefix at the same valid keys {t['C_same_kv']:.4f}, plain "
                  f"{t['C_plain']:.4f}, bound {bounds['C'][0]:.4f}, C over sdpa fwd "
                  f"{t['C'] / t['F_lib']:.3f}); D {t['D']:.4f} ms (prefix "
                  f"{t['D_same_kv']:.4f}, bound {bounds['D'][0]:.4f}); E {t['E']:.4f} ms (prefix "
                  f"{t['E_same_kv']:.4f}, bound {bounds['E'][0]:.4f}); plain bwd "
                  f"{t['DE_plain']:.4f} ms, sdpa bwd {t['DE_lib']:.4f} ms; D + E over sdpa bwd "
                  f"{rows[tag]['DE_over_lib']:.3f}", flush=True)
            _print_configs_ms(f"flash seg {tag}", "F", t["F_configs"], FA.FWD_CONFIG)
            _print_configs_ms(f"flash seg {tag}", "C (two-segment)", t["C_configs"],
                              FA.FWD_CONFIG)
        del q, k, v, do
    torch.cuda.empty_cache()
    return rows, worst


def _fresh_backbone(torch, arch, seed: int):
    """A seeded backbone on the card, zero-initialized gates randomized."""
    from f5_tts_tpu_torch.models.backbones import build_backbone, randomize_zero_init

    with torch.random.fork_rng(devices=[0]), torch.device("cuda"):
        torch.manual_seed(seed)
        model = build_backbone(arch).eval()
    randomize_zero_init(model, torch.Generator().manual_seed(seed + 1))
    return model


def _card_vs_cpu(torch, model, run):
    """run(model, dev) with ``model`` on the card, then moved to the CPU with
    its gradients cleared; (card result, CPU result, launches, times)."""
    reset_counts()
    t0 = time.perf_counter()
    got = run(model, "cuda")
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    launched = counts()
    model.zero_grad(set_to_none=True)
    model.cpu()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    want = run(model, "cpu")
    return got, want, launched, t_card, time.perf_counter() - t0


def phase_full_width_backbones(torch):
    """F5TTS_MMDiT_Base masked forward and E2TTS_Base forward_cfg, fp32:
    card (kernels) vs CPU (plain versions)."""
    from f5_tts_tpu_torch.models import mmdit as M
    from f5_tts_tpu_torch.models import unett as U
    from f5_tts_tpu_torch.models.configs import MODEL_CONFIGS

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(31)
    b, n, nt = 2, 256, 64
    mask = torch.arange(n)[None, :] < torch.tensor([[256], [201]])
    text = torch.full((b, nt), -1, dtype=torch.int32)
    text[0, :64] = torch.randint(0, 2545, (64,), generator=gen)
    text[1, :37] = torch.randint(0, 2545, (37,), generator=gen)
    x = torch.randn((b, n, 100), generator=gen)
    cond = torch.randn((b, n, 100), generator=gen)
    cond[1, 150:] = 0
    times = torch.tensor([0.3, 0.7])
    out = {}

    cfg = MODEL_CONFIGS["F5TTS_MMDiT_Base"].arch
    model = _fresh_backbone(torch, cfg, 32)

    def run_mmdit(m, dev):
        with torch.inference_mode():
            args = [t.to(dev) for t in (x, cond, text, times, mask)]
            return M.forward_with_text(m, cfg, *args[:4], mask=args[4], backend="flash",
                                       attn_mask_enabled=True).float().cpu()

    got, want, launched, t_card, t_cpu = _card_vs_cpu(torch, model, run_mmdit)
    del model
    rel = ((got - want).abs().max() / want.abs().max()).item()
    print(f"full-width F5TTS_MMDiT_Base forward_with_text(attn_mask_enabled=True) fp32 b={b} "
          f"n={n} nt={nt}: rel err {rel:.3e} (tol {FULL_WIDTH_REL_TOL}); launches F "
          f"{launched['F']} A {launched['A']} B {launched['B']} (card {t_card:.2f} s, cpu "
          f"{t_cpu:.2f} s)", flush=True)
    if (launched["F"], launched["A"], launched["B"]) != (cfg.depth, 0, 1):
        fail(f"MMDiT masked forward launches F/A/B {launched}, want {cfg.depth}, 0, 1")
    if not torch.isfinite(got).all() or rel > FULL_WIDTH_REL_TOL:
        fail("MMDiT masked forward: card and CPU disagree")
    out["mmdit"] = dict(rel=rel, launches=launched)

    cfg = MODEL_CONFIGS["E2TTS_Base"].arch
    model = _fresh_backbone(torch, cfg, 33)
    text_u = torch.randint(0, 2545, (b, 90), generator=gen).to(torch.int32)

    def run_unett(m, dev):
        with torch.inference_mode():
            tt, xx, cc, ts, mm = (t.to(dev) for t in (text_u, x, cond, times, mask))
            te_c = U.text_embedding(m, cfg, tt, n)
            te_u = U.text_embedding(m, cfg, tt, n, drop_text=True)
            pred, null = U.forward_cfg(m, cfg, xx, cc, te_c, te_u, ts, mask=mm)
            return torch.cat([pred, null]).float().cpu()

    got, want, launched, t_card, t_cpu = _card_vs_cpu(torch, model, run_unett)
    del model
    rel = ((got - want).abs().max() / want.abs().max()).item()
    print(f"full-width E2TTS_Base forward_cfg fp32 b={b} n={n}: rel err {rel:.3e} (tol "
          f"{FULL_WIDTH_REL_TOL}); launches A {launched['A']} B {launched['B']} (card "
          f"{t_card:.2f} s, cpu {t_cpu:.2f} s)", flush=True)
    if (launched["A"], launched["B"]) != (cfg.depth, 1):
        fail(f"E2TTS forward_cfg launches A/B {launched}, want {cfg.depth}, 1")
    if not torch.isfinite(got).all() or rel > FULL_WIDTH_REL_TOL:
        fail("E2TTS forward_cfg: card and CPU disagree")
    out["unett"] = dict(rel=rel, launches=launched)
    return out


def phase_mmdit_grad(torch):
    """F5TTS_MMDiT_Base masked loss + backward in fp32: card (kernels C, D, E
    in the two-segment mode) vs CPU (plain versions)."""
    from f5_tts_tpu_torch.models import mmdit as M
    from f5_tts_tpu_torch.models.configs import MODEL_CONFIGS

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = MODEL_CONFIGS["F5TTS_MMDiT_Base"].arch
    model = _fresh_backbone(torch, cfg, 34).train()
    gen = torch.Generator().manual_seed(35)
    b, n, nt = 2, 256, 64
    mask = torch.arange(n)[None, :] < torch.tensor([[256], [201]])
    text = torch.full((b, nt), -1, dtype=torch.int32)
    text[0, :64] = torch.randint(0, 2545, (64,), generator=gen)
    text[1, :37] = torch.randint(0, 2545, (37,), generator=gen)
    x, cond = torch.randn((b, n, 100), generator=gen), torch.randn((b, n, 100), generator=gen)
    times = torch.tensor([0.3, 0.7])

    def run(m, dev):
        xx, cc, tt, ts, mm = (t.to(dev) for t in (x, cond, text, times, mask))
        o = M.forward_with_text(m, cfg, xx, cc, tt, ts, mask=mm, backend="flash_train",
                                attn_mask_enabled=True)
        loss = ((o * mm[:, :, None]) ** 2).mean()  # tests/test_flash_attention.py:334-337
        loss.backward()
        return loss.item(), {k: p.grad.detach().float().cpu() for k, p in m.named_parameters()}

    (loss_card, g_card), (loss_cpu, g_cpu), launched, t_card, t_cpu = _card_vs_cpu(
        torch, model, run)
    names = list(g_cpu)
    gc = torch.cat([g_card[k].flatten() for k in names])
    gr = torch.cat([g_cpu[k].flatten() for k in names])
    rel_g = ((gc - gr).norm() / gr.norm()).item()
    rel_l = abs(loss_card - loss_cpu) / abs(loss_cpu)
    per = {k: ((g_card[k] - g_cpu[k]).norm() / g_cpu[k].norm().clamp(min=1e-30)).item()
           for k in names}
    worst = max(per, key=per.get)
    seg_launches = (launched["C_seg"], launched["D_seg"], launched["E_seg"], launched["F"])
    print(f"full-width F5TTS_MMDiT_Base masked loss+grad fp32 b={b} n={n} nt={nt}: loss card "
          f"{loss_card:.6f} cpu {loss_cpu:.6f} rel {rel_l:.3e}; gradient rel L2 {rel_g:.3e} over "
          f"{gr.numel()} values (tol {FULL_GRAD_REL_TOL}); worst tensor {worst} rel "
          f"{per[worst]:.3e}; launches C/D/E (two-segment) and F {seg_launches} (card "
          f"{t_card:.2f} s, cpu {t_cpu:.2f} s)", flush=True)
    if seg_launches != (cfg.depth, cfg.depth, cfg.depth, 0):
        fail(f"MMDiT gradient launches {seg_launches}, want {cfg.depth} x 3 and 0")
    if not (rel_l <= FULL_GRAD_REL_TOL and rel_g <= FULL_GRAD_REL_TOL) or not torch.isfinite(gc).all():
        fail("MMDiT masked loss or gradient: card and CPU disagree")
    return dict(loss_rel=rel_l, grad_rel=rel_g, worst=worst, worst_rel=per[worst],
                launches=launched)


def phase_e2e_backbone(torch, model_name: str, texts):
    """``F5TTS(model=model_name, init_random=True)``: one warm-up request,
    then ``texts`` (name, text) timed; every attention call must run kernel
    A and every ConvPositionEmbedding call kernel B."""
    import numpy as np

    from f5_tts_tpu_torch.infer.api import F5TTS
    from f5_tts_tpu_torch.models.backbones import randomize_zero_init

    t0 = time.perf_counter()
    tts = F5TTS(model=model_name, init_random=True, nfe_step=NFE)
    eng = tts.engine
    randomize_zero_init(eng.model.transformer, torch.Generator().manual_seed(36))
    print(f"e2e: built {model_name} on {eng.device} in {eng.dtype} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    depth = tts.model_cfg.arch.depth
    calls = []  # (rows, bucket) of every engine call
    inner = eng.generate_batch_from_wavs

    def recording(ref_wavs, text_ids_list, durations, *a, **kw):
        from f5_tts_tpu_torch.infer.engine import pick_bucket

        out = inner(ref_wavs, text_ids_list, durations, *a, **kw)
        calls.append((len(durations), pick_bucket(max(durations), eng.buckets)))
        return out

    eng.generate_batch_from_wavs = recording
    quiet = lambda *a, **k: None  # noqa: E731
    t0 = time.perf_counter()
    tts.infer(REF_WAV, REF_TEXT, texts[0][1], show_info=quiet, seed=1)
    torch.cuda.synchronize()
    print(f"e2e {model_name} warm-up request: {time.perf_counter() - t0:.2f} s wall", flush=True)
    calls.clear()
    reset_counts()
    results = []
    for name, text in texts:
        before = len(calls)
        t0 = time.perf_counter()
        wav, out_sr, _ = tts.infer(REF_WAV, REF_TEXT, text, show_info=quiet, seed=7)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        new = calls[before:]
        if wav is None or not len(wav) or not np.isfinite(wav).all():
            fail(f"{model_name} {name}: no finite wav")
        results.append(dict(request=name, wall_s=wall, audio_s=len(wav) / out_sr,
                            rtf=wall / (len(wav) / out_sr), rows=sum(c[0] for c in new),
                            buckets=[c[1] for c in new], calls=len(new)))
    launched, n_calls = counts(), len(calls)
    want_a, want_b = depth * NFE * n_calls, NFE * n_calls
    # one more request under the profiler, after the counts are read; its
    # device time over the same request's unprofiled wall is the busy share
    prof = _profile_update(torch, lambda: (tts.infer(REF_WAV, REF_TEXT, texts[0][1],
                                                     show_info=quiet, seed=7),
                                           torch.cuda.synchronize()),
                           f"one {model_name} {texts[0][0]} request (device activity only)",
                           host=False)
    prof["busy_share_of_unprofiled_wall"] = prof["device_ms"] / (results[0]["wall_s"] * 1e3)
    print(f"e2e {model_name} {texts[0][0]}: device busy {prof['device_ms']:.1f} ms of "
          f"{results[0]['wall_s'] * 1e3:.1f} ms unprofiled wall, share "
          f"{prof['busy_share_of_unprofiled_wall']:.3f}; the forward flash kernel (A, F) "
          f"{prof['fwd_share']:.1%} ({prof['C_ms']:.1f} ms) and B {prof['B_share']:.1%} "
          f"({prof['B_ms']:.1f} ms) of the device time", flush=True)
    print(f"e2e {model_name} launches: flash_attention {launched['A']} (want {depth} x {NFE} x "
          f"{n_calls}), fused_convpos {launched['B']} (want {NFE} x {n_calls}), F "
          f"{launched['F']}", flush=True)
    if launched["A"] != want_a or launched["B"] != want_b:
        fail(f"{model_name}: an attention or ConvPositionEmbedding call bypassed its kernel")
    for r in results:
        print(f"e2e {model_name} {r['request']}: {r['calls']} engine call(s), {r['rows']} row(s) "
              f"at bucket(s) {r['buckets']}, {r['audio_s']:.2f} s audio in {r['wall_s']:.2f} s "
              f"wall, RTF {r['rtf']:.4f}", flush=True)
    del tts, eng
    torch.cuda.empty_cache()
    return dict(results=results, launches=launched, profile=prof)


def phase_train_e2tts(torch):
    """Trainer(E2TTS_Base) at full width on the card, mixed precision."""
    import json as _json
    import shutil
    import tempfile

    import numpy as np

    from f5_tts_tpu_torch.models.configs import MODEL_CONFIGS, with_vocab_size
    from f5_tts_tpu_torch.text.tokenizer import get_tokenizer
    from f5_tts_tpu_torch.train import step as S
    from f5_tts_tpu_torch.train.trainer import Trainer

    vocab, vocab_size = get_tokenizer(None, "pinyin")
    cfg = with_vocab_size(MODEL_CONFIGS["E2TTS_Base"], vocab_size)
    depth = cfg.arch.depth
    # rows of 3-15 s hold ~840 frames on average: ~3 updates' worth
    ds = _synthetic_dataset(np, vocab, 3 * E2TTS_TRAIN_FRAMES // 840, seed=40)
    opt = S.OptimConfig(mixed_precision=True, num_warmup_updates=1)
    os.makedirs(os.path.join(REPO, ".cache"), exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_e2tts_", dir=os.path.join(REPO, ".cache"))
    try:
        trainer = Trainer(cfg, vocab, opt, ckpt_dir=workdir,
                          batch_size_per_device=E2TTS_TRAIN_FRAMES, max_samples=64,
                          save_per_updates=10**9, last_per_updates=10**9, log_every_updates=1,
                          device="cuda", seed=42)
        model = _fresh_cfm(torch, cfg.arch, 43, device="cuda")
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model, ema, update = trainer.train(model, ds, epochs=1, resume=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = counts()
        log = [_json.loads(x) for x in open(os.path.join(workdir, "train_log.jsonl"))]
        micro = log[-1]["micro_step"]
        for rec in log:
            print(f"E2TTS train update {rec['update']}: {rec['step_time_s']:.3f} s wall, "
                  f"{rec['valid_frames']} frames ({rec['frames']} padded), "
                  f"{rec['valid_frames'] / rec['step_time_s']:.0f} frames/s, loss "
                  f"{rec['loss']:.4f}, grad_norm {rec['grad_norm']:.4f}, max_memory_allocated "
                  f"{rec['max_memory_allocated'] / 2**30:.2f} GiB", flush=True)
        print(f"E2TTS train: {update} updates at {E2TTS_TRAIN_FRAMES} frames per update in "
              f"{wall:.1f} s (with the final checkpoint write); launches C/D/E/B/A "
              f"{[launched[k] for k in 'CDEBA']}", flush=True)
        if update < 3 or len(log) != update:
            fail(f"E2TTS training ran {update} updates, logged {len(log)}; want >= 3")
        if not all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in log):
            fail("E2TTS training log holds a non-finite loss or grad_norm")
        if [launched[k] for k in "CDEBA"] != [depth * micro] * 3 + [micro, 0]:
            fail(f"E2TTS training launches {launched}, want {depth} x {micro} x 3, {micro}, 0")
        steps = [r for r in log if r["update"] > 1]  # update 1 pays one-time setup
        result = dict(frames_per_update=E2TTS_TRAIN_FRAMES, updates=update,
                      update_s=sum(r["step_time_s"] for r in steps) / len(steps),
                      frames_per_s=sum(r["valid_frames"] for r in steps)
                      / sum(r["step_time_s"] for r in steps),
                      peak_gib=max(r["max_memory_allocated"] for r in log) / 2**30,
                      launches=launched)
        del trainer, model, ema
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------------------
# the W8A8 slice: kernel G, W8A8 serving; the experiment kernels H and I


def _int8_bound(m, k, n, x_bytes=None):
    """Kernel G's bound: 2mkn int8 operations, or its bytes moved once.  The
    TPU-function instance (x_bytes None) reads x_q, w_q and both scales and
    writes fp32; the serving instance reads x in the compute dtype
    (x_bytes per value), w_q, w_scale and the bias, and writes x's dtype."""
    if x_bytes is None:
        nbytes = m * k + n * k + 4.0 * (m + n) + 4.0 * m * n
    else:
        nbytes = x_bytes * m * k + n * k + 4.0 * n + x_bytes * (n + m * n)
    return bound_ms(2.0 * m * k * n, nbytes, PEAK_INT8)


# kernel G's cases: the F5TTS_v1_Base serving shapes at m = 1024, m = 1 and
# 4096, and ragged shapes (k % 16 != 0 in the last two)
INT8_SHAPES = [(1024, k, n) for k, n in SERVING_KN] + [
    (1, 1024, 3072), (1, 4096, 1024), (4096, 1024, 3072), (96, 192, 80), (37, 1000, 200),
    (5, 40, 24)]


HOST_ROUNDS, HOST_CALLS = 21, 200


def _host_us(torch, fns: dict) -> dict:
    """The host's time to issue one eager call of each function, in us:
    ``HOST_ROUNDS`` rounds of ``HOST_CALLS`` calls of each, the order of the
    functions reversed from one round to the next, the card drained
    between.  Returns each function's median, and under ``"rounds"`` its
    time in every round (to count the rounds one function wins)."""
    times = {tag: [] for tag in fns}
    order = list(fns)
    for r in range(HOST_ROUNDS):
        for tag in (order if r % 2 == 0 else order[::-1]):
            fn = fns[tag]
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(HOST_CALLS):
                fn()
            times[tag].append((time.perf_counter() - t0) / HOST_CALLS * 1e6)
            torch.cuda.synchronize()
    out = {tag: sorted(v)[len(v) // 2] for tag, v in times.items()}
    out["rounds"] = times
    return out


def _check_nan_row(torch, Q, x, w_q, ws, bias, tag):
    """A row of x holding a NaN: kernel G's serving instance and its row
    phase give a NaN scale and a NaN output row, as the plain composition
    does, and every other row bitwise as before."""
    x = x.clone()
    x[-1, x.shape[1] // 2] = float("nan")
    plain = Q.linear_w8a8_plain(x, w_q, ws, bias)
    q_p, s_p = Q.quantize_rows(x)
    for launches in (1, 2):
        lin = Q.linear_w8a8_cuda(x, w_q, ws, bias, launches=launches)
        q_k, s_k = Q.quantize_rows_cuda(x)
        torch.cuda.synchronize()
        if not (lin[-1].isnan().all() and s_k[-1].isnan().all() and s_p[-1].isnan().all()
                and plain[-1].isnan().all()):
            fail(f"kernel G {tag} launches={launches}: a row holding a NaN does not give a NaN "
                 f"scale and output row on both sides")
        if not (torch.equal(lin[:-1], plain[:-1]) and torch.equal(q_k[:-1], q_p[:-1])
                and torch.equal(s_k[:-1], s_p[:-1])):
            fail(f"kernel G {tag} launches={launches}: the rows without NaN are not bitwise "
                 f"the plain composition beside a NaN row")


def phase_int8(torch):
    """Kernel G's two instances against their plain versions on the card,
    bitwise, in bf16 and fp32 x: the TPU kernel's function against
    ``int8_matmul_plain``, the serving linear (one launch, and the two-launch
    form) against the plain composition (``quantize_rows``, the product, the
    cast, the bias).  Where the scale's division rounds on the card.  Times
    (bf16): the serving instance beside its bound, the two-launch form, the
    TPU instance beside its own bound, ``torch._int_mm`` + the scale epilogue
    (library), the unfused serving composition on ``_int_mm``, and dense
    bf16 ``F.linear``; the split of k per shape; the host's time per eager
    call (``_host_us``).  Returns the rows, the TPU instance's largest
    absolute and relative differences and the serving instance's largest
    absolute difference (all 0 when bitwise)."""
    from f5_tts_tpu_torch.ops import quant as Q
    from f5_tts_tpu_torch.utils.device import device_ms

    gen = torch.Generator(device="cuda").manual_seed(50)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dtype in (torch.bfloat16, torch.float32):  # the scale's rounding point
        x = (torch.randn((4096, 1024), generator=gen, device="cuda")
             * torch.rand((4096, 1), generator=gen, device="cuda") * 10).to(dtype)
        amax = torch.clamp(x.abs().amax(dim=-1, keepdim=True), min=1e-8)
        by_scalar, true_div = amax / 127.0, Q._div127(amax)
        moved = (x / by_scalar).to(dtype).round() != (x / true_div).to(dtype).round()
        print(f"int8 scale {dtype}: amax / 127.0 (a Python scalar) differs from the true "
              f"division on the card in {(by_scalar != true_div).sum().item()} of 4096 rows, "
              f"moving {moved.sum().item()} int8 values; quantize_rows divides truly", flush=True)
    rows, worst_rel, worst_abs, lin_abs = [], 0.0, 0.0, 0.0
    for m, k, n in INT8_SHAPES:
        w = torch.randn((n, k), generator=gen, device="cuda") * 0.02
        w_q, ws = Q.quantize_weight(w)
        split = Q.split_k(m, n, k, sms)
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
            x[0] = 0  # an all-zero row: scale 1e-8 / 127
            bias = (torch.randn(n, generator=gen, device="cuda") * 0.1).to(dtype)
            x_q, xs = Q.quantize_rows(x)
            got = Q.int8_matmul_cuda(x_q, xs, w_q, ws)
            torch.cuda.synchronize()
            want = Q.int8_matmul_plain(x_q, xs, w_q, ws)
            diff = (got - want).abs()
            rel = (diff / want.abs().clamp(min=1e-30)).max().item()
            worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, diff.max().item())
            if not torch.equal(got, want):
                fail(f"int8_matmul m={m} k={k} n={n}: not bitwise its plain version (max "
                     f"relative error {rel}, tolerance {INT8_REL_TOL})")
            q_k, s_k = Q.quantize_rows_cuda(x)
            if not (torch.equal(q_k, x_q) and torch.equal(s_k, xs)):
                fail(f"kernel G's row phase {dtype} m={m} k={k}: not bitwise quantize_rows")
            for b in (bias, None):
                plain = Q.linear_w8a8_plain(x, w_q, ws, b)
                for launches in (1, 2):
                    lin = Q.linear_w8a8_cuda(x, w_q, ws, b, launches=launches)
                    torch.cuda.synchronize()
                    err = (lin.float() - plain.float()).abs().max().item()
                    lin_abs = max(lin_abs, err)
                    if not torch.equal(lin, plain):
                        fail(f"linear_w8a8 {dtype} m={m} k={k} n={n} bias={b is not None} "
                             f"launches={launches}: not bitwise the plain composition "
                             f"(max abs {err})")
            if k == 1024 or k % 16:  # a NaN row: the register and two-pass rows, gathers
                _check_nan_row(torch, Q, x, w_q, ws, bias, f"{dtype} m={m} k={k} n={n}")
            if dtype != torch.bfloat16 or k % 16:
                continue
            iters = 50
            ms = device_ms(lambda: Q.linear_w8a8_cuda(x, w_q, ws, bias), iters)
            two_ms = device_ms(lambda: Q.linear_w8a8_cuda(x, w_q, ws, bias, launches=2), iters)
            row_ms = device_ms(lambda: Q.quantize_rows_cuda(x), iters)
            tpu_ms = device_ms(lambda: Q.int8_matmul_cuda(x_q, xs, w_q, ws), iters)
            plain_ms = device_ms(lambda: Q.linear_w8a8_plain(x, w_q, ws, bias), 3)
            tpu_plain_ms = device_ms(lambda: Q.int8_matmul_plain(x_q, xs, w_q, ws), 3)
            w_bf16 = w.to(torch.bfloat16)
            lib_ms = unfused_ms = None
            if m > 16 and k % 8 == 0 and n % 8 == 0:  # what torch._int_mm takes on CUDA
                w_t = w_q.t()
                lib_ms = device_ms(lambda: torch._int_mm(x_q, w_t).float() * xs * ws, iters)

                def unfused():
                    q, s = Q.quantize_rows(x)
                    return (torch._int_mm(q, w_t).float() * s * ws).to(x.dtype) + bias

                unfused_ms = device_ms(unfused, iters)
            dense_ms = device_ms(lambda: torch.nn.functional.linear(x, w_bf16, bias), iters)
            bms, by = _int8_bound(m, k, n, x_bytes=2)
            tpu_bms, tpu_by = _int8_bound(m, k, n)
            host = _host_us(torch, {
                "one_launch": lambda: Q.linear_w8a8_cuda(x, w_q, ws, bias),
                "two_launch": lambda: Q.linear_w8a8_cuda(x, w_q, ws, bias, launches=2),
                "dense_bf16": lambda: torch.nn.functional.linear(x, w_bf16, bias)})
            rounds = host.pop("rounds")
            host["one_launch_wins"] = sum(
                a < b for a, b in zip(rounds["one_launch"], rounds["two_launch"]))
            rows.append(dict(m=m, k=k, n=n, split=split, ms=ms, two_launch_ms=two_ms, row_ms=row_ms,
                             tpu_ms=tpu_ms, plain_ms=plain_ms, tpu_plain_ms=tpu_plain_ms,
                             library_ms=lib_ms,
                             unfused_ms=unfused_ms, dense_bf16_ms=dense_ms, bound_ms=bms,
                             bound_by=by, tpu_bound_ms=tpu_bms, tpu_bound_by=tpu_by,
                             host_us=host))
            fmt = lambda v: "n/a" if v is None else f"{v:.4f} ms"  # noqa: E731
            print(f"kernel G m={m} k={k} n={n} split {split}: bitwise both instances, bf16 and "
                  f"fp32; device time: serving {ms:.4f} ms (bound {bms:.4f} ms, {by}; "
                  f"{2.0 * m * k * n / ms / 1e9:.1f} TOP/s), two launches {two_ms:.4f} ms (the row "
                  f"phase alone {row_ms:.4f} ms), "
                  f"TPU instance {tpu_ms:.4f} ms (bound {tpu_bms:.4f} ms, {tpu_by}), plain "
                  f"{plain_ms:.4f} ms, _int_mm+epilogue {fmt(lib_ms)}, quantize_rows+_int_mm+"
                  f"epilogue+cast+bias {fmt(unfused_ms)}, bf16 F.linear {dense_ms:.4f} ms; host "
                  f"time per eager call (median of {HOST_ROUNDS} rounds of {HOST_CALLS}): one "
                  f"launch {host['one_launch']:.2f} us, two launches {host['two_launch']:.2f} us "
                  f"(one launch cheaper in {host['one_launch_wins']} of {HOST_ROUNDS} rounds), "
                  f"bf16 F.linear {host['dense_bf16']:.2f} us", flush=True)
        print(f"kernel G m={m} k={k} n={n}: both instances bitwise their plain versions "
              f"(bf16 and fp32 x; with and without bias; one and two launches)", flush=True)
    # every split of k at qkv and ff out, and ff out at a k that is not a
    # power of two (bf16 x with a bias)
    for m, k, n in ((1024, 1024, 3072), (1024, 4096, 1024), (1024, 3968, 1024)):
        x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
        w = torch.randn((n, k), generator=gen, device="cuda") * 0.02
        w_q, ws = Q.quantize_weight(w)
        bias = (torch.randn(n, generator=gen, device="cuda") * 0.1).to(torch.bfloat16)
        x_q, xs = Q.quantize_rows(x)
        t = {}
        for sp in (1, 2, 4):
            t[f"serving split {sp}"] = device_ms(lambda: Q.linear_w8a8_cuda(x, w_q, ws, bias,
                                                                           splits=sp), 50)
            t[f"TPU instance split {sp}"] = device_ms(
                lambda: Q.int8_matmul_cuda(x_q, xs, w_q, ws, splits=sp), 50)
        print(f"kernel G m={m} k={k} n={n} by split of k, device time: " + ", ".join(
            f"{key} {v:.4f} ms" for key, v in t.items()), flush=True)
    return rows, worst_abs, worst_rel, lin_abs


def _quantized_engine(torch, tts):
    """A W8A8 InferenceEngine on a copy of ``tts``'s model (the engine
    quantizes its model in place)."""
    import copy
    import dataclasses

    from f5_tts_tpu_torch.infer.engine import InferenceEngine

    dense = tts.engine
    return InferenceEngine(copy.deepcopy(dense.model), tts.model_cfg, vocoder=dense.vocoder,
                           dtype=dense.dtype,
                           options=dataclasses.replace(dense.options, quantize=True))


def phase_w8a8_serving(torch):
    """A dense and a W8A8 F5TTS_v1_Base engine on the same request and seed:
    mel MAE gate, launch counts, RTFs; one W8A8 F5TTS_MMDiT_Base request;
    E2TTS_Base refuses ``quantize=True``."""
    import numpy as np

    from f5_tts_tpu_torch.infer.api import F5TTS
    from f5_tts_tpu_torch.infer.engine import EngineOptions, InferenceEngine
    from f5_tts_tpu_torch.models.backbones import randomize_zero_init
    from f5_tts_tpu_torch.models.configs import MODEL_CONFIGS

    quiet = lambda *a, **k: None  # noqa: E731
    out = {}
    tts = F5TTS(model="F5TTS_v1_Base", init_random=True, nfe_step=NFE)
    randomize_zero_init(tts.engine.model.transformer, torch.Generator().manual_seed(4))
    dense = tts.engine
    quant = _quantized_engine(torch, tts)
    depth = tts.model_cfg.arch.depth
    for tag, eng in (("dense", dense), ("w8a8", quant)):
        tts.engine = eng
        tts.infer(REF_WAV, REF_TEXT, SHORT_TEXT, show_info=quiet, seed=1)  # warm-up
        torch.cuda.synchronize()
        calls = []
        inner = eng.generate_batch_from_wavs
        eng.generate_batch_from_wavs = lambda *a, **kw: calls.append(1) or inner(*a, **kw)
        reset_counts()
        t0 = time.perf_counter()
        wav, sr, spec = tts.infer(REF_WAV, REF_TEXT, SHORT_TEXT, show_info=quiet, seed=7)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = counts()
        del eng.generate_batch_from_wavs
        if wav is None or not np.isfinite(wav).all() or not np.isfinite(spec).all():
            fail(f"W8A8 serving {tag}: no finite wav / mel")
        # the same request again under the profiler, after the counts are read
        prof = _profile_update(torch, lambda: (tts.infer(REF_WAV, REF_TEXT, SHORT_TEXT,
                                                         show_info=quiet, seed=7),
                                               torch.cuda.synchronize()),
                               f"one {tag} F5TTS_v1_Base short request (device activity only)",
                               host=False)
        prof["busy_share_of_unprofiled_wall"] = prof["device_ms"] / (wall * 1e3)
        print(f"W8A8 serving F5TTS_v1_Base {tag}: device busy {prof['device_ms']:.1f} ms of "
              f"{wall * 1e3:.1f} ms unprofiled wall ({prof['busy_share_of_unprofiled_wall']:.1%}), "
              f"{prof['kernels']} kernels; kernel A {prof['fwd_share']:.1%} "
              f"({prof['C_ms']:.1f} ms), B {prof['B_share']:.1%} ({prof['B_ms']:.1f} ms), G "
              f"{prof['G_ms']:.1f} ms, cuBLAS {prof['gemm_ms']:.1f} ms, the rest "
              f"{prof['other_ms']:.1f} ms of the device time", flush=True)
        out[tag] = dict(wall_s=wall, audio_s=len(wav) / sr, rtf=wall / (len(wav) / sr),
                        calls=len(calls), launches=launched, spec=spec, profile=prof)
        print(f"W8A8 serving F5TTS_v1_Base {tag}: {len(calls)} engine call(s), "
              f"{len(wav) / sr:.2f} s audio in {wall:.2f} s wall, RTF {wall / (len(wav) / sr):.4f}; "
              f"launches G {launched['G']} A {launched['A']} B {launched['B']}", flush=True)
    d, q = out["dense"], out["w8a8"]
    want_g = 4 * depth * NFE * q["calls"]
    if d["launches"]["G"] != 0 or q["launches"]["G"] != want_g:
        fail(f"W8A8 launches of G: dense {d['launches']['G']} (want 0), quantized "
             f"{q['launches']['G']} (want 4 x {depth} x {NFE} x {q['calls']} = {want_g})")
    if d["launches"]["G_tpu"] or q["launches"]["G_tpu"]:
        fail("W8A8 serving: G's TPU-function instance launched; every quantized linear is one "
             "launch of the serving instance")
    for tag, launched in (("dense", d["launches"]), ("W8A8", q["launches"])):
        if launched["H"] or launched["I"]:
            fail(f"W8A8 serving {tag}: the experiment kernels launched (H {launched['H']}, "
                 f"I {launched['I']}); they are on no serving path")
    for key in ("A", "B"):
        if d["launches"][key] != q["launches"][key] or \
                d["launches"][key] != (depth if key == "A" else 1) * NFE * d["calls"]:
            fail(f"W8A8 serving: launches of {key} dense {d['launches'][key]}, quantized "
                 f"{q['launches'][key]}")
    if d["spec"].shape != q["spec"].shape:
        fail(f"W8A8 serving: mel shapes {d['spec'].shape} != {q['spec'].shape}")
    mae = float(np.abs(d["spec"] - q["spec"]).mean())
    print(f"W8A8 serving F5TTS_v1_Base: generated-mel MAE dense vs W8A8 {mae:.5f} (gate "
          f"{MEL_MAE_GATE}, and > 0); RTF ratio W8A8 / dense {q['rtf'] / d['rtf']:.3f}; kernels "
          f"W8A8 {q['profile']['kernels']} dense {d['profile']['kernels']}; device time W8A8 "
          f"{q['profile']['device_ms']:.1f} ms dense {d['profile']['device_ms']:.1f} ms", flush=True)
    if not 0.0 < mae < MEL_MAE_GATE:
        fail(f"W8A8 serving: mel MAE {mae} outside (0, {MEL_MAE_GATE})")
    result = dict(mel_mae=mae,
                  launches_per_call={key: q["launches"][key] // q["calls"]
                                     for key in ("G", "G_tpu", "H", "I")},
                  **{f"{t}_{k}": out[t][k] for t in out
                     for k in ("rtf", "wall_s", "audio_s", "profile")},
                  dense_launches=d["launches"], w8a8_launches=q["launches"])
    tts.engine = dense
    del tts, dense, quant
    torch.cuda.empty_cache()

    # F5TTS_MMDiT_Base served quantized: only the x-stream q/k/v/out of the
    # depth - 1 mid blocks are W8A8 (JAX quantize_dit_blocks on MMDiT's tree)
    tts = F5TTS(model="F5TTS_MMDiT_Base", init_random=True, nfe_step=NFE)
    randomize_zero_init(tts.engine.model.transformer, torch.Generator().manual_seed(36))
    tts.engine = _quantized_engine(torch, tts)
    depth = tts.model_cfg.arch.depth
    tts.infer(REF_WAV, REF_TEXT, SHORT_TEXT, show_info=quiet, seed=1)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    wav, sr, _ = tts.infer(REF_WAV, REF_TEXT, SHORT_TEXT, show_info=quiet, seed=7)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts()
    want_g = 4 * (depth - 1) * NFE
    print(f"W8A8 serving F5TTS_MMDiT_Base: {len(wav) / sr:.2f} s audio in {wall:.2f} s wall, RTF "
          f"{wall / (len(wav) / sr):.4f}; launches G {launched['G']} (want 4 x {depth - 1} x "
          f"{NFE} = {want_g}) A {launched['A']}", flush=True)
    if launched["G"] != want_g or launched["A"] != depth * NFE or not np.isfinite(wav).all():
        fail("W8A8 F5TTS_MMDiT_Base request: wrong launches or a non-finite wav")
    result["mmdit"] = dict(rtf=wall / (len(wav) / sr), wall_s=wall, launches=launched)
    del tts
    torch.cuda.empty_cache()

    cfg = MODEL_CONFIGS["E2TTS_Base"]
    model = _fresh_cfm(torch, cfg.arch, 37, device="cuda")
    try:
        InferenceEngine(model, cfg, dtype=torch.bfloat16, options=EngineOptions(quantize=True))
    except ValueError as e:
        print(f"W8A8 E2TTS_Base: InferenceEngine(quantize=True) raises ValueError ({e})", flush=True)
    else:
        fail("W8A8 E2TTS_Base: InferenceEngine(quantize=True) did not raise")
    del model
    torch.cuda.empty_cache()
    return result


def phase_w8a8_full_width(torch):
    """F5TTS_v1_Base W8A8 forward_cfg in fp32: card (kernel G) vs CPU (plain
    version), and the share of int8 activations the two quantize
    differently: each quantized linear's input is captured on both sides
    and quantized by the plain ``quantize_rows`` on its own device (the card
    quantizes inside G, bitwise as ``quantize_rows`` does there, phase 14)."""
    import copy

    from f5_tts_tpu_torch.models import dit as D
    from f5_tts_tpu_torch.models import layers as L
    from f5_tts_tpu_torch.ops import quant as Q

    cfg, model, run = _full_width_dit(torch)
    n = 256
    D.fuse_for_inference(model)
    names = Q.quantize_dit_blocks(model, cfg)
    seen = []  # the input of every quantized linear, in call order
    inner = L.linear_w8a8

    def recording(x, *args):
        seen.append(x.detach())
        return inner(x, *args)

    L.linear_w8a8 = recording
    try:
        reset_counts()
        got = run(copy.deepcopy(model).cuda(), "cuda")
        launched = counts()
        x_card, seen[:] = list(seen), []
        want = run(model, "cpu")
        x_cpu = list(seen)
    finally:
        L.linear_w8a8 = inner
    q_card = [Q.quantize_rows(x.reshape(-1, x.shape[-1]))[0].cpu() for x in x_card]
    q_cpu = [Q.quantize_rows(x.reshape(-1, x.shape[-1]))[0] for x in x_cpu]
    del x_card, x_cpu
    rel = ((got - want).abs().max() / want.abs().max()).item()
    flips = [(a != c).float().mean().item() for a, c in zip(q_card, q_cpu)]
    steps = max((a.int() - c.int()).abs().max().item() for a, c in zip(q_card, q_cpu))
    total = sum(f * a.numel() for f, a in zip(flips, q_card)) / sum(a.numel() for a in q_card)
    print(f"full-width W8A8 forward_cfg fp32 n={n}: rel err {rel:.3e} (tol {W8A8_FULL_REL_TOL}); "
          f"{len(names)} quantized weights, launches G {launched['G']} (want {4 * cfg.depth}); "
          f"int8 activations card vs CPU differ in {total:.3e} of entries (first layer "
          f"{flips[0]:.3e}, last {flips[-1]:.3e}), by at most {steps} step(s)", flush=True)
    if launched["G"] != 4 * cfg.depth or {len(q_card), len(q_cpu)} != {4 * cfg.depth}:
        fail(f"W8A8 full-width forward launches G {launched['G']}, want {4 * cfg.depth}")
    if not torch.isfinite(got).all() or rel > W8A8_FULL_REL_TOL:
        fail("W8A8 full-width forward: card and CPU disagree")
    return dict(rel=rel, flipped_share=total, flipped_first=flips[0], flipped_last=flips[-1],
                max_steps=steps, launches=launched)


def _graph_replay(torch, fn):
    """fn() captured once in a CUDA graph (after a warm-up on the capture
    stream) and replayed into its output, which is zeroed first."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = fn()
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    return out


# kernel H's cases (b, n, lens) at 16 heads: the experiment's shape, ragged n
# with a row of no valid key, a single valid key, n = 4096, a length across a
# tile edge, and b*h = 128
H_CASES = ((2, 1024, [1024, 824]), (2, 1000, [0, 963]), (2, 65, [65, 1]), (2, 4096, [4096, 4059]),
           (2, 1025, [1025, 127]), (8, 1024, [1024, 1000, 1, 64, 129, 512, 1023, 0]))


def phase_experiments(torch):
    """Kernels H and I against their plain versions (bf16), timed beside
    kernel A / SDPA and beside the unfused composition (I at K = 1024,
    2048 and 4096, and at ragged shapes).  Every instance of H in every
    case of ``H_CASES``, launched twice and replayed from a CUDA graph,
    bitwise equal each time."""
    from f5_tts_tpu_torch.ops import flash_attention as FA
    from f5_tts_tpu_torch.scripts import exp_fused_ln_matmul as XI
    from f5_tts_tpu_torch.scripts import exp_pipelined_flash as XH
    from f5_tts_tpu_torch.utils.device import device_ms

    gen = torch.Generator(device="cuda").manual_seed(60)
    h, dh = 16, 64
    worst_h = 0.0
    rows_h = {}
    for b, n, lens_l in H_CASES:
        q, k, v = (torch.randn((b, h, n, dh), generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
        want = FA.flash_attention_plain(q.float(), k.float(), v.float(), lens)
        tag = f"kernel H [{b}, {h}, {n}, {dh}] lens={lens_l}"
        for cfg in XH.CONFIGS:
            got = _check_twice(torch, f"{tag} {cfg}", lambda: XH.flash_pipe_cuda(q, k, v, lens, *cfg))
            torch.cuda.synchronize()
            err = (got.float() - want).abs()
            mx, mean = err.max().item(), err.mean().item()
            worst_h = max(worst_h, mx)
            if not (mx <= FLASH_TOL[0] and mean <= FLASH_TOL[1]):
                fail(f"{tag} {cfg}: max {mx} mean {mean}")
            for i, kv in enumerate(lens_l):
                if kv == 0 and got[i].abs().max().item() != 0.0:
                    fail(f"{tag} {cfg}: a row with no valid key must give exactly 0")
            if not torch.equal(_graph_replay(torch, lambda: XH.flash_pipe_cuda(q, k, v, lens, *cfg)),
                               got):
                fail(f"{tag} {cfg}: a CUDA-graph replay differs from the eager launch")
        print(f"{tag}: every instance within {FLASH_TOL} of the plain version, bitwise in two "
              "launches and in a graph replay", flush=True)
        if b == 2 and n in (1024, 4096):  # device time per call, as phase 14
            iters = 50 if n == 1024 else 10
            t = {"H_" + "x".join(map(str, cfg)): device_ms(
                lambda: XH.flash_pipe_cuda(q, k, v, lens, *cfg), iters) for cfg in XH.CONFIGS}
            t["A"] = device_ms(lambda: FA.flash_attention_cuda(q, k, v, lens), iters)
            t["plain"] = device_ms(lambda: FA.flash_attention_plain(q.float(), k.float(),
                                                                           v.float(), lens), 3)
            keep = (torch.arange(n, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
            t["sdpa"] = device_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=keep), iters)
            bms, by = bound_ms(sum(4.0 * h * n * kv * dh for kv in lens_l),
                               4.0 * b * h * n * dh * 2 + 4 * b, PEAK_BF16)
            rows_h[n] = dict(**t, bound_ms=bms, bound_by=by)
            print(f"{tag}, device time per call (share of the {bms:.4f} ms bound, {by}): "
                  + ", ".join(f"{key} {val:.4f} ms ({bms / val:.1%})" for key, val in t.items()),
                  flush=True)

    worst_i = 0.0
    rows_i = {}
    for m, kk, nn in ((2048, 1024, 3072), (2048, 2048, 3072), (2048, 4096, 3072),
                      (37, 1000, 1001), (100, 1024, 200), (64, 20, 36), (8, 2048, 64)):
        args = XI.inputs(m, kk, nn, "cuda", seed=61)
        got = XI.fused_ln_matmul_cuda(*args)
        torch.cuda.synchronize()
        want = XI.fused_ln_matmul_plain(*args).float()
        mx, mean = _rel_err(got, want)
        worst_i = max(worst_i, mx)
        print(f"kernel I M={m} K={kk} N={nn}: error relative to max |ref| max {mx:.3e} mean "
              f"{mean:.3e} (tol {LN_MATMUL_TOL})", flush=True)
        if not (mx <= LN_MATMUL_TOL[0] and mean <= LN_MATMUL_TOL[1]):
            fail(f"kernel I M={m} K={kk} N={nn} disagrees with its plain version")
        if m == 2048:
            ms = device_ms(lambda: XI.fused_ln_matmul_cuda(*args), 50)
            plain_ms = device_ms(lambda: XI.fused_ln_matmul_plain(*args), 20)
            lib_ms = device_ms(lambda: XI.unfused(*args), 50)
            nbytes = 2.0 * (m * kk + kk * nn + m * nn) + 4.0 * (nn + 2 * kk)
            bms, by = bound_ms(2.0 * m * kk * nn, nbytes, PEAK_BF16)
            rows_i[kk] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
                              bound_by=by)
            print(f"kernel I M={m} K={kk} N={nn}, device time per call: kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, "
                  f"unfused torch {lib_ms:.4f} ms, bound {bms:.4f} ms ({by}), "
                  f"{2.0 * m * kk * nn / ms / 1e9:.1f} TFLOP/s", flush=True)
    x, w, bias, sc, sh = XI.inputs(8, 2048, 64, "cuda")
    try:
        XI.fused_ln_matmul_cuda(x.float(), w, bias, sc, sh)
    except TypeError as e:
        print(f"kernel I fp32 x: raises TypeError ({e})", flush=True)
    else:
        fail("kernel I took an fp32 x")
    row_i = dict(rows_i[1024], by_k=rows_i)
    return rows_h, worst_h, row_i, worst_i


def ptxas_summary(log: str) -> list[str]:
    """One line per kernel instance from nvcc's -Xptxas=-v log: its
    demangled name (template arguments included), registers and spills, and
    whether ptxas serialised its wgmma instructions (its "Potential
    Performance Loss" notes, with their codes)."""
    import re

    names, out, name, spill = [], [], None, ""
    serialized = {}
    for line in log.splitlines():
        m = re.search(r"\((C\d+)\) Potential Performance Loss: wgmma.*in the function '(\w+)'", line)
        if m:
            serialized.setdefault(m.group(2), []).append(m.group(1))
    for line in log.splitlines():
        if line.startswith("=="):
            out.append(line.strip())
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        if "spill" in line and name:
            spill = line.strip()
        if "Used" in line and "registers" in line and name:
            names.append(name)
            ser = serialized.get(name)
            out.append(f"{name} | {line.split(':', 1)[1].strip()} | {spill} | "
                       + (f"wgmma serialized ({', '.join(ser)})" if ser else "wgmma not serialized"))
            name = None
    for tool in ("c++filt", "/usr/local/cuda/bin/cu++filt"):  # demangle where one is there
        try:
            dem = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True,
                                 check=True).stdout.splitlines()
        except (OSError, subprocess.CalledProcessError):
            continue
        # the kernel's name and template arguments, without "void " and its parameter list
        table = {n: d.replace("(anonymous namespace)::", "").split("(")[0].removeprefix("void ")
                 for n, d in zip(names, dem)}
        return [" | ".join([table.get(x.split(" | ")[0], x.split(" | ")[0])] + x.split(" | ")[1:])
                if " | " in x else x for x in out]
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "f5_tts_tpu_torch")):
        print("FAIL: run from a checkout of the repository (f5_tts_tpu_torch missing)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    from f5_tts_tpu_torch.ops.cuda_build import LIBRARY

    LIBRARY.build()
    print(f"built {LIBRARY.sources()} in {LIBRARY.build_seconds or 0.0:.1f} s", flush=True)
    summary = ptxas_summary(LIBRARY.build_log)
    for line in summary:
        print("  " + line, flush=True)
    # kernel H's design rests on asynchronous wgmma: ptxas must neither
    # serialise nor spill any of its instances
    import re

    h_ptxas = [line for line in summary if "flash_pipe_kernel" in line]
    if not h_ptxas or any("wgmma not serialized" not in line
                          or not re.search(r"\b0 bytes spill stores", line) for line in h_ptxas):
        fail(f"kernel H: ptxas serialised wgmma or spilled: {h_ptxas}")
    print(f"kernel H: {len(h_ptxas)} instances, no spills, no wgmma serialization", flush=True)

    t_start = time.perf_counter()
    clock = {"t": t_start}

    def lap(name):
        now = time.perf_counter()
        print(f"phase {name}: {now - clock['t']:.1f} s", flush=True)
        clock["t"] = now

    flash_rows, flash_err = phase_flash(torch)
    conv_rows, conv_err = phase_convpos(torch)
    lap("2-3 (kernels A, B)")
    rel = phase_full_width(torch)
    if rel > FULL_WIDTH_REL_TOL:
        fail(f"full-width forward rel err {rel} > {FULL_WIDTH_REL_TOL}")
    lap("4 (DiT forward)")
    launches_a, launches_b = phase_e2e(torch)
    lap("5 (DiT serving)")
    train_rows, train_err = phase_flash_train(torch)
    lap("6 (kernels C, D, E)")
    grad = phase_grad_check(torch)
    lap("7 (DiT gradient)")
    train = phase_train(torch)  # sets the counts to 0 just before its Trainer run
    lap("8 (DiT training)")
    print(f"summary: grad check {grad}; training {train}", flush=True)

    seg_rows, seg_err = phase_flash_seg(torch)
    lap("9 (kernel F, two-segment C, D, E)")
    full = phase_full_width_backbones(torch)  # counts set to 0 before each card forward
    lap("10 (MMDiT, UNetT forwards)")
    mm_grad = phase_mmdit_grad(torch)  # likewise
    lap("11 (MMDiT gradient)")
    e2tts = phase_e2e_backbone(torch, "E2TTS_Base", [("short", SHORT_TEXT),
                                                     ("long", LONG_TEXT)])
    mmdit = phase_e2e_backbone(torch, "F5TTS_MMDiT_Base", [("short", SHORT_TEXT)])
    lap("12 (E2TTS, MMDiT serving)")
    e2tts_train = phase_train_e2tts(torch)
    lap("13 (E2TTS training)")
    print(f"summary: full-width {full}; MMDiT gradient {mm_grad}; E2TTS serving {e2tts}; MMDiT "
          f"serving {mmdit}; E2TTS training {e2tts_train}", flush=True)

    int8_rows, int8_abs, int8_rel, lin_abs = phase_int8(torch)
    lap("14 (kernel G)")
    w8a8 = phase_w8a8_serving(torch)  # counts set to 0 before each timed request
    lap("15 (W8A8 serving)")
    w8a8_full = phase_w8a8_full_width(torch)
    lap("16 (W8A8 forward)")
    h_rows, h_err, i_row, i_err = phase_experiments(torch)
    lap("17 (kernels H, I)")
    print(f"summary: W8A8 serving {w8a8}; W8A8 full-width {w8a8_full}", flush=True)
    # the card and the build again, where the end of a long output still shows them
    print(f"card: {smi}; kernels built in {LIBRARY.build_seconds or 0.0:.1f} s; phases done in "
          f"{time.perf_counter() - t_start:.1f} s after the build", flush=True)

    def entry(name, source, replaces, launches, err, rows, config):
        r = next(r for r in rows if r["n"] == 1024)  # the 1024-frame bucket
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": err, "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"], "shape_n": 1024, "config": list(config),
                "over_library": r["over_library"], "configs_ms": r["configs_ms"]}

    def train_entry(name, key, plain, lib, replaces, launches, source):
        r = next(r for r in train_rows if r["n"] == 1024 and r["b"] == 2)
        out = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "launches": launches, "max_abs_err": train_err[key], "ms": r[key],
               "plain_ms": r[plain], "bound_ms": r["bounds"][key][0],
               "bound_by": r["bounds"][key][1], "library_ms": r[lib], "shape_n": 1024,
               "err_kind": "abs" if key == "C" else "relative to max |reference|",
               "plain_covers": "dq+dk+dv" if key != "C" else "o+L",
               "library_covers": "sdpa forward" if key == "C" else "sdpa backward (dq+dk+dv)"}
        big = next(r for r in train_rows if r["b"] == TRAIN_B)
        if key == "C":  # the training shape and the tile configurations
            out.update(config=list(FA.FWD_CONFIG), over_library=r["C_over_lib"],
                       training_shape=[TRAIN_B, 16, 1024, 64], training_ms=big["C"],
                       training_bound_ms=big["bounds"]["C"][0], training_library_ms=big["C_lib"],
                       training_over_library=big["C_over_lib"],
                       training_configs_ms=big["C_configs"])
        else:  # D, E: likewise
            out.update(config=list(FA.DQ_CONFIG if key == "D" else FA.DKV_CONFIG),
                       de_over_library=r["DE_over_lib"],
                       training_shape=[TRAIN_B, 16, 1024, 64], training_ms=big[key],
                       training_bound_ms=big["bounds"][key][0],
                       training_library_ms=big["DE_lib"],
                       training_de_over_library=big["DE_over_lib"],
                       training_configs_ms=big[f"{key}_configs"])
        return out

    from f5_tts_tpu_torch.ops import flash_attention as FA

    from f5_tts_tpu_torch.ops import fused_convpos as FC

    fa = "f5_tts_tpu_torch/csrc/flash_attention.cu"
    fab = "f5_tts_tpu_torch/csrc/flash_attention_bwd.cu"
    kernels = [
        entry("flash_attention_fwd", fa, "f5_tts_tpu/ops/flash_attention.py:150", launches_a,
              flash_err, flash_rows, FA.FWD_CONFIG),
        entry("fused_convpos_fwd", "f5_tts_tpu_torch/csrc/fused_convpos.cu",
              "f5_tts_tpu/ops/fused_convpos.py:37", launches_b, conv_err, conv_rows, FC.CONFIG),
        train_entry("flash_attention_fwd_stats", "C", "C_plain", "C_lib",
                    "f5_tts_tpu/ops/flash_attention.py:45", train["launches"]["C"], fa),
        train_entry("flash_attention_bwd_dq", "D", "DE_plain", "DE_lib",
                    "f5_tts_tpu/ops/flash_attention.py:81", train["launches"]["D"], fab),
        train_entry("flash_attention_bwd_dkv", "E", "DE_plain", "DE_lib",
                    "f5_tts_tpu/ops/flash_attention.py:112", train["launches"]["E"], fab),
    ]
    def seg_entry(name, key, plain, lib, replaces, launches, row, err_kind):
        r = seg_rows[row]
        return {"name": name, "route": "cuda", "source": fa if key in "FC" else fab,
                "replaces": replaces, "launches": launches, "max_abs_err": seg_err[key],
                "ms": r[key], "plain_ms": r[plain], "bound_ms": r["bounds"][key][0],
                "bound_by": r["bounds"][key][1], "library_ms": r[lib],
                "shape": [r["b"], 16, r["n"], 64], "seg": r["seg"], "err_kind": err_kind,
                **({"de_over_library": r["DE_over_lib"]} if key in "DE" else
                   {"config": list(FA.FWD_CONFIG), "over_library": r[f"{key}_over_lib"],
                    "configs_ms": r[f"{key}_configs"]}),
                "launches_from": "F5TTS_MMDiT_Base masked forward" if key == "F"
                else "F5TTS_MMDiT_Base masked gradient"}

    kernels += [
        seg_entry("flash_attention_fwd_seg", "F", "F_plain", "F_lib",
                  "f5_tts_tpu/ops/flash_attention.py:463", full["mmdit"]["launches"]["F"],
                  "serving", "abs"),
        seg_entry("flash_attention_fwd_stats_seg", "C", "C_plain", "F_lib",
                  "f5_tts_tpu/ops/flash_attention.py:45", mm_grad["launches"]["C_seg"],
                  "training", "abs"),
        seg_entry("flash_attention_bwd_dq_seg", "D", "DE_plain", "DE_lib",
                  "f5_tts_tpu/ops/flash_attention.py:81", mm_grad["launches"]["D_seg"],
                  "training", "relative to max |reference|"),
        seg_entry("flash_attention_bwd_dkv_seg", "E", "DE_plain", "DE_lib",
                  "f5_tts_tpu/ops/flash_attention.py:112", mm_grad["launches"]["E_seg"],
                  "training", "relative to max |reference|"),
    ]
    g = next(r for r in int8_rows if (r["m"], r["k"], r["n"]) == (1024, 1024, 4096))
    g_shapes = {f"{r['m']}x{r['k']}x{r['n']}": {
        key: r[key] for key in ("split", "ms", "two_launch_ms", "row_ms", "tpu_ms", "bound_ms",
                                "tpu_bound_ms", "library_ms", "unfused_ms", "dense_bf16_ms",
                                "host_us")}
        for r in int8_rows if r["m"] == 1024}
    from f5_tts_tpu_torch.scripts import exp_pipelined_flash as XH

    h = h_rows[1024]
    h_key = "H_" + "x".join(map(str, XH.CONFIG))
    g8 = "f5_tts_tpu_torch/csrc/int8_matmul.cu"
    kernels += [
        {"name": "int8_linear", "route": "cuda", "source": g8,
         "replaces": "f5_tts_tpu/ops/quant.py:35", "launches": w8a8["launches_per_call"]["G"],
         "max_abs_err": lin_abs, "err_kind": "against the plain composition on the card "
                                             "(0 when bitwise, as phase 14 requires)",
         "ms": g["ms"], "plain_ms": g["plain_ms"], "bound_ms": g["bound_ms"],
         "bound_by": g["bound_by"], "library_ms": g["unfused_ms"],
         "library_covers": "quantize_rows + torch._int_mm + the scale epilogue + cast + bias",
         "shape_mkn": [1024, 1024, 4096], "split": g["split"],
         "two_launch_ms": g["two_launch_ms"], "dense_bf16_linear_ms": g["dense_bf16_ms"],
         "serving_shapes": g_shapes,
         "ms_kind": "device time (CUDA-graph replay), as every time in this line",
         "launches_from": "one W8A8 F5TTS_v1_Base engine call, NFE 32"},
        {"name": "int8_matmul", "route": "cuda", "source": g8,
         "replaces": "f5_tts_tpu/ops/quant.py:35", "launches": w8a8["launches_per_call"]["G_tpu"],
         "on_serving_path": False,
         "launches_note": "the TPU kernel's own function (int8 in, fp32 out); serving runs "
                          "int8_linear, so this instance launches only for quantized_linear and "
                          "direct int8_matmul calls",
         "max_abs_err": int8_abs, "max_rel_err": int8_rel, "ms": g["tpu_ms"],
         "plain_ms": g["tpu_plain_ms"], "bound_ms": g["tpu_bound_ms"],
         "bound_by": g["tpu_bound_by"],
         "library_ms": g["library_ms"], "shape_mkn": [1024, 1024, 4096],
         "library_covers": "torch._int_mm + the scale epilogue",
         "launches_from": "one W8A8 F5TTS_v1_Base engine call, NFE 32"},
        {"name": "flash_attention_pipelined", "route": "cuda",
         "source": "f5_tts_tpu_torch/csrc/flash_attention_pipelined.cu",
         "replaces": "scripts/exp_pipelined_flash.py:24",
         "launches": w8a8["launches_per_call"]["H"], "experiment": True,
         "launches_from": "one W8A8 F5TTS_v1_Base engine call, NFE 32",
         "max_abs_err": h_err, "ms": h[h_key], "plain_ms": h["plain"],
         "bound_ms": h["bound_ms"], "bound_by": h["bound_by"], "library_ms": h["sdpa"],
         "kernel_a_ms": h["A"], "config": list(XH.CONFIG),
         "configs_ms": {str(n): {k: v for k, v in r.items() if k.startswith("H_")}
                        for n, r in h_rows.items()},
         "shape": [2, 16, 1024, 64], "lens": [1024, 824],
         "n4096": {"lens": [4096, 4059], "ms": h_rows[4096][h_key],
                   "plain_ms": h_rows[4096]["plain"], "bound_ms": h_rows[4096]["bound_ms"],
                   "library_ms": h_rows[4096]["sdpa"], "kernel_a_ms": h_rows[4096]["A"]},
         "ptxas": h_ptxas},
        {"name": "fused_ln_matmul", "route": "cuda",
         "source": "f5_tts_tpu_torch/csrc/fused_ln_matmul.cu",
         "replaces": "scripts/exp_fused_ln_matmul.py:27",
         "launches": w8a8["launches_per_call"]["I"], "experiment": True,
         "launches_from": "one W8A8 F5TTS_v1_Base engine call, NFE 32",
         "max_abs_err": i_err, "err_kind": "relative to max |reference|", "ms": i_row["ms"],
         "plain_ms": i_row["plain_ms"], "bound_ms": i_row["bound_ms"],
         "bound_by": i_row["bound_by"], "library_ms": i_row["library_ms"],
         "library_covers": "F.layer_norm + modulate + torch.addmm (unfused)",
         "shape_mkn": [2048, 1024, 3072],
         "by_k": {str(kk): {key: r[key] for key in ("ms", "library_ms", "bound_ms")}
                  for kk, r in i_row["by_k"].items()}},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
