#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA card.

Run from the repository root:  python3 chip_smoke.py

1. Prints the card's name and power limit, builds both CUDA kernels of the
   serving path from ``f5_tts_tpu_torch/csrc`` (nvcc, sm_90a).
2. Kernel A (masked flash attention) against its plain version at the
   F5TTS_v1_Base shapes [2, 16, n, 64] bf16, n in {256, 1000, 1024, 4096},
   ragged lens and a row with no valid key; times the kernel, the plain
   version and one ``scaled_dot_product_attention`` call (a yardstick the
   port never calls) beside the H100 bound.
3. Kernel B (fused ConvPositionEmbedding) likewise at [2, n, 1024] bf16,
   16 groups; the yardstick is the cuDNN grouped-conv composition.
4. One full-width F5TTS_v1_Base ``forward_cfg`` at n=256 in fp32, on the card
   through the kernels against the CPU through the plain versions.
5. End to end: ``F5TTS(model="F5TTS_v1_Base", init_random=True)`` in bf16,
   after one warm-up request, serves a short request, a long one that is
   chunked into a batch of rows, and a streamed one; checks the wavs and
   that every attention and ConvPositionEmbedding call of the run went
   through the kernels.
6. Prints the kernels' JSON line, then the result line.

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

# H100 SXM published peaks (dense): bf16 tensor cores, HBM3
PEAK_BF16 = 989e12
HBM_BPS = 3.35e12

REF_WAV = os.path.join(REPO, "examples", "assets", "basic_ref_en.wav")
REF_TEXT = "Some call me nature, others call me mother nature."
NFE = 32

# kernel vs plain tolerances (bf16 inputs; both kernels round to bf16 where
# the TPU kernels do: q, k, v and p for attention, the intermediate and the
# output for convpos); the plain versions compute in fp32 on the same values
FLASH_TOL = (2e-2, 2e-3)  # (max abs, mean abs), as tests/test_flash_attention.py
CONVPOS_TOL = (2e-2, 2e-3)
# full-width fp32 forward, card vs CPU: max abs error over the output's peak.
# Kernel B runs fp32 there; kernel A still rounds q, k, v, p to bf16 (2^-9
# relative), which the gated residual stream carries to the output damped
FULL_WIDTH_REL_TOL = 1e-3


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def timed_ms(torch, fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops: float, nbytes: float, peak: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak, nbytes / HBM_BPS
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def phase_flash(torch):
    from f5_tts_tpu_torch.ops import flash_attention as FA

    gen = torch.Generator(device="cuda").manual_seed(0)
    b, h, dh = 2, 16, 64
    rows, worst = [], 0.0
    for n in (256, 1000, 1024, 4096):
        q, k, v = (torch.randn((b, h, n, dh), generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        cases = [[n, n - 37]] + ([[0, n - 37]] if n == 1000 else [])
        for lens_l in cases:
            lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
            got = FA.flash_attention_cuda(q, k, v, lens)
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
        ms = timed_ms(torch, lambda: FA.flash_attention_cuda(q, k, v, lens), iters)
        plain_ms = timed_ms(torch, lambda: FA.flash_attention_plain(q.float(), k.float(),
                                                                    v.float(), lens), 3)
        keep = (torch.arange(n, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
        lib_ms = timed_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=keep), iters)
        flops = sum(4.0 * h * n * kv * dh for kv in (n, n - 37))
        nbytes = 4.0 * b * h * n * dh * 2 + 4 * b
        bms, by = bound_ms(flops, nbytes, PEAK_BF16)
        rows.append(dict(n=n, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
                         bound_by=by, flops=flops))
        print(f"flash_attention n={n}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"sdpa {lib_ms:.4f} ms, bound {bms:.4f} ms ({by}), "
              f"{flops / ms / 1e9:.1f} TFLOP/s", flush=True)
    return rows, worst


def phase_convpos(torch):
    from f5_tts_tpu_torch.ops import fused_convpos as FC

    gen = torch.Generator(device="cuda").manual_seed(1)
    b, d, groups, k = 2, 1024, 16, 31
    bound = (64 * k) ** -0.5  # torch's default conv init scale
    w1, w2 = ((torch.rand((d, 64, k), generator=gen, device="cuda") * 2 - 1) * bound
              for _ in range(2))
    b1, b2 = ((torch.rand((d,), generator=gen, device="cuda") * 2 - 1) * bound for _ in range(2))
    w1, w2, b1, b2 = (t.to(torch.bfloat16) for t in (w1, w2, b1, b2))
    rows, worst = [], 0.0
    for n in (256, 1000, 1024, 4096):
        x = torch.randn((b, n, d), generator=gen, device="cuda").to(torch.bfloat16)
        lens = torch.tensor([n, n - 37], dtype=torch.int32, device="cuda")
        got = FC.conv_pos_cuda(x, w1, b1, w2, b2, lens, groups)
        torch.cuda.synchronize()
        f32 = [t.float() for t in (x, w1, b1, w2, b2)]
        want = FC.conv_pos_plain(*f32, lens, groups)
        err = (got.float() - want).abs()
        max_err, mean_err = err.max().item(), err.mean().item()
        if not (max_err <= CONVPOS_TOL[0] and mean_err <= CONVPOS_TOL[1]):
            fail(f"convpos n={n}: max {max_err} mean {mean_err} > {CONVPOS_TOL}")
        worst = max(worst, max_err)
        iters = 20 if n <= 1024 else 5
        ms = timed_ms(torch, lambda: FC.conv_pos_cuda(x, w1, b1, w2, b2, lens, groups), iters)
        plain_ms = timed_ms(torch, lambda: FC.conv_pos_plain(*f32, lens, groups), 3)
        lib_ms = timed_ms(torch, lambda: FC.conv_pos_plain(x, w1, b1, w2, b2, lens, groups),
                          iters)
        flops = sum(2 * 2.0 * k * 64 * d * ln for ln in (n, n - 37))
        nbytes = 2.0 * b * n * d * 2 + 2 * (d * 64 * k + d) * 2 + 4 * b
        bms, by = bound_ms(flops, nbytes, PEAK_BF16)
        rows.append(dict(n=n, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
                         bound_by=by, flops=flops))
        print(f"fused_convpos n={n}: max_abs_err={max_err:.3e} mean_abs_err={mean_err:.3e} "
              f"(tol {CONVPOS_TOL}); kernel {ms:.4f} ms, plain(fp32) {plain_ms:.4f} ms, "
              f"cudnn bf16 {lib_ms:.4f} ms, bound {bms:.4f} ms ({by}), "
              f"{flops / ms / 1e9:.1f} TFLOP/s", flush=True)
    return rows, worst


def phase_full_width(torch):
    """F5TTS_v1_Base forward_cfg, fp32: card (kernels) vs CPU (plain)."""
    import copy

    from f5_tts_tpu_torch.models import dit as D
    from f5_tts_tpu_torch.models.configs import MODEL_CONFIGS

    cfg = MODEL_CONFIGS["F5TTS_v1_Base"].arch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = D.DiT(cfg).eval()
    D.randomize_zero_init(model, torch.Generator().manual_seed(2))
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

    from f5_tts_tpu_torch.ops import flash_attention as FA
    from f5_tts_tpu_torch.ops import fused_convpos as FC

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
    from f5_tts_tpu_torch.models.dit import randomize_zero_init
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
    short = "I don't really care what you call me."
    long = " ".join([
        "I've been a silent spectator, watching species evolve, empires rise and fall.",
        "But always remember, I am mighty and enduring.",
        "Respect me and I'll nurture you; ignore me and you shall face the consequences.",
        "The rivers carve the valleys, the winds shape the mountains, and the seasons turn.",
        "Every creature that walks, swims or flies is part of the story I keep telling.",
        "When you plant a tree, you speak my language; when you poison a river, I listen.",
        "Take only what you need, give back what you can, and the balance will hold.",
    ])

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
    for name, wall, audio_s, rows, n_calls in results:
        print(f"e2e {name}: {n_calls} engine call(s), {rows} row(s), {audio_s:.2f} s audio "
              f"in {wall:.2f} s wall, RTF {wall / audio_s:.4f}", flush=True)
    return a, c


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
    for line in LIBRARY.build_log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("  " + line.strip(), flush=True)

    flash_rows, flash_err = phase_flash(torch)
    conv_rows, conv_err = phase_convpos(torch)
    rel = phase_full_width(torch)
    if rel > FULL_WIDTH_REL_TOL:
        fail(f"full-width forward rel err {rel} > {FULL_WIDTH_REL_TOL}")
    launches_a, launches_b = phase_e2e(torch)

    def entry(name, source, replaces, launches, err, rows):
        r = next(r for r in rows if r["n"] == 1024)  # the 1024-frame bucket
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": err, "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"], "shape_n": 1024}

    kernels = [
        entry("flash_attention_fwd", "f5_tts_tpu_torch/csrc/flash_attention.cu",
              "f5_tts_tpu/ops/flash_attention.py:150", launches_a, flash_err, flash_rows),
        entry("fused_convpos_fwd", "f5_tts_tpu_torch/csrc/fused_convpos.cu",
              "f5_tts_tpu/ops/fused_convpos.py:37", launches_b, conv_err, conv_rows),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
