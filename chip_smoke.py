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
   after each request once (its first hit captures the engine's CUDA graph
   of its key; timed apart), serves a short request, a long one that is
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
    request, ``F5TTS(model="F5TTS_MMDiT_Base")`` a short one (bucket <= 1024),
    each after its first hit (the graph's capture, timed apart);
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
18. The serving surface.  The engine's CUDA graphs: a replay equals the
    module-level eager function bitwise in mel and int16 wav (F5TTS_v1_Base
    dense short request at bucket 512 and its chunked long form, W8A8 short,
    E2TTS_Base and F5TTS_MMDiT_Base short, these two at ``PAR_DEPTH``
    blocks); A's, B's and G's launches over three replays are three eager
    calls'; the short request eager against graph (wall, device time,
    kernel count, busy share; dense and W8A8).  At ``PAR_DEPTH`` blocks of
    F5TTS_v1_Base (for the script's time): ``warmup_all`` over
    buckets (512, 1024, 2048) x batches (1, 2, 4) with each capture's
    seconds and the graph pool's bytes, and the serving layers on the card:
    ``http_server.serve`` with a DynamicBatcher
    (max_batch 4) answers four concurrent ``request_tts`` calls in one
    batch, each equal to the same request alone (``GRAPH_WAV_TOL``); one
    request streamed through the socket server and client; ``cli.main`` on
    ``examples/basic.toml`` with ``--init_random``; a batcher closed with a
    request in flight resolves its future.
19. The BigVGAN vocoder path: F5TTS_Base with the bigvgan mel and BigVGAN v2
    at full width (seeded random weights) serves a short request at bucket
    512 and a chunked long one at 2048 from the engine's CUDA graphs, each
    replay bitwise the eager function, A's and B's launches over three
    replays three eager calls'; the short request's graph (wall, device
    time, kernels, busy share), its device time split into
    BigVGAN (the anti-aliased activations against the rest) and the DiT
    sampler; BigVGAN alone at 512 and 4096 frames (device time per decode
    as the engine runs it, cuDNN's TF32 default, and with TF32 off, the
    int16 difference between the two, the bound at the TF32 and the fp32
    peak); the bigvgan mel on the card against ``log_mel_np`` on the CPU
    (``BIGVGAN_MEL_TOL``); ``warmup_all`` over (512, 2048) x (1, 4) with the
    capture seconds and the pool's bytes.  The single-device Picard sampler
    on F5TTS_v1_Base at ``PAR_DEPTH`` blocks, W = 4: at tol 0
    as many sweeps as steps, the mel
    within ``PICARD_MEL_MAE_TOL`` of the sequential sampler, a replay
    bitwise the eager Picard call, depth A and one B launch per sweep; at
    tol 1e-3 and 1e-2 the sweeps, the wall and the mel against the
    sequential sampler.
20. The rest of single-device training, F5TTS_v1_Base at full width in
    mixed precision: the remat matrix (no remat, ``nothing``, ``dots``,
    ``flash``, ``dots_flash`` at 38,400 frames per update; ``flash`` and
    ``dots_flash`` at 76,800): the median update of 3 after a warm-up, valid frames/s, peak
    memory, and the launches of C, D, E and B per micro-step (C depth
    times under no remat, ``flash`` and ``dots_flash``, 2 x depth under
    ``nothing`` and ``dots``, or the phase fails; a cell out of memory
    prints ``OOM``), and the ``auto`` threshold that the matrix gives;
    each policy's loss gradient against no remat (``REMAT_GRAD_REL_TOL``);
    3 Adafactor updates and its state's bytes against AdamW's; one batch of
    the same audio as host mels and as int16 wavs with the mel on the card
    (loss within ``MEL_IN_GRAPH_LOSS_REL_TOL``, host collate ms of each),
    and one update from the wavs; how long the step loop waits at a
    full-width save, synchronous against the asynchronous writer (whose
    files must load equal to the snapshot); ``SPREAD_UPDATES`` updates on
    the sampler's batches with their wall and allocator counters.
21. The same updates in a child process with the caching allocator's
    expandable segments, against phase 20's: wall per update, allocator
    retries, ``cudaMalloc`` and ``cudaFree``.
22. The runtime layer, F5TTS_v1_Base with seeded weights, bf16, NFE 32:
    ``runtime.benchmark`` through the batch server (kernel A, 10 prompts at
    batch 1, then SDPA, 3 prompts; A's and B's launches per engine call,
    the timed pass's MFU against the H100 bf16 peak); ``bench_train`` at
    ``TRAIN_B`` x 1024 frames, bf16, no remat (frames/s, MFU); AOT bundles
    (``runtime/aot.py``) exported with weights W1 (dense wav and mel entry,
    W8A8 wav) and their kernels packaged, loaded with other weights W2: mel
    and int16 wav against the live engine on W2 (``AOT_MEL_TOL``,
    ``AOT_WAV_STEPS``; bitwise or not), the mel against W1's, and A's, B's
    and G's launches per call equal to the live engine's; then the cold
    start (``scripts/aot_coldstart_ab.py``): time to first audio of the
    bundle in a child process with no nvcc and an empty build directory
    (which must build no kernel and run no backbone ``forward``) against a
    cold live engine with the build cache.
23. Parallelism over the data, F5TTS_v1_Base at full width (the Trainer
    and BatchServer parts with ``PAR_DEPTH`` of its 22 blocks): ring
    attention's per-shard body at sp 2 and 4 on [2, 16, 4096, 64] bf16 with
    lengths {4096, 1500} (the rotation an index in one process), o and L
    against kernel C over all n and dq, dk, dv of a loss reading both
    against C + D + E (``RING_O_TOL``, ``RING_GRAD_TOL``), C, D and E sp^2
    times each; one process's Trainer update on a global batch of
    ``PAR_ROWS`` ragged rows, the same update through NCCL at world size 1
    (``Trainer(mesh=make_train_mesh(data=1), zero1=True)``, which resolves
    ZeRO-1 off at data size 1; within 1e-6), then two gloo ranks spawned on
    the one card: a data-parallel and a ZeRO-1 update against the one
    process (loss within ``PAR_LOSS_REL_TOL``, gradient norm within
    ``PAR_GNORM_REL_TOL``, AdamW's first moment, i.e. the summed clipped
    gradients, within ``PAR_GRAD_TOL`` per tensor, every parameter within
    ``PAR_PARAM_TOL``, the AdamW state's share per rank, B, C, D and E
    launches per rank) and
    ``BatchServer`` over data = 2 on 4 prompts against ``mesh=None`` (int16
    steps, A and B launches per rank).  Two ranks on one card share it:
    their wall is no scaling figure.
24. Parallelism over the model, F5TTS_v1_Base at full width and depth,
    seeded weights with the AdaLN gates and ``proj_out`` filled: one
    ``train_step`` of ``MP_ROWS`` x ``MP_N`` frames in fp32 in one process,
    the same step through NCCL at world size 1 with ``pipe=1, model=1``
    through the new code paths (``ModelLayout``, the pipeline's hook at one
    stage; bitwise), then two gloo ranks on the one card:
    ``BatchServer(mesh=make_mesh(data=1, model=2), tensor_parallel=True)``
    serving one short request at NFE 32 against the one-device engine
    (``MP_WAV_STEPS``, ``MP_MEL_MAE_TOL``; A 22 x 32 and B 32 launches per
    rank, 8 heads each) and ``enable_time_parallel(make_mesh(data=2))`` at
    W = 4, tol 0 against the one-device Picard engine (the same gates; A
    22 per sweep per rank, half the window's rows each); then four gloo
    ranks: the same ``train_step`` on ``make_train_mesh(data=1, pipe=2,
    model=2)`` with 2 microbatches (loss ``MP_LOSS_REL_TOL``, gradient norm
    ``MP_GNORM_REL_TOL``, AdamW's first moment ``PAR_GRAD_TOL`` per tensor;
    C, D, E 11 x 2 per rank) and two ``train/cli.py`` runs at ``PAR_DEPTH``:
    pp 2 x sp 2 on the ring and ZeRO-1 with Adafactor at data 2 x model 2
    (its state bytes per rank).  The ranks' collectives are gloo's, CUDA
    tensors staged through host memory, and the calls run eagerly: the
    ranks share one card, so no wall time of the phase is a scaling figure.
25. The tooling slice, F5TTS_v1_Base at full width and depth, seeded
    weights with the AdaLN gates and ``proj_out`` filled: one Picard AOT
    bundle per ``picard_tol`` in ``TOOL_TOLS`` (W = 4, batch 1, bucket 512;
    wav and mel entries at tol 0, wav at 1e-3), exported with weights W1
    and served with W2
    against the live Picard engine on W2 (mel and int16 wav bitwise, equal
    sweeps, A and B launches equal to the live call's, A 22 and B 1 per
    sweep, no Python backbone forward at load or in a served call; export
    seconds, bundle bytes, the replayed wall of both); ``eval_infer_batch``
    on a seeded four-utterance seedtts list (NFE 32, batch 2): four wavs
    and ``rtf.txt``, each file bitwise what ``BatchServer(mesh=None)`` gives
    for the same requests, ``eval_infer_batch``'s own A and B launches depth x NFE
    and NFE per engine call, each capture's eager call counted; one seeded
    ECAPA-TDNN forward on the card against the CPU (cosine per embedding
    at least ``ECAPA_COS_MIN``); ``scripts/profile_request`` at bucket 512
    (assemble, upload, compute, fetch; device time under the profiler).
26. The narrow configurations and the last scripts: F5TTS_v1_Small
    (dh 64, 48-channel groups) serves one replayed request at NFE 32 (A 18
    per NFE step, B 0, a finite wav, no tap copies frozen); F5TTS_v1_Small
    and E2TTS_Small fp32 ``forward_cfg`` at n 256, card against CPU
    (``FULL_WIDTH_REL_TOL``; A depth, B 0); ``scripts/smoke.py --device
    cuda`` (F5TTS_Tiny: A, no B); ``bench_step_breakdown`` ``step`` (A, B),
    ``profile`` and ``profile_train 8 1024`` (B, C, D, E) with their kernel
    tables; the speak probe at ``--heads 2`` (``SPEAK_ARGS``: C, D, E
    depth per update, no B, A in its eval and engine pass, the JSON line,
    the weights file, a finite engine CER) and the Picard probe at
    ``--epochs 2`` (``PICARD_ARGS``: F5TTS_v1_Base at full width; B 1, C
    depth or 2 x depth, D and E depth per micro-step; at tol 1e-3 A depth
    and B 1 per sweep, sweeps at most NFE).
27. Prints the kernels' JSON line, then the result line.

Every time of a kernel, its plain version and its library yardstick is
device time per call, from CUDA-graph replays (``utils.device.device_ms``).
Any failed phase exits non-zero without the result line.  Weights are
random, made from fixed seeds.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# the H100 SXM's dense peaks, stated once in the package (utils/flops.py):
# bf16 and int8 on the tensor cores, TF32 tensor cores, fp32 outside them;
# and its HBM3 rate
from f5_tts_tpu_torch.utils.flops import H100_BF16_PEAK_FLOPS as PEAK_BF16  # noqa: E402
from f5_tts_tpu_torch.utils.flops import H100_FP32_PEAK_FLOPS as PEAK_FP32  # noqa: E402
from f5_tts_tpu_torch.utils.flops import H100_INT8_PEAK_OPS as PEAK_INT8  # noqa: E402
from f5_tts_tpu_torch.utils.flops import H100_TF32_PEAK_FLOPS as PEAK_TF32  # noqa: E402

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
# a request served in a concurrent batch against the same request alone, on
# the int16 wav scaled to [-1, 1]: tests/test_torch_slice.py's
# test_rows_are_batch_invariant_per_seed tolerance (a row computes alike in
# every batch of its shape, so the card gives 0)
GRAPH_WAV_TOL = 1e-4
# kernel I vs its plain version, relative to the largest reference value: the
# kernel rounds the product + bias once to bf16, the plain version (JAX
# xla_ref) rounds the product, then the sum
LN_MATMUL_TOL = (2e-2, 2e-3)
# full-width fp32 forward, card vs CPU: max abs error over the output's peak.
# Kernel B runs fp32 there; kernel A still rounds q, k, v, p to bf16 (2^-9
# relative), which the gated residual stream carries to the output damped
FULL_WIDTH_REL_TOL = 1e-3
# the bigvgan log-mel on the card (fp32 cuBLAS, no TF32) against the port's
# numpy log_mel_np on the CPU: max abs error in log units, where bins near
# the 1e-5 floor lose relative precision to cancellation
BIGVGAN_MEL_TOL = 1e-3
# Picard at tol 0 against the sequential sampler, bf16 on the card: the
# window runs W * 2b rows through each forward where the sequential sampler
# runs 2b, so cuBLAS may pick other kernels and the two round differently
# (not bitwise); generated-region mel MAE, a tenth of quant_ab's W8A8 gate
PICARD_MEL_MAE_TOL = MEL_MAE_GATE / 10
PICARD_W = 4


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


def _full_width_dit(torch, name: str = "F5TTS_v1_Base"):
    """(cfg, seeded DiT of configuration ``name`` on the CPU with its gates
    randomized, run(model, device) -> its fp32 forward_cfg output on fixed
    inputs)."""
    from f5_tts_tpu_torch.models import dit as D
    from f5_tts_tpu_torch.models.backbones import randomize_zero_init
    from f5_tts_tpu_torch.models.configs import MODEL_CONFIGS

    cfg = MODEL_CONFIGS[name].arch
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

    (ref_wav, ref_sr), ref_text = preprocess_ref_audio_text(REF_WAV, REF_TEXT, show_info=quiet)
    chunks = chunk_text(long, max_chars=200)

    def stream(seed):
        return list(infer_batch_process(eng, (ref_wav, ref_sr), ref_text, chunks, tts.vocab,
                                        tokenizer=tts.tokenizer, opts=PipelineOptions(seed=seed),
                                        streaming=True))

    # every request once first: the first call of each engine key captures its
    # CUDA graph (one eager call, then the capture; cuBLAS / cuDNN set-up too),
    # timed apart from the served requests
    for name, run in (("short", lambda: tts.infer(REF_WAV, REF_TEXT, short, show_info=quiet,
                                                  seed=1)),
                      ("long", lambda: tts.infer(REF_WAV, REF_TEXT, long, show_info=quiet,
                                                 seed=1)),
                      ("stream", lambda: stream(1))):
        graphs = len(eng.graphs)
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        print(f"e2e first hit {name}: {time.perf_counter() - t0:.2f} s wall, "
              f"{len(eng.graphs) - graphs} graph(s) captured", flush=True)
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

    before = len(calls)
    t0 = time.perf_counter()
    pieces = stream(7)
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
    for name, text in texts:  # the first hit of each key captures its CUDA graph
        t0 = time.perf_counter()
        tts.infer(REF_WAV, REF_TEXT, text, show_info=quiet, seed=1)
        torch.cuda.synchronize()
        print(f"e2e {model_name} first hit {name}: {time.perf_counter() - t0:.2f} s wall",
              flush=True)
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


# ---------------------------------------------------------------------------
# the serving surface: the engine's CUDA graphs and the serving layers

def _recorded_run(eng) -> list:
    """Wrap ``eng._run`` (one engine call: its graph's replay) to keep each
    call's (entry, args, decode, (mel, wav)) on the device."""
    calls = []
    inner = eng._run

    def run(entry, args, decode):
        out = inner(entry, args, decode)
        calls.append((entry, args, decode, out))
        return out

    eng._run = run
    return calls


def _eager(eng, entry, args, decode):
    """The module-level eager function on one engine call's inputs."""
    from f5_tts_tpu_torch.infer import engine as TE

    if entry == "wav":
        return TE.sample_and_decode_from_wav(eng.model.transformer, eng.vocoder, eng.model_cfg,
                                             eng.options, *args, args[-1].shape[1],
                                             decode=decode, vocoder_type=eng.vocoder_type)
    return TE.sample_and_decode(eng.model.transformer, eng.vocoder, eng.model_cfg, eng.options,
                                *args, decode=decode, vocoder_type=eng.vocoder_type)


def _check_replays(torch, tag, eng, calls) -> None:
    """Every recorded call (a graph replay) against the eager function on
    the same inputs and noise: bitwise in mel and int16 wav."""
    for entry, args, decode, (mel, wav) in calls:
        want_mel, want_wav = _eager(eng, entry, args, decode)
        mel_diff = (mel.float() - want_mel.float()).abs().max().item()
        wav_diff = (wav.int() - want_wav.int()).abs().max().item()
        print(f"graphs {tag}: replay vs eager, {entry} entry, b={args[0].shape[0]} "
              f"n={args[-1].shape[1]}: mel max |diff| {mel_diff}, int16 wav max |diff| "
              f"{wav_diff} (want bitwise)", flush=True)
        if not (torch.equal(mel, want_mel) and torch.equal(wav, want_wav)):
            fail(f"graphs {tag}: a replay differs from the eager call")


def _replay_launches(torch, tag, tts, n_replays: int = 3) -> dict:
    """A's, B's and G's launches over ``n_replays`` replays of the short
    request against ``n_replays`` times one eager call's."""
    eng = tts.engine
    quiet = lambda *a, **k: None  # noqa: E731
    calls = _recorded_run(eng)
    tts.infer(REF_WAV, REF_TEXT, SHORT_TEXT, show_info=quiet, seed=7)  # the key is warm
    del eng._run
    entry, args, decode, _ = calls[0]
    names = ("A", "B", "G")
    reset_counts()
    _eager(eng, entry, args, decode)
    eager = {k: counts()[k] for k in names}
    reset_counts()
    for _ in range(n_replays):
        tts.infer(REF_WAV, REF_TEXT, SHORT_TEXT, show_info=quiet, seed=7)
    torch.cuda.synchronize()
    replayed = {k: counts()[k] for k in names}
    print(f"graphs {tag}: launches over {n_replays} replays {replayed}, one eager call "
          f"{eager}", flush=True)
    if any(replayed[k] != n_replays * eager[k] for k in names) or not eager["A"] \
            or not eager["B"]:
        fail(f"graphs {tag}: replays did not count {n_replays} x one eager call's launches")
    return dict(eager=eager, replays=n_replays, replayed=replayed)


def _eager_vs_graph(torch, tag, tts, reps: int = 3, modes=("eager", "graph")) -> dict:
    """The short request served eagerly (the engine's call swapped for the
    module-level function, here only) and through its graph: median wall of
    ``reps`` runs, then device time, kernel count and busy share from one
    profiled run; the graph's replay alone by CUDA events."""
    import statistics

    eng = tts.engine
    quiet = lambda *a, **k: None  # noqa: E731

    def run():
        tts.infer(REF_WAV, REF_TEXT, SHORT_TEXT, show_info=quiet, seed=7)
        torch.cuda.synchronize()

    out = {}
    for mode in modes:
        if mode == "eager":
            eng._run = lambda entry, args, decode: _eager(eng, entry, args, decode)
        run()
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            run()
            walls.append(time.perf_counter() - t0)
        wall_ms = statistics.median(walls) * 1e3
        prof = _profile_update(torch, run, f"one {tag} short request, {mode} (device only)",
                               host=False)
        if mode == "eager":
            del eng._run
        out[mode] = dict(wall_ms=wall_ms, walls_ms=[w * 1e3 for w in walls],
                         device_ms=prof["device_ms"], kernels=prof["kernels"],
                         busy=prof["device_ms"] / wall_ms)
    calls = _recorded_run(eng)
    run()
    del eng._run
    entry, args, decode, _ = calls[0]
    key = (entry, args[0].shape[0], args[-1].shape[1],
           args[0].shape[1] if entry == "wav" else None, decode, eng.dtype, eng.options,
           eng.parallel_hooks)
    graph = eng.graphs[key].graph
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    out["graph"]["replay_event_ms"] = start.elapsed_time(end) / reps
    for mode, r in out.items():
        print(f"graphs {tag} short request {mode}: wall {r['wall_ms']:.1f} ms (median of "
              f"{reps}: {', '.join(f'{w:.1f}' for w in r['walls_ms'])}), device {r['device_ms']:.1f} "
              f"ms, {r['kernels']} kernels, busy {r['busy']:.1%}"
              + (f", one replay by events {r['replay_event_ms']:.1f} ms" if mode == "graph"
                 else ""), flush=True)
    return out


def _serving_layers(torch, tts) -> dict:
    """``http_server.serve`` on 127.0.0.1 with a DynamicBatcher (max_batch
    4, a window that holds all four) answers four concurrent ``request_tts``
    calls; the socket server streams one request to the client;
    ``cli.main`` runs ``examples/basic.toml`` with ``--init_random``; a
    batcher closed with a request in flight resolves its future."""
    import shutil
    import socket
    import tempfile
    import threading

    import numpy as np

    from f5_tts_tpu_torch.audio.io import load_wav
    from f5_tts_tpu_torch.audio.preprocess import preprocess_ref_audio_text
    from f5_tts_tpu_torch.infer import batcher as B
    from f5_tts_tpu_torch.infer import cli
    from f5_tts_tpu_torch.infer import http_server as H
    from f5_tts_tpu_torch.infer import pipeline as P
    from f5_tts_tpu_torch.infer import socket_client as SC
    from f5_tts_tpu_torch.infer import socket_server as SS

    quiet = lambda *a, **k: None  # noqa: E731
    eng = tts.engine
    out = {}
    texts = ["I don't really care what you call me.", "The rivers carve the valleys slowly.",
             "Take only what you need, give back.", "Every creature is part of the story."]
    seeds = [100 + i for i in range(len(texts))]
    ref, ref_text = preprocess_ref_audio_text(REF_WAV, REF_TEXT, show_info=quiet)
    # each request alone, padded to the four rows of the concurrent round's
    # batch: one graph computes every row of a batch shape alike, so a row
    # alone equals it batched (this also warms that key)
    alone = B.DynamicBatcher(eng, max_batch=4, batch_sizes=(4,), queue_delay_ms=0.0)
    want = [P.infer_process(B.BatchedEngine(alone), ref, ref_text, t, tts.vocab,
                            tokenizer=tts.tokenizer, opts=P.PipelineOptions(seed=s),
                            show_info=quiet)[0] for t, s in zip(texts, seeds)]
    alone.close()
    want = [(np.clip(w, -1, 1) * 32767).astype("<i2").astype(np.float32) / 32767.0 for w in want]

    box, ready = {}, threading.Event()

    def on_ready(server):
        box["server"] = server
        ready.set()

    reset_counts()
    th = threading.Thread(target=H.serve, args=(tts, REF_WAV, REF_TEXT, "127.0.0.1", 0),
                          kwargs=dict(max_batch=4, queue_delay_ms=2000.0, ready=on_ready),
                          daemon=True)
    th.start()
    if not ready.wait(120):
        fail("http: the server did not start")
    server = box["server"]
    port = server.server_address[1]
    got, errors = [None] * len(texts), []

    def client(i):
        try:
            got[i] = H.request_tts(texts[i], "127.0.0.1", port, seed=seeds[i])
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(repr(e))

    t0 = time.perf_counter()
    clients = [threading.Thread(target=client, args=(i,)) for i in range(len(texts))]
    for c in clients:
        c.start()
    for c in clients:
        c.join(timeout=300)
    wall = time.perf_counter() - t0
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", "/stats")
    stats = json.loads(conn.getresponse().read())
    conn.close()
    server.shutdown()
    th.join(timeout=120)
    if errors or any(g is None for g in got):
        fail(f"http: requests failed: {errors}")
    if tts.engine is not eng:
        fail("http: the server did not give the F5TTS its engine back")
    diffs = [float(np.abs(w - g[0]).max()) if len(w) == len(g[0]) else float("inf")
             for w, g in zip(want, got)]
    print(f"http: 4 concurrent requests in {wall:.2f} s wall, batcher stats {stats}; each wav "
          f"against the same request alone (max |diff| {diffs}, tolerance {GRAPH_WAV_TOL}: "
          f"tests/test_torch_slice.py::test_rows_are_batch_invariant_per_seed)", flush=True)
    if stats.get("batches") != 1 or stats.get("avg_batch_size") != 4:
        fail(f"http: the four requests did not share one batch: {stats}")
    if any(g[1] != 24000 for g in got) or max(diffs) > GRAPH_WAV_TOL:
        fail("http: a batched request differs from the same request alone")
    out["http"] = dict(wall_s=wall, stats=stats, max_diff=max(diffs))

    proc = SS.TTSStreamingProcessor(tts, REF_WAV, REF_TEXT)
    sock = SS.listen("127.0.0.1", 0)
    th = threading.Thread(target=SS.serve_socket, args=(sock, proc), daemon=True)
    th.start()
    t0 = time.perf_counter()
    try:
        streamed = SC.listen_to_f5tts(LONG_TEXT[:200], "127.0.0.1", sock.getsockname()[1])
    finally:
        sock.shutdown(socket.SHUT_RDWR)
        sock.close()
        th.join(timeout=60)
    wall = time.perf_counter() - t0
    print(f"socket: streamed {len(streamed) / 24000:.2f} s of audio in {wall:.2f} s wall",
          flush=True)
    if not len(streamed) or not np.isfinite(streamed).all() or th.is_alive():
        fail("socket: no finite stream, or the server did not stop")
    out["socket"] = dict(wall_s=wall, audio_s=len(streamed) / 24000)
    launched = counts()
    print(f"serving layers launches: A {launched['A']}, B {launched['B']} (through the "
          "engine's graphs)", flush=True)
    if not launched["A"] or not launched["B"]:
        fail("serving layers: the attention or ConvPositionEmbedding kernel never launched")
    out["launches"] = launched

    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        t0 = time.perf_counter()
        path = cli.main(["-c", os.path.join(REPO, "examples", "basic.toml"), "--init_random",
                         "--output_dir", tmp, "--output_file", "cli.wav"])
        wall = time.perf_counter() - t0
        wav, sr = load_wav(path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"cli: examples/basic.toml --init_random: {len(wav) / sr:.2f} s of audio in "
          f"{wall:.2f} s wall (model build and first-hit captures included)", flush=True)
    if sr != 24000 or not len(wav) or not np.isfinite(wav).all():
        fail("cli: no finite wav")
    out["cli"] = dict(wall_s=wall, audio_s=len(wav) / sr)
    torch.cuda.empty_cache()

    batcher = B.DynamicBatcher(eng, max_batch=4, queue_delay_ms=50.0)
    ids = P.text_to_ids([REF_TEXT + " " + SHORT_TEXT], tts.vocab, tts.tokenizer)[0]
    fut = batcher.submit(ids[ids != -1], 400, seed=3, ref_wav=ref[0])
    batcher.close()
    if not fut.done():
        fail("batcher: close() left an in-flight request's future pending")
    state = "failed: " + repr(fut.exception()) if fut.exception() else "resolved"
    try:
        batcher.submit(ids, 400, seed=3, ref_wav=ref[0])
    except RuntimeError:
        pass
    else:
        fail("batcher: a submit after close() was taken")
    print(f"batcher: close() with a request in flight: its future {state}; a later submit "
          "raises", flush=True)
    out["close"] = state
    return out


def phase_graphs(torch):
    """The engine's CUDA graphs: replays bitwise equal to the eager
    function (F5TTS_v1_Base dense short and chunked long, W8A8 short,
    E2TTS_Base and F5TTS_MMDiT_Base short), launch counts through replays,
    the short request eager against graph (dense, W8A8), then, at
    ``PAR_DEPTH`` blocks, ``warmup_all`` over buckets (512, 1024, 2048) x
    batches (1, 2, 4) and the serving layers on the card."""
    from f5_tts_tpu_torch.infer.api import F5TTS
    from f5_tts_tpu_torch.models.backbones import randomize_zero_init
    from f5_tts_tpu_torch.models.configs import MODEL_CONFIGS

    quiet = lambda *a, **k: None  # noqa: E731
    out = {}
    tts = F5TTS(model="F5TTS_v1_Base", init_random=True, nfe_step=NFE)
    randomize_zero_init(tts.engine.model.transformer, torch.Generator().manual_seed(4))
    dense = tts.engine
    calls = _recorded_run(dense)
    tts.infer(REF_WAV, REF_TEXT, SHORT_TEXT, show_info=quiet, seed=7)  # first hit: captures
    tts.infer(REF_WAV, REF_TEXT, SHORT_TEXT, show_info=quiet, seed=7)
    tts.infer(REF_WAV, REF_TEXT, LONG_TEXT, show_info=quiet, seed=7)
    del dense._run
    if calls[0][1][-1].shape[1] != 512 or max(c[1][0].shape[0] for c in calls) < 2:
        fail(f"graphs: want a short request at bucket 512 and a chunked long one (b >= 2), got "
             f"{[(c[1][0].shape[0], c[1][-1].shape[1]) for c in calls]}")
    _check_replays(torch, "F5TTS_v1_Base dense", dense, calls)
    out["dense_launches"] = _replay_launches(torch, "F5TTS_v1_Base dense", tts)
    out["dense_short"] = _eager_vs_graph(torch, "F5TTS_v1_Base dense", tts)

    quant = _quantized_engine(torch, tts)
    tts.engine = quant
    calls = _recorded_run(quant)
    tts.infer(REF_WAV, REF_TEXT, SHORT_TEXT, show_info=quiet, seed=7)
    del quant._run
    _check_replays(torch, "F5TTS_v1_Base W8A8", quant, calls)
    out["w8a8_launches"] = _replay_launches(torch, "F5TTS_v1_Base W8A8", tts)
    out["w8a8_short"] = _eager_vs_graph(torch, "F5TTS_v1_Base W8A8", tts)
    del tts, dense, quant, calls
    torch.cuda.empty_cache()

    # warmup_all and the serving layers exercise the engine's keys and the
    # servers around it, which do not depend on the depth: F5TTS_v1_Base at
    # full width with PAR_DEPTH of its 22 blocks, to leave the script's time
    # to phase 24
    tts = F5TTS(model="F5TTS_v1_Base", init_random=True, nfe_step=NFE,
                model_cfg=_shallow(MODEL_CONFIGS["F5TTS_v1_Base"]))
    randomize_zero_init(tts.engine.model.transformer, torch.Generator().manual_seed(4))
    dense = tts.engine
    before = set(dense.graphs)
    t0 = time.perf_counter()
    dense.warmup_all(buckets=(512, 1024, 2048), batch_sizes=(1, 2, 4))
    wall = time.perf_counter() - t0
    # warmup_all's keys: its ref wav is a quarter of each bucket, so S is the
    # ref-length bucket of n // 4 + 1 frames; the short request's key may be
    # one of them, captured at its first hit above
    from f5_tts_tpu_torch.infer.engine import pick_bucket

    hop, n_fft = dense.hop, dense.model_cfg.mel.n_fft
    want = {(b, n, pick_bucket(n // 4 + 1) * hop + n_fft) for b in (1, 2, 4)
            for n in (512, 1024, 2048)}
    warm = [(k, g) for k, g in dense.graphs.items() if k[0] == "wav" and k[1:4] in want]
    pool = dense.graph_pool_bytes()
    for k, g in warm:
        print(f"graphs warmup_all: b={k[1]} n={k[2]} S={k[3]} captured in {g.seconds:.2f} s"
              + ("" if k not in before else " (at an earlier request's first hit)"), flush=True)
    print(f"graphs warmup_all: {len(set(dense.graphs) - before)} graphs captured in {wall:.1f} s; "
          f"the engine's {len(dense.graphs)} graphs hold {pool / 2**30:.2f} GiB in their pool",
          flush=True)
    if len(warm) != 9:
        fail(f"graphs warmup_all: {len(warm)} graphs of its (bucket, batch) pairs, want 9")
    out["warmup_all"] = dict(wall_s=wall, pool_bytes=pool, graphs=len(dense.graphs),
                             capture_s={f"b{k[1]}_n{k[2]}_S{k[3]}": g.seconds for k, g in warm})

    out["serving"] = _serving_layers(torch, tts)
    del tts, dense
    torch.cuda.empty_cache()

    for name in ("E2TTS_Base", "F5TTS_MMDiT_Base"):  # replay vs eager: PAR_DEPTH blocks
        tts = F5TTS(model=name, init_random=True, nfe_step=NFE,
                    model_cfg=_shallow(MODEL_CONFIGS[name]))
        randomize_zero_init(tts.engine.model.transformer, torch.Generator().manual_seed(36))
        calls = _recorded_run(tts.engine)
        tts.infer(REF_WAV, REF_TEXT, SHORT_TEXT, show_info=quiet, seed=7)
        del tts.engine._run
        if calls[0][1][-1].shape[1] > 1024:
            fail(f"graphs {name}: the short request is above bucket 1024")
        _check_replays(torch, name, tts.engine, calls)
        del tts, calls
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the BigVGAN vocoder path, the bigvgan mel and the single-device Picard sampler

def bigvgan_work(cfg, n_frames: int) -> dict:
    """Multiply-adds of one BigVGAN decode of ``n_frames`` mel frames, from
    the config's shapes: the dense convs (conv_pre, the transposed-conv
    upsamples, the AMP blocks' convs, conv_post) and the anti-aliased
    activations' grouped 12-tap filters (~12 multiply-adds per channel and
    sample up, 12 down), with the activations' input elements."""
    t, ch = n_frames, cfg.upsample_initial_channel
    convs, acts, elems = ch * cfg.num_mels * 7 * t, 0, 0
    for r, k in zip(cfg.upsample_rates, cfg.upsample_kernel_sizes):
        convs += ch * (ch // 2) * k * t
        ch, t = ch // 2, t * r
        for rk, dil in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
            convs += len(dil) * 2 * ch * ch * rk * t
            acts += len(dil) * 2 * 24 * ch * t
            elems += len(dil) * 2 * ch * t
    acts, elems = acts + 24 * ch * t, elems + ch * t  # activation_post
    return dict(conv_macs=convs + ch * 7 * t, act_macs=acts, act_elems=elems)


def _bigvgan_bound(voc, n_frames: int) -> dict:
    """The least time of one decode on an H100 SXM: the
    bytes it must move (weights, the mel, the wav; fp32) over HBM, the dense
    convs over the fp32 (67 TFLOP/s) or the TF32 (495) tensor-core peak,
    and the activations' filters over the fp32 peak (no tensor-core path);
    the largest of the three."""
    w = bigvgan_work(voc.cfg, n_frames)
    nbytes = 4 * (sum(p.numel() for p in voc.parameters()) + n_frames * (voc.cfg.num_mels + 256))
    t_bytes = nbytes / HBM_BPS * 1e3
    t_act = 2 * w["act_macs"] / PEAK_FP32 * 1e3
    out = dict(w, bytes=nbytes)
    for name, peak in (("fp32", PEAK_FP32), ("tf32", PEAK_TF32)):
        t_conv = 2 * w["conv_macs"] / peak * 1e3
        ms = max(t_bytes, t_conv, t_act)
        out[f"bound_ms_{name}"] = ms
        out[f"bound_by_{name}"] = ("bytes" if ms == t_bytes else "operations")
    return out


def _bigvgan_alone(torch, voc, n_frames: int, split: bool) -> dict:
    """One decode of ``n_frames`` frames (b = 1): device time as the engine
    runs it (cuDNN's TF32 default) and with TF32 off, the int16 wav's max
    difference between the two, the bound; with ``split``, the device time
    of the 109 anti-aliased activations alone at their shapes in that
    decode (the rest: the convs and the residual adds)."""
    from f5_tts_tpu_torch.models import bigvgan as BV
    from f5_tts_tpu_torch.utils.device import device_ms

    gen = torch.Generator(device="cuda").manual_seed(n_frames)
    mel = torch.randn((1, n_frames, 100), generator=gen, device="cuda") - 5.0
    decode = lambda: BV.decode(voc, mel)  # noqa: E731
    to_i16 = lambda w: (torch.clamp(w, -1.0, 1.0) * 32767.0).to(torch.int16)  # noqa: E731
    iters = 3 if n_frames <= 1024 else 1
    out = dict(n=n_frames, ms=device_ms(decode, iters), **_bigvgan_bound(voc, n_frames))
    wav = decode()
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        out["fp32_ms"] = device_ms(decode, iters)
        ref = decode()
    out["wav_rms"] = wav.float().square().mean().sqrt().item()
    out["clamped_share"] = (wav.abs() >= 1.0).float().mean().item()
    out["tf32_vs_fp32_i16_max"] = (to_i16(wav).int() - to_i16(ref).int()).abs().max().item()
    out["tf32_vs_fp32_max_abs"] = (wav - ref).abs().max().item()
    if split:
        inputs = []
        hooks = [a.register_forward_pre_hook(lambda m, a_: inputs.append((m, a_[0])))
                 for a in BV.activations(voc)]
        decode()
        for h in hooks:
            h.remove()
        out["activations"] = len(inputs)
        out["act_ms"] = device_ms(lambda: [m(x) for m, x in inputs], 1)
        del inputs
    print(f"bigvgan alone, n={n_frames}: {out['ms']:.3f} ms per decode (cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}, the engine's default), {out['fp32_ms']:.3f} ms "
          f"TF32 off; bound {out['bound_ms_tf32']:.3f} ms at "
          f"the TF32 peak, {out['bound_ms_fp32']:.3f} ms at the fp32 peak "
          f"({2 * out['conv_macs'] / 1e12:.3f} TFLOP of convs, {2 * out['act_macs'] / 1e9:.2f} "
          f"GFLOP of activation filters, {out['bytes'] / 1e6:.0f} MB); int16 wav TF32 vs off "
          f"max |diff| {out['tf32_vs_fp32_i16_max']} (float {out['tf32_vs_fp32_max_abs']:.2e}; "
          f"wav rms {out['wav_rms']:.3f}, clamped {out['clamped_share']:.1%})"
          + (f"; the {out['activations']} activations alone {out['act_ms']:.3f} ms "
             f"({out['act_ms'] / out['ms']:.1%})" if split else ""), flush=True)
    return out


def _bigvgan_mel_on_card(torch) -> dict:
    """The bigvgan log-mel on the card (``log_mel_prepadded``) against the
    port's numpy ``log_mel_np`` on the CPU, over the example clip."""
    import numpy as np

    from f5_tts_tpu_torch.audio.io import load_wav
    from f5_tts_tpu_torch.ops import mel as M

    cfg = M.MelConfig(mel_spec_type="bigvgan")
    wav, _ = load_wav(REF_WAV)
    pad = M.stft_pad_amount(cfg)
    padded = np.pad(np.pad(wav, pad, mode="reflect"), (0, 4096))[None].astype(np.float32)
    got = M.log_mel_prepadded(torch.from_numpy(padded).cuda(), cfg)
    k = M.num_frames(len(wav), cfg)
    want = M.log_mel_np(wav, cfg)
    err = float(np.abs(got[:, :k].cpu().numpy() - want).max())
    print(f"bigvgan mel on the card vs log_mel_np on the CPU: {k} frames, max |diff| {err:.2e} "
          f"(tolerance {BIGVGAN_MEL_TOL})", flush=True)
    if not err <= BIGVGAN_MEL_TOL:
        fail(f"bigvgan mel on the card: max |diff| {err} > {BIGVGAN_MEL_TOL}")
    return dict(frames=k, max_abs=err)


def _picard(torch, tts) -> dict:
    """F5TTS_v1_Base with the Picard sampler, W = 4: at tol 0 (sweeps ==
    steps, the mel against the sequential sampler, a replay against the
    eager Picard call bitwise, A and B launches per sweep), at tol 1e-3
    (JAX's default) and 1e-2 (sweeps, wall and mel against the sequential
    sampler)."""
    import dataclasses
    import statistics

    import numpy as np

    eng = tts.engine
    quiet = lambda *a, **k: None  # noqa: E731
    seq_opts = eng.options
    depth = tts.model_cfg.arch.depth

    def serve(opts, reps=0):
        """The short request under ``opts`` (first hit captures), then the
        median wall of ``reps`` more; the mel of its engine call."""
        eng.options = opts
        calls = _recorded_run(eng)
        tts.infer(REF_WAV, REF_TEXT, SHORT_TEXT, show_info=quiet, seed=7)
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            tts.infer(REF_WAV, REF_TEXT, SHORT_TEXT, show_info=quiet, seed=7)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        del eng._run
        return calls, (statistics.median(walls) * 1e3 if walls else None)

    out = {}
    seq_calls, seq_wall = serve(seq_opts, reps=3)
    seq_mel = seq_calls[0][3][0].float()
    for tol in (0.0, 1e-3, 1e-2):
        opts = dataclasses.replace(seq_opts, time_parallel_window=PICARD_W, picard_tol=tol)
        calls, wall = serve(opts, reps=3)
        sweeps = eng.last_sweeps
        entry, args, decode, (mel, wav) = calls[0]
        lens, dur = args[2], args[4]
        gen = (torch.arange(mel.shape[1], device=mel.device)[None, :] >= lens[:, None]) & \
            (torch.arange(mel.shape[1], device=mel.device)[None, :] < dur[:, None])
        mae = ((mel.float() - seq_mel).abs() * gen[..., None]).sum().item() / \
            (gen.sum().item() * mel.shape[-1])
        key = next(k for k in eng.graphs if k[-2] == opts)
        g = eng.graphs[key]
        r = dict(sweeps=sweeps, wall_ms=wall, seq_wall_ms=seq_wall, mel_mae_vs_seq=mae,
                 capture_s=g.seconds)
        print(f"picard F5TTS_v1_Base W={PICARD_W} tol={tol}: {sweeps} sweeps for {NFE} steps, "
              f"wall {wall:.1f} ms against {seq_wall:.1f} sequential (medians of 3), generated "
              f"mel MAE against the sequential sampler {mae:.4f}, capture {g.seconds:.2f} s",
              flush=True)
        if tol == 0.0:
            if sweeps != NFE:
                fail(f"picard at tol 0: {sweeps} sweeps, want {NFE}")
            if not mae <= PICARD_MEL_MAE_TOL:
                fail(f"picard at tol 0: generated-mel MAE {mae} against the sequential sampler "
                     f"> {PICARD_MEL_MAE_TOL}")
            _check_replays(torch, f"picard W={PICARD_W} tol 0", eng, calls[:1])
            reset_counts()
            tts.infer(REF_WAV, REF_TEXT, SHORT_TEXT, show_info=quiet, seed=7)
            torch.cuda.synchronize()
            c = counts()
            r["launches"] = {k: c[k] for k in ("A", "B")}
            print(f"picard: one replayed call launched A {c['A']} and B {c['B']} times over "
                  f"{eng.last_sweeps} sweeps (want {depth} A and 1 B per sweep)", flush=True)
            if c["A"] != depth * eng.last_sweeps or c["B"] != eng.last_sweeps:
                fail("picard: the sweeps' replays did not count their A and B launches")
        out[f"tol_{tol:g}"] = r
    eng.options = seq_opts
    return out


def phase_bigvgan(torch):
    """F5TTS_Base + BigVGAN v2 at full width on the engine's CUDA graphs (a
    short request at bucket 512, a chunked long one at 2048: replay vs
    eager, launches, wall / device / busy with the device time split into
    BigVGAN (and inside it the activations) and the rest); BigVGAN alone at
    512 and 4096 frames beside its bound, TF32 against fp32; the bigvgan mel
    on the card; ``warmup_all`` over (512, 2048) x (1, 4); Picard on
    F5TTS_v1_Base.  It runs under PyTorch's default, cuDNN's TF32 allowed,
    as a serving process has it (the earlier phases turn TF32 off for their
    fp32 references)."""
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
        return _phase_bigvgan(torch)


def _phase_bigvgan(torch):
    import dataclasses

    from f5_tts_tpu_torch.infer.api import F5TTS
    from f5_tts_tpu_torch.infer.engine import pick_bucket
    from f5_tts_tpu_torch.models.backbones import randomize_zero_init
    from f5_tts_tpu_torch.models.configs import MODEL_CONFIGS
    from f5_tts_tpu_torch.ops.mel import MelConfig

    quiet = lambda *a, **k: None  # noqa: E731
    out = {"mel": _bigvgan_mel_on_card(torch)}
    cfg = dataclasses.replace(MODEL_CONFIGS["F5TTS_Base"], mel=MelConfig(mel_spec_type="bigvgan"))
    t0 = time.perf_counter()
    tts = F5TTS(model="F5TTS_Base", model_cfg=cfg, init_random=True, nfe_step=NFE)
    eng = tts.engine
    randomize_zero_init(eng.model.transformer, torch.Generator().manual_seed(19))
    voc = eng.vocoder
    print(f"bigvgan: built F5TTS_Base + BigVGAN v2 ({sum(p.numel() for p in voc.parameters())} "
          f"vocoder parameters) in {time.perf_counter() - t0:.1f} s", flush=True)
    calls = _recorded_run(eng)
    t0 = time.perf_counter()
    tts.infer(REF_WAV, REF_TEXT, SHORT_TEXT, show_info=quiet, seed=7)  # first hit: captures
    first = time.perf_counter() - t0
    wav, sr, _ = tts.infer(REF_WAV, REF_TEXT, LONG_TEXT, show_info=quiet, seed=7)
    del eng._run
    shapes = [(c[1][0].shape[0], c[1][-1].shape[1]) for c in calls]
    print(f"bigvgan: engine calls (b, n) {shapes}; the short request's first hit {first:.2f} s; "
          f"long request {len(wav) / sr:.2f} s of audio", flush=True)
    if shapes[0][1] != 512 or max(b for b, _ in shapes) < 2 or max(n for _, n in shapes) != 2048:
        fail(f"bigvgan: want a short request at bucket 512 and a chunked long one at 2048, "
             f"got {shapes}")
    for _, args, _, (mel, w) in calls:
        if w.shape[1] != args[-1].shape[1] * 256 or not torch.isfinite(mel.float()).all():
            fail("bigvgan: a wav is not n * 256 samples long or a mel is not finite")
    _check_replays(torch, "F5TTS_Base + BigVGAN", eng, calls)
    out["launches"] = _replay_launches(torch, "F5TTS_Base + BigVGAN", tts)
    out["short"] = _eager_vs_graph(torch, "F5TTS_Base + BigVGAN", tts, modes=("graph",))
    del calls
    torch.cuda.empty_cache()

    alone = {n: _bigvgan_alone(torch, voc, n, split=n == 512) for n in (512, 4096)}
    out["alone"] = alone
    g = out["short"]["graph"]
    voc_ms = alone[512]["ms"]
    share = voc_ms / g["device_ms"]
    print(f"bigvgan: the short request replayed, {g['device_ms']:.1f} ms of device time: BigVGAN "
          f"{voc_ms:.1f} ms ({share:.1%}; its activations {alone[512]['act_ms']:.1f} ms, the convs "
          f"and the rest {voc_ms - alone[512]['act_ms']:.1f} ms), the DiT sampler, ref mel and "
          f"the rest {g['device_ms'] - voc_ms:.1f} ms; busy {g['busy']:.1%} of "
          f"{g['wall_ms']:.1f} ms wall", flush=True)
    out["split"] = dict(bigvgan_ms=voc_ms, share=share, act_ms=alone[512]["act_ms"],
                        rest_ms=g["device_ms"] - voc_ms)

    before = set(eng.graphs)
    t0 = time.perf_counter()
    eng.warmup_all(buckets=(512, 2048), batch_sizes=(1, 4))
    wall = time.perf_counter() - t0
    hop, n_fft = eng.hop, eng.model_cfg.mel.n_fft
    want = {(b, n, pick_bucket(n // 4 + 1) * hop + n_fft) for b in (1, 4) for n in (512, 2048)}
    warm = [(k, gr) for k, gr in eng.graphs.items() if k[0] == "wav" and k[1:4] in want]
    pool = eng.graph_pool_bytes()
    for k, gr in warm:
        print(f"bigvgan warmup_all: b={k[1]} n={k[2]} S={k[3]} captured in {gr.seconds:.2f} s"
              + ("" if k not in before else " (at an earlier request's first hit)"), flush=True)
    print(f"bigvgan warmup_all: {len(set(eng.graphs) - before)} graphs captured in {wall:.1f} s; "
          f"the engine's {len(eng.graphs)} graphs hold {pool / 2**30:.2f} GiB in their pool",
          flush=True)
    if len(warm) != 4:
        fail(f"bigvgan warmup_all: {len(warm)} graphs of its (bucket, batch) pairs, want 4")
    out["warmup_all"] = dict(wall_s=wall, pool_bytes=pool, graphs=len(eng.graphs),
                             capture_s={f"b{k[1]}_n{k[2]}": gr.seconds for k, gr in warm})
    del tts, eng, voc
    torch.cuda.empty_cache()

    # Picard's sweeps against the sequential sampler: PAR_DEPTH blocks of
    # F5TTS_v1_Base (the sweep count and the wall ratio run per block)
    from f5_tts_tpu_torch.models.configs import MODEL_CONFIGS

    tts = F5TTS(model="F5TTS_v1_Base", init_random=True, nfe_step=NFE,
                model_cfg=_shallow(MODEL_CONFIGS["F5TTS_v1_Base"]))
    randomize_zero_init(tts.engine.model.transformer, torch.Generator().manual_seed(4))
    out["picard"] = _picard(torch, tts)
    del tts
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the rest of single-device training: remat policies, Adafactor, in-graph
# mel, asynchronous checkpoint writes, the spread of updates

# per-update frame budgets of the remat matrix: configs/F5TTS_v1_Base.yaml's
# 38,400 (every policy) and twice it, where only the two policies that decide
# "auto" run.  Four times it (153,600, where only nothing and flash fit,
# PERF.md) is left out to keep the script's time down
REMAT_BUDGETS = (38_400, 76_800)
REMAT_POLICIES = ("none", "nothing", "dots", "flash", "dots_flash")
REMAT_MID_POLICIES = ("flash", "dots_flash")
# gradients of a remat policy against no remat, full width, mixed precision:
# relative L2 of the whole gradient (the recompute runs the same kernels on
# the same inputs, so 0 is expected; the limit allows one bf16 rounding flip)
REMAT_GRAD_REL_TOL = 1e-5
# one update's loss from a wav batch (int16 wire format, mel on the card)
# against the mel batch of the same audio (host mel, fp32): relative
MEL_IN_GRAPH_LOSS_REL_TOL = 1e-3
SPREAD_UPDATES = 20


def _remat_batch(torch, np, frames: int, vocab_size: int, seed: int, n: int = 1024) -> dict:
    """A mel batch of ``frames // n`` rows of n frames, ragged valid lengths."""
    rng = np.random.default_rng(seed)
    b = frames // n
    lens = rng.integers(int(0.7 * n), n + 1, b).astype(np.int32)
    lens[0] = n
    nt = 256
    ids = rng.integers(0, vocab_size, (b, nt)).astype(np.int32)
    for i, t in enumerate(rng.integers(nt // 4, nt, b)):
        ids[i, t:] = -1
    mel = (rng.standard_normal((b, n, 100)) * 2.0 - 5.0).astype(np.float32)
    return {"mel": torch.from_numpy(mel).cuda(), "text_ids": torch.from_numpy(ids).cuda(),
            "lens": torch.from_numpy(lens).cuda()}


def _remat_cell(torch, model, base_arch, opt_cfg, policy: str, batch: dict, micro0: int,
                profile: bool = False) -> dict:
    """Median update time of 3 after 1 warm-up, under one remat policy;
    with ``profile``, a fifth update under the profiler (device time and
    busy share)."""
    import dataclasses

    from f5_tts_tpu_torch.train import step as S
    from f5_tts_tpu_torch.train.trainer import micro_step_seed

    model.cfg = dataclasses.replace(base_arch, checkpoint_activations=policy != "none",
                                    remat_policy="nothing" if policy == "none" else policy)
    optim = S.make_optimizer(list(model.parameters()), opt_cfg)
    ema = [p.detach().clone() for p in model.parameters()]
    ema_model = type("Ema", (), {"parameters": lambda self: iter(ema)})()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times, micro = [], micro0
    alloc_keys = ("num_alloc_retries", "num_device_alloc")
    stats0 = None
    for i in range(4):
        if i == 1:  # the allocator's work in the timed updates
            stats0 = torch.cuda.memory_stats()
        t0 = time.perf_counter()
        micro, m = S.train_step(model, optim, ema_model, micro, batch,
                                micro_step_seed(7, micro), opt_cfg)
        loss = m["loss"].item()  # the update's end
        times.append(time.perf_counter() - t0)
    c = counts()
    stats1 = torch.cuda.memory_stats()
    out = {"alloc": {k: stats1.get(k, 0) - stats0.get(k, 0) for k in alloc_keys}}
    if profile:
        def one_update():
            nonlocal micro
            micro, m = S.train_step(model, optim, ema_model, micro, batch,
                                    micro_step_seed(7, micro), opt_cfg)
            m["loss"].item()

        prof = _profile_update(torch, one_update, f"one update, remat {policy}", host=False)
        out["profile"] = {k: prof[k] for k in ("wall_ms", "device_ms", "busy_share", "kernels")}
    del optim, ema
    valid = int(batch["lens"].sum().item())
    med = sorted(times[1:])[1]
    return {"update_s": med, "frames_per_s": valid / med, "loss": loss,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "per_micro": {k: c[k] / 4 for k in ("C", "D", "E", "B", "A")}, **out}


def _remat_matrix(torch, np, model, arch, opt_cfg, vocab_size: int) -> dict:
    depth = arch.depth
    out = {}
    for frames in REMAT_BUDGETS:
        batch = _remat_batch(torch, np, frames, vocab_size, seed=frames)
        for policy in REMAT_POLICIES:
            if frames != REMAT_BUDGETS[0] and policy not in REMAT_MID_POLICIES:
                continue
            key = f"{policy}@{frames}"
            try:
                r = _remat_cell(torch, model, arch, opt_cfg, policy, batch, 0,
                                profile=frames == REMAT_BUDGETS[0])
            except torch.cuda.OutOfMemoryError:
                r = "OOM"
            torch.cuda.empty_cache()
            out[key] = r
            if r == "OOM":
                print(f"remat {key}: OOM", flush=True)
                continue
            want_c = 2 * depth if policy in ("nothing", "dots") else depth
            print(f"remat {key}: {r['update_s'] * 1e3:.1f} ms per update (median of 3), "
                  f"{r['frames_per_s']:.0f} valid frames/s, peak {r['peak_gib']:.2f} GiB, "
                  f"per micro-step C {r['per_micro']['C']:g} D {r['per_micro']['D']:g} "
                  f"E {r['per_micro']['E']:g} B {r['per_micro']['B']:g}; in the 3 timed updates "
                  f"alloc retries {r['alloc']['num_alloc_retries']}, cudaMalloc "
                  f"{r['alloc']['num_device_alloc']}", flush=True)
            if r["per_micro"]["C"] != want_c or r["per_micro"]["D"] != depth \
                    or r["per_micro"]["E"] != depth or r["per_micro"]["B"] != 1 \
                    or r["per_micro"]["A"] != 0:
                fail(f"remat {key}: launches per micro-step {r['per_micro']}, want C {want_c}, "
                     f"D and E {depth}, B 1, A 0")
        del batch
        torch.cuda.empty_cache()
    # the auto threshold: the largest budget at which dots_flash runs and is
    # no slower than flash (above it, flash)
    fits = [f for f in REMAT_BUDGETS
            if out[f"dots_flash@{f}"] != "OOM" and (
                out[f"flash@{f}"] == "OOM"
                or out[f"dots_flash@{f}"]["update_s"] <= out[f"flash@{f}"]["update_s"])]
    out["auto_threshold"] = max(fits) if fits else 0
    from f5_tts_tpu_torch.models import remat

    print(f"remat: the matrix gives an auto threshold of {out['auto_threshold']} tokens "
          f"(models/remat.py AUTO_DOTS_FLASH_MAX_TOKENS = {remat.AUTO_DOTS_FLASH_MAX_TOKENS})",
          flush=True)
    return out


def _remat_grads(torch, np, model, arch, vocab_size: int) -> dict:
    """Loss gradients under each policy against no remat, one fixed batch
    with fixed draws, mixed precision as the trainer runs."""
    import dataclasses

    from f5_tts_tpu_torch.models.cfm import mask_from_frac_lengths

    batch = _remat_batch(torch, np, 8 * 1024, vocab_size, seed=3)
    b, n, d = batch["mel"].shape
    g = torch.Generator(device="cuda").manual_seed(4)
    inject = {"x0": torch.randn((b, n, d), generator=g, device="cuda"),
              "time": torch.rand((b,), generator=g, device="cuda"),
              "span_mask": mask_from_frac_lengths(batch["lens"], n, g),
              "drop_audio": False, "drop_both": False}
    params = dict(model.named_parameters())

    def grads(policy):
        model.cfg = dataclasses.replace(arch, checkpoint_activations=policy != "none",
                                        remat_policy="nothing" if policy == "none" else policy)
        low = {k: p.to(torch.bfloat16) for k, p in params.items()}
        loss = torch.func.functional_call(
            model, low, (batch["mel"].to(torch.bfloat16), batch["text_ids"], batch["lens"]),
            {"inject": inject})
        return torch.cat([x.flatten() for x in torch.autograd.grad(loss, list(params.values()))])

    ref = grads("none")
    out = {}
    for policy in REMAT_POLICIES[1:]:
        got = grads(policy)
        rel = ((got - ref).norm() / ref.norm()).item()
        out[policy] = {"bitwise": bool(torch.equal(got, ref)), "rel_l2": rel,
                       "max_abs": (got - ref).abs().max().item()}
        print(f"remat gradient {policy} vs none: bitwise {out[policy]['bitwise']}, relative L2 "
              f"{rel:.3e}, max abs {out[policy]['max_abs']:.3e} (limit {REMAT_GRAD_REL_TOL:g})",
              flush=True)
        if rel > REMAT_GRAD_REL_TOL:
            fail(f"remat policy {policy}: gradient relative L2 {rel} > {REMAT_GRAD_REL_TOL}")
    model.cfg = arch
    return out


def _adafactor(torch, np, model, opt_cfg, vocab_size: int) -> dict:
    import dataclasses

    from f5_tts_tpu_torch.train import step as S
    from f5_tts_tpu_torch.train.trainer import micro_step_seed

    batch = _remat_batch(torch, np, REMAT_BUDGETS[0], vocab_size, seed=5)
    cfg = dataclasses.replace(opt_cfg, optimizer="adafactor")
    optim = S.make_optimizer(list(model.parameters()), cfg)
    ema = [p.detach().clone() for p in model.parameters()]
    ema_model = type("Ema", (), {"parameters": lambda self: iter(ema)})()
    losses, times = [], []
    micro = 0
    for _ in range(3):
        t0 = time.perf_counter()
        micro, m = S.train_step(model, optim, ema_model, micro, batch,
                                micro_step_seed(9, micro), cfg)
        losses.append(m["loss"].item())
        times.append(time.perf_counter() - t0)
    n_params = sum(p.numel() for p in model.parameters())
    out = {"losses": losses, "update_s": times, "state_bytes": optim.inner.state_bytes(),
           "adamw_state_bytes": 2 * 4 * n_params}
    print(f"adafactor: 3 updates, losses {[round(x, 5) for x in losses]}, "
          f"{[round(t * 1e3, 1) for t in times]} ms; optimizer state {out['state_bytes']} bytes "
          f"against AdamW's {out['adamw_state_bytes']} "
          f"({out['state_bytes'] / out['adamw_state_bytes']:.4f}x)",
          flush=True)
    if not all(np.isfinite(losses)):
        fail(f"adafactor: non-finite loss {losses}")
    del optim, ema
    return out


def _mel_in_graph(torch, np, model, opt_cfg, workdir: str) -> dict:
    """One batch of the same audio through both paths: host mel (collate_batch)
    and wav (collate_wav_batch, mel on the card)."""
    from f5_tts_tpu_torch.audio.io import save_wav
    from f5_tts_tpu_torch.models.cfm import mask_from_frac_lengths
    from f5_tts_tpu_torch.ops.mel import MelConfig
    from f5_tts_tpu_torch.train import dataset as TD
    from f5_tts_tpu_torch.train import step as S
    from f5_tts_tpu_torch.train.trainer import micro_step_seed

    rng = np.random.default_rng(11)
    rows = []
    for i in range(TRAIN_B):  # ~10 s each: one 38,400-frame update
        secs = float(rng.uniform(8.0, 10.9))
        t = np.arange(int(secs * 24_000))
        wav = 0.3 * np.sin(t * rng.uniform(0.01, 0.08)) + 0.05 * rng.standard_normal(len(t))
        path = os.path.join(workdir, f"w{i}.wav")
        save_wav(path, wav.astype(np.float32))
        rows.append({"audio_path": path, "text": "hello world " * 8, "duration": secs})
    ds = TD.CustomDataset(rows)
    idx = list(range(len(rows)))
    from f5_tts_tpu_torch.audio.native_loader import native_available

    native = native_available()  # its first call builds the native decoder
    mel_ms, wav_ms = [], []
    for _ in range(2):  # a cold and a warm pass over the files
        t0 = time.perf_counter()
        mel_b = TD.collate_batch([ds[i] for i in idx], None, "byte")
        mel_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        wav_b = TD.collate_wav_batch(ds.wav_batch(idx), None, "byte", MelConfig())
        wav_ms.append((time.perf_counter() - t0) * 1e3)
    mel_t = {k: torch.from_numpy(v).cuda() for k, v in mel_b.items()}
    wav_t = {k: torch.from_numpy(v).cuda() for k, v in wav_b.items()}
    b, n, d = mel_t["mel"].shape
    g = torch.Generator(device="cuda").manual_seed(12)
    inject = {"x0": torch.randn((b, n, d), generator=g, device="cuda"),
              "time": torch.rand((b,), generator=g, device="cuda"),
              "span_mask": mask_from_frac_lengths(mel_t["lens"], n, g),
              "drop_audio": False, "drop_both": False}
    params = dict(model.named_parameters())
    low = {k: p.to(torch.bfloat16) for k, p in params.items()}
    with torch.no_grad():
        card_mel = S.batch_mel(wav_t, MelConfig())
        valid = torch.arange(n, device="cuda")[None] < mel_t["lens"][:, None]
        mel_err = (card_mel - mel_t["mel"]).abs()[valid].max().item()
        losses = [torch.func.functional_call(
            model, low, (m.to(torch.bfloat16), mel_t["text_ids"], mel_t["lens"]),
            {"inject": inject}).item() for m in (mel_t["mel"], card_mel)]
    rel = abs(losses[1] - losses[0]) / abs(losses[0])
    # one update through the trainer's step from the wav batch
    optim = S.make_optimizer(list(model.parameters()), opt_cfg)
    ema = [p.detach().clone() for p in model.parameters()]
    ema_model = type("Ema", (), {"parameters": lambda self: iter(ema)})()
    reset_counts()
    _, m = S.train_step(model, optim, ema_model, 0, wav_t, micro_step_seed(13, 0), opt_cfg,
                        mel_cfg=MelConfig())
    step_loss = m["loss"].item()
    c = counts()
    out = {"host_collate_ms": {"mel": mel_ms, "wav": wav_ms}, "native_decoder": native,
           "mel_max_abs": mel_err,
           "loss_mel": losses[0], "loss_wav": losses[1], "loss_rel": rel,
           "update_loss": step_loss, "shape": [b, n], "wav_bytes": wav_b["wav"].nbytes,
           "mel_bytes": mel_b["mel"].nbytes, "launches": c}
    print(f"mel_in_graph: [{b}, {n}] batch; host collate (cold, warm) "
          f"{[round(x) for x in mel_ms]} ms (host mel) against {[round(x) for x in wav_ms]} ms "
          f"(wav; native decoder {native}); wire bytes {out['mel_bytes']} against {out['wav_bytes']}; "
          f"mel on the card vs host max |diff| {mel_err:.3e}; loss {losses[0]:.6f} (mel) vs "
          f"{losses[1]:.6f} (wav), relative {rel:.2e} (limit {MEL_IN_GRAPH_LOSS_REL_TOL:g}); "
          f"one update from the wav batch: loss {step_loss:.5f}, launches {c}", flush=True)
    if rel > MEL_IN_GRAPH_LOSS_REL_TOL or not np.isfinite(step_loss):
        fail(f"mel_in_graph: loss relative difference {rel} > {MEL_IN_GRAPH_LOSS_REL_TOL}")
    del optim, ema
    return out


def _async_save(torch, np, model, opt_cfg, vocab_size: int, workdir: str) -> dict:
    """How long the step loop waits at a full-width save: a synchronous
    write against the asynchronous writer (its first save allocates the
    pinned buffers, the second reuses them)."""
    import copy

    from f5_tts_tpu_torch.train import step as S
    from f5_tts_tpu_torch.train.trainer import micro_step_seed
    from f5_tts_tpu_torch.utils import ckpt as CK

    batch = _remat_batch(torch, np, REMAT_BUDGETS[0], vocab_size, seed=15)
    optim = S.make_optimizer(list(model.parameters()), opt_cfg)
    ema_model = copy.deepcopy(model).requires_grad_(False)
    micro = 0

    def update():
        nonlocal micro
        t0 = time.perf_counter()
        micro, m = S.train_step(model, optim, ema_model, micro, batch,
                                micro_step_seed(17, micro), opt_cfg)
        m["loss"].item()
        return time.perf_counter() - t0

    def obj():
        return CK.train_checkpoint(model, ema_model, optim.inner.state_dict(),
                                   optim.scheduler.state_dict(), micro, micro)

    base = [update() for _ in range(3)][1:]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    CK.save_train_checkpoint(os.path.join(workdir, "sync.pt"), model, ema_model,
                             optim.inner.state_dict(), optim.scheduler.state_dict(), micro, micro)
    sync_s = time.perf_counter() - t0
    nbytes = os.path.getsize(os.path.join(workdir, "sync.pt"))
    os.remove(os.path.join(workdir, "sync.pt"))
    writer = CK.CheckpointWriter()
    out = {"bytes": nbytes, "sync_wait_s": sync_s, "update_s": base}
    for tag in ("first", "reused"):
        path = os.path.join(workdir, f"async_{tag}.pt")
        if tag == "reused":  # the file written from reused buffers is the one checked
            want = {k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        writer.save(path, obj())
        call_s = time.perf_counter() - t0
        during = [update() for _ in range(2)]  # updates while the writer writes
        t1 = time.perf_counter()
        writer.wait()
        out[tag] = {"save_call_s": call_s, "updates_during_s": during,
                    "wait_after_s": time.perf_counter() - t1}
        if tag == "reused":
            got = torch.load(path, map_location="cpu", weights_only=True)["model_state_dict"]
            bad = [k for k, v in want.items() if not torch.equal(got[k], v)]
            if bad:
                fail(f"async save: the file's weights differ from the snapshot: {bad[:3]}")
            del got
        os.remove(path)
    print(f"async save: {nbytes / 1e9:.2f} GB; the step loop waits {sync_s:.2f} s for a "
          f"synchronous write, {out['first']['save_call_s']:.3f} s (first save, pinned buffers "
          f"allocated) and {out['reused']['save_call_s']:.3f} s (buffers reused) for the "
          f"asynchronous one; updates {[round(t * 1e3) for t in base]} ms before, "
          f"{[round(t * 1e3) for t in out['first']['updates_during_s']]} and "
          f"{[round(t * 1e3) for t in out['reused']['updates_during_s']]} ms while writing; the "
          f"second file loads equal to the snapshot", flush=True)
    del writer, optim, ema_model
    return out


def _spread(torch, np, model, opt_cfg, vocab, cfg) -> dict:
    """SPREAD_UPDATES updates at 38,400 frames on the sampler's batches (the
    trainer's varied shapes), each with its wall and allocator counters."""
    import copy

    from f5_tts_tpu_torch.train import step as S
    from f5_tts_tpu_torch.train.dataset import DynamicBatchSampler, collate_batch
    from f5_tts_tpu_torch.train.trainer import micro_step_seed

    ds = _synthetic_dataset(np, vocab, 1000, seed=30)
    sampler = DynamicBatchSampler(ds, TRAIN_FRAMES, max_samples=64, random_seed=31)
    batches = []
    for idx in list(sampler)[:SPREAD_UPDATES]:
        bt = collate_batch([ds[i] for i in idx], vocab, cfg.tokenizer)
        batches.append({k: torch.from_numpy(v).cuda() for k, v in bt.items()})
    optim = S.make_optimizer(list(model.parameters()), opt_cfg)
    ema_model = copy.deepcopy(model).requires_grad_(False)
    keys = ("num_alloc_retries", "num_device_alloc", "num_device_free", "num_ooms")
    rows = []
    micro = 0
    for bt in batches:
        before = torch.cuda.memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        micro, m = S.train_step(model, optim, ema_model, micro, bt,
                                micro_step_seed(33, micro), opt_cfg)
        m["loss"].item()
        wall = time.perf_counter() - t0
        after = torch.cuda.memory_stats()
        rows.append({"wall_s": wall, "shape": list(bt["mel"].shape[:2]),
                     **{k: after.get(k, 0) - before.get(k, 0) for k in keys},
                     "reserved_gib": after.get("reserved_bytes.all.current", 0) / 2**30})
    for i, r in enumerate(rows):
        print(f"spread update {i + 1}: {r['wall_s'] * 1e3:.1f} ms, batch {r['shape']}, "
              f"alloc retries {r['num_alloc_retries']}, cudaMalloc {r['num_device_alloc']}, "
              f"cudaFree {r['num_device_free']}, reserved {r['reserved_gib']:.2f} GiB", flush=True)
    walls = [r["wall_s"] for r in rows[1:]]
    print(f"spread: updates 2-{len(rows)} {min(walls) * 1e3:.1f}-{max(walls) * 1e3:.1f} ms; "
          f"alloc retries {sum(r['num_alloc_retries'] for r in rows)}, cudaMalloc "
          f"{sum(r['num_device_alloc'] for r in rows)} over {len(rows)} updates", flush=True)
    del optim, ema_model, batches
    return {"rows": rows}


def spread_in_child(torch) -> dict:
    """``_spread`` in a process of its own (the allocator's settings are read
    when CUDA starts): a fresh F5TTS_v1_Base as phase 20 builds it."""
    import numpy as np

    from f5_tts_tpu_torch.models.configs import MODEL_CONFIGS, with_vocab_size
    from f5_tts_tpu_torch.text.tokenizer import get_tokenizer
    from f5_tts_tpu_torch.train import step as S

    vocab, vocab_size = get_tokenizer(None, "pinyin")
    cfg = with_vocab_size(MODEL_CONFIGS["F5TTS_v1_Base"], vocab_size)
    opt_cfg = S.OptimConfig(mixed_precision=True, num_warmup_updates=1, learning_rate=1e-5)
    model = _fresh_cfm(torch, cfg.arch, 40, device="cuda")
    return _spread(torch, np, model, opt_cfg, vocab, cfg)


def phase_allocator(torch, default: dict) -> dict:
    """Phase 21: phase 20's spread updates again, in a child process with
    the caching allocator's expandable segments (``PYTORCH_CUDA_ALLOC_CONF``),
    against ``default`` (phase 20's own, in this process)."""
    code = ("import json, sys, torch; sys.path.insert(0, sys.argv[1]); import chip_smoke as C; "
            "print('SPREAD_JSON ' + json.dumps(C.spread_in_child(torch)), flush=True)")
    env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    print(f"spread: this process holds {torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved "
          "while the child runs", flush=True)
    proc = subprocess.run([sys.executable, "-c", code, REPO], env=env, capture_output=True,
                          text=True, timeout=600)
    line = next((x for x in proc.stdout.splitlines() if x.startswith("SPREAD_JSON ")), None)
    if proc.returncode != 0 or line is None:
        fail(f"spread with expandable segments: rc {proc.returncode}\n{proc.stdout[-2000:]}"
             f"\n{proc.stderr[-2000:]}")
    out = json.loads(line[len("SPREAD_JSON "):])
    walls = {k: [r["wall_s"] for r in d["rows"][1:]] for k, d in
             (("default", default), ("expandable", out))}
    for k, d in (("default", default), ("expandable", out)):
        rows = d["rows"]
        print(f"spread ({k} allocator), ms per update: "
              f"{[round(r['wall_s'] * 1e3, 1) for r in rows]}; alloc retries per update "
              f"{[r['num_alloc_retries'] for r in rows]}", flush=True)
        print(f"spread ({k} allocator): updates 2-{len(rows)} "
              f"{min(walls[k]) * 1e3:.1f}-{max(walls[k]) * 1e3:.1f} ms, median "
              f"{sorted(walls[k])[len(walls[k]) // 2] * 1e3:.1f} ms, sum {sum(walls[k]):.2f} s; "
              f"alloc retries {sum(r['num_alloc_retries'] for r in rows)}, cudaMalloc "
              f"{sum(r['num_device_alloc'] for r in rows)}, cudaFree "
              f"{sum(r['num_device_free'] for r in rows)}", flush=True)
    return out


def phase_train_rest(torch):
    """Phase 20: the remat matrix, remat gradients, Adafactor, in-graph mel,
    asynchronous saves and the spread of updates, F5TTS_v1_Base at full
    width on the card."""
    import gc
    import shutil
    import tempfile

    import numpy as np

    from f5_tts_tpu_torch.models.configs import MODEL_CONFIGS, with_vocab_size
    from f5_tts_tpu_torch.text.tokenizer import get_tokenizer
    from f5_tts_tpu_torch.train import step as S

    vocab, vocab_size = get_tokenizer(None, "pinyin")
    cfg = with_vocab_size(MODEL_CONFIGS["F5TTS_v1_Base"], vocab_size)
    arch = cfg.arch
    opt_cfg = S.OptimConfig(mixed_precision=True, num_warmup_updates=1, learning_rate=1e-5)
    model = _fresh_cfm(torch, arch, 40, device="cuda")
    os.makedirs(os.path.join(REPO, ".cache"), exist_ok=True)  # git-ignored scratch
    workdir = tempfile.mkdtemp(prefix="chip_smoke_rest_", dir=os.path.join(REPO, ".cache"))
    clock = time.perf_counter()
    out = {}
    try:
        out["matrix"] = _remat_matrix(torch, np, model, arch, opt_cfg, vocab_size)
        out["seconds_matrix"] = time.perf_counter() - clock
        gc.collect()
        torch.cuda.empty_cache()
        out["grads"] = _remat_grads(torch, np, model, arch, vocab_size)
        out["adafactor"] = _adafactor(torch, np, model, opt_cfg, vocab_size)
        gc.collect()
        torch.cuda.empty_cache()
        out["mel_in_graph"] = _mel_in_graph(torch, np, model, opt_cfg, workdir)
        gc.collect()
        torch.cuda.empty_cache()
        out["async_save"] = _async_save(torch, np, model, opt_cfg, vocab_size, workdir)
        gc.collect()
        torch.cuda.empty_cache()
        out["spread"] = _spread(torch, np, model, opt_cfg, vocab, cfg)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
        del model
        gc.collect()
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - clock
    return out


RUNTIME_PROMPTS = 10  # the benchmark's timed prompts with kernel A (3 with SDPA)
AOT_MEL_TOL = 1e-5  # JAX's AOT-vs-live tolerance (tests/test_aot.py), on the mel
AOT_WAV_STEPS = 1  # int16 steps the AOT wav may differ from the live one by


def _w(torch, cfg, seed: int):
    """Seeded F5TTS_v1_Base weights on the CPU (fp32) with the
    zero-initialized projections filled, so the output depends on them."""
    from f5_tts_tpu_torch.infer.api import _seeded
    from f5_tts_tpu_torch.models.backbones import randomize_zero_init
    from f5_tts_tpu_torch.models.cfm import CFM

    m = _seeded(lambda: CFM(cfg.arch), seed)
    randomize_zero_init(m.transformer, torch.Generator().manual_seed(seed))
    return m


def _aot_requests(np):
    """The seeded wav request (ref bucket 512, bucket 1024) and mel request
    (bucket 1024) that phase 22 serves through each engine."""
    from f5_tts_tpu_torch.audio.io import load_wav

    wav, _ = load_wav(REF_WAV)
    wav = np.tile(wav, -(-511 * 256 // len(wav)))[: 511 * 256]  # 511 frames: ref bucket 512
    rng = np.random.default_rng(22)
    ids = rng.integers(0, 2545, 160).astype(np.int32)
    mel_ref = rng.standard_normal((300, 100)).astype(np.float32)
    return (lambda eng: eng.generate_batch_from_wav(wav, [ids], [1000], seeds=[3]),
            lambda eng: eng.generate_batch([mel_ref], [ids], [1000], seeds=[3]))


def _wall_ms(torch, fn, reps: int = 3) -> list:
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def phase_runtime(torch, build_s: float | None) -> dict:
    """Phase 22, the runtime layer: the offline benchmark (kernel A, then
    SDPA), bench_train at 38,400 frames, AOT bundles built with weights W1
    and served with W2 against the live engine on W2 (dense mel and wav
    entries, W8A8 wav), and the cold start of a bundle in a process with no
    nvcc against a cold live engine."""
    import copy
    import gc
    import shutil
    import tempfile

    import numpy as np

    from f5_tts_tpu_torch.infer.api import _seeded
    from f5_tts_tpu_torch.infer.engine import EngineOptions, InferenceEngine
    from f5_tts_tpu_torch.models.configs import MODEL_CONFIGS
    from f5_tts_tpu_torch.models.vocos import Vocos
    from f5_tts_tpu_torch.ops.cuda_build import LIBRARY
    from f5_tts_tpu_torch.runtime import aot
    from f5_tts_tpu_torch.runtime import benchmark as RB
    from f5_tts_tpu_torch.scripts import aot_coldstart_ab as CS
    from f5_tts_tpu_torch.scripts import bench_train
    from f5_tts_tpu_torch.utils import flops

    out = {}
    cfg = MODEL_CONFIGS["F5TTS_v1_Base"]
    depth = cfg.arch.depth

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    # (a) the offline benchmark through the batch server, NFE 32, batch 1
    reset_counts()
    rep = RB.main(["--backend-type", "flash", "--nfe", str(NFE), "--num-prompts",
                   str(RUNTIME_PROMPTS), "--batch-size", "1"])
    got = counts()
    calls = sum(rep["engine_calls"].values())
    per_call = {k: v / calls for k, v in rep["kernel_launches"].items()}
    if per_call.get("flash_attention_fwd") != depth * NFE or \
            per_call.get("fused_convpos_fwd") != NFE or not got["A"] or not got["B"]:
        fail(f"runtime benchmark: launches per engine call {per_call}, want A {depth * NFE}, "
             f"B {NFE}")
    per_bucket = {k: flops.sampling_flops(cfg, NFE, int(k.split("_n")[1])) / 1e12
                  for k in rep["engine_calls"]}
    print(f"phase 22 benchmark (flash, {RUNTIME_PROMPTS} prompts, batch 1, NFE {NFE}): RTF "
          f"{rep['rtf']:.5f}, wall RTF {rep['wall_rtf']:.5f}, latency p50 "
          f"{rep['latency_ms_p50']:.1f} ms, p99 {rep['latency_ms_p99']:.1f} ms, wall "
          f"{rep['wall_s']:.3f} s for {rep['total_audio_s']:.2f} s of audio; engine calls "
          f"{rep['engine_calls']}; launches per call {per_call}; MFU {rep['mfu_pct']:.2f}% of "
          f"the H100 bf16 peak ({PEAK_BF16 / 1e12:.0f} TFLOP/s) over the timed wall, "
          f"{rep['model_tflop']:.2f} TFLOP ({', '.join(f'{k}: {v:.2f}' for k, v in per_bucket.items())}"
          f" TFLOP per call)", flush=True)
    out["benchmark_flash"] = rep
    free()
    rep = RB.main(["--backend-type", "sdpa", "--nfe", str(NFE), "--num-prompts", "3",
                   "--batch-size", "1"])
    if rep["kernel_launches"].get("flash_attention_fwd"):
        fail(f"runtime benchmark: sdpa launched kernel A: {rep['kernel_launches']}")
    print(f"phase 22 benchmark (sdpa, 3 prompts): RTF {rep['rtf']:.5f}, wall RTF "
          f"{rep['wall_rtf']:.5f}, p50 {rep['latency_ms_p50']:.1f} ms, p99 "
          f"{rep['latency_ms_p99']:.1f} ms, MFU {rep['mfu_pct']:.2f}%, launches "
          f"{rep['kernel_launches']}", flush=True)
    out["benchmark_sdpa"] = rep
    free()

    # (b) training throughput: TRAIN_B x 1024 frames, bf16, no remat
    reset_counts()
    rec = bench_train.main([str(TRAIN_B), "bf16", "train_auto", "none", "1024", "1",
                            "F5TTS_v1_Base", "cuda", "5"])
    got = counts()
    if not (got["C"] and got["D"] and got["E"] and got["B"]):
        fail(f"bench_train: a training kernel did not launch: {got}")
    print(f"phase 22 bench_train ({TRAIN_B} x 1024 frames, bf16, no remat): {rec['value']} "
          f"frames/s, {rec['model_tflops_per_s']} TFLOP/s, MFU {rec['mfu_pct']}% of the H100 "
          f"bf16 peak; launches {got}", flush=True)
    out["bench_train"] = rec
    free()

    # (c) AOT bundles: built with W1, served with W2
    os.makedirs(os.path.join(REPO, ".cache"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="aot_", dir=os.path.join(REPO, ".cache"))
    dense_dir, q_dir = os.path.join(root, "dense"), os.path.join(root, "w8a8")
    w1, w2 = _w(torch, cfg, 0), _w(torch, cfg, 5)
    voc = _seeded(Vocos, 1).cuda()

    def live(w, quantize):
        return InferenceEngine(copy.deepcopy(w).cuda(), cfg, vocoder=voc, dtype=torch.bfloat16,
                               options=EngineOptions(nfe_step=NFE, quantize=quantize))

    try:
        e1 = live(w1, False)
        t0 = time.perf_counter()
        aot.export_engine(e1, dense_dir, [("wav", 1, 1024, 512), ("mel", 1, 1024, None)])
        export_s = time.perf_counter() - t0
        e1q = live(w1, True)
        t0 = time.perf_counter()
        aot.export_engine(e1q, q_dir, [("wav", 1, 1024, 512)])
        export_q_s = time.perf_counter() - t0
        n_libs = aot.warm_artifacts(dense_dir)
        aot.warm_artifacts(q_dir)
        meta = aot.read_meta(dense_dir)
        print(f"phase 22 AOT export: dense (wav b1 n1024 r512, mel b1 n1024) {export_s:.1f} s, "
              f"per program {({k: round(v, 1) for k, v in meta['export_seconds'].items()})}, "
              f"{aot.bundle_bytes(dense_dir)} bytes with {n_libs} kernel libraries; W8A8 wav "
              f"{export_q_s:.1f} s, {aot.bundle_bytes(q_dir)} bytes", flush=True)
        wav_req, mel_req = _aot_requests(np)
        w1_mel = wav_req(e1)[0]
        del e1, e1q
        free()
        e2, e2q = live(w2, False), live(w2, True)
        t0 = time.perf_counter()
        a2 = aot.AotEngine(dense_dir, copy.deepcopy(w2).cuda(), cfg, vocoder=voc)
        load_s = time.perf_counter() - t0
        a2q = aot.AotEngine(q_dir, copy.deepcopy(w2).cuda(), cfg, vocoder=voc)
        if LIBRARY.prebuilt != os.path.join(q_dir, "kernels", LIBRARY.digest()):
            fail(f"AOT: the kernels did not come from the bundle ({LIBRARY.prebuilt})")
        res = {"export_s": export_s, "export_w8a8_s": export_q_s, "load_s": load_s,
               "bundle_bytes": aot.bundle_bytes(dense_dir),
               "bundle_w8a8_bytes": aot.bundle_bytes(q_dir), "kernel_libraries": n_libs,
               "export_seconds": meta["export_seconds"],
               "program_bytes": {k: v["bytes"] for k, v in meta["programs"].items()}}
        for tag, ref_eng, aot_eng, reqs in (("dense", e2, a2, (wav_req, mel_req)),
                                            ("w8a8", e2q, a2q, (wav_req,))):
            for req in reqs:
                want, got_ = req(ref_eng), req(aot_eng)
                entry = "wav" if req is wav_req else "mel"
                mel_err = float(np.abs(got_[0] - want[0]).max())
                wav_steps = float(np.abs(got_[1][0] - want[1][0]).max() * 32767.0)
                bitwise = bool(np.array_equal(got_[0], want[0])
                               and np.array_equal(got_[1][0], want[1][0]))
                print(f"phase 22 AOT {tag} {entry}: W2 bundle vs live W2: mel max abs "
                      f"{mel_err:.3e}, wav {wav_steps:.1f} int16 steps, bitwise {bitwise}",
                      flush=True)
                if mel_err > AOT_MEL_TOL or wav_steps > AOT_WAV_STEPS + 0.5 \
                        or not np.isfinite(got_[0]).all():
                    fail(f"AOT {tag} {entry}: mel {mel_err}, wav {wav_steps} steps off live W2")
                res[f"{tag}_{entry}"] = {"mel_max_abs": mel_err, "wav_int16_steps": wav_steps,
                                         "bitwise": bitwise}
        diff_w1 = float(np.abs(wav_req(a2)[0] - w1_mel).mean())
        print(f"phase 22 AOT: W2 bundle mel vs live W1 mel: mean abs {diff_w1:.4f}", flush=True)
        if diff_w1 < 1e-2:
            fail(f"AOT: the W2 bundle served W1's mel (mean abs diff {diff_w1})")
        res["w1_mean_abs_diff"] = diff_w1
        launches = {}
        for tag, eng in (("live", e2), ("aot", a2), ("live_w8a8", e2q), ("aot_w8a8", a2q)):
            reset_counts()
            wav_req(eng)  # a replay: its key was captured above
            launches[tag] = {k: v for k, v in counts().items() if v}
        print(f"phase 22 AOT launches per wav call: {launches}", flush=True)
        if launches["aot"] != launches["live"] or launches["aot_w8a8"] != launches["live_w8a8"] \
                or launches["aot"].get("A") != depth * NFE or launches["aot"].get("B") != NFE \
                or launches["aot_w8a8"].get("G") != 4 * depth * NFE:
            fail(f"AOT: launches differ from the live engine's: {launches}")
        res["launches"] = launches
        walls = {tag: _wall_ms(torch, lambda e=eng: wav_req(e))
                 for tag, eng in (("live", e2), ("aot", a2))}
        print(f"phase 22 AOT wav request wall (ms, 3 replays): {walls}", flush=True)
        res["wall_ms"] = walls
        out["aot"] = res
        del e2, e2q, a2, a2q
        free()

        # (d) cold start in child processes
        cold = CS.run(dense_dir, nfe=NFE, skip_build=True)
        print(f"phase 22 cold start: {json.dumps(cold)}", flush=True)
        if cold["aot_built_kernels"] or cold["aot_nvcc_found"] or cold["aot_backbone_forwards"] \
                or not cold["aot_kernels_from"] or not cold["aot_finite"]:
            fail(f"AOT cold start: built a kernel, found nvcc, ran the backbone's forward or "
                 f"took no bundle kernels: {cold}")
        print(f"phase 22 time to first audio: AOT bundle {cold['cold_first_audio_s']:.2f} s "
              f"(load {cold['cold_load_s']:.2f} s, first call {cold['cold_first_call_s']:.2f} s; "
              f"no nvcc, no build cache) against a cold live engine "
              f"{cold['live_first_audio_s']:.2f} s (load {cold['live_load_s']:.2f} s, first call "
              f"{cold['live_first_call_s']:.2f} s; build cache present); export {export_s:.1f} s, "
              f"bundle {res['bundle_bytes']} bytes, phase 1 build "
              f"{build_s if build_s is not None else 'reused'} s", flush=True)
        out["cold_start"] = cold
    finally:
        LIBRARY.prebuilt = None
        shutil.rmtree(root, ignore_errors=True)
    return out



# ---------------------------------------------------------------- phase 23
# parallelism over the data: one AdamW step at lr PAR_LR moves each element
# by at most lr, so two runs whose summed gradients differ only in rounding
# (other GEMM shapes per rank, bf16 mixed precision) differ by at most 2 lr
# where a near-zero gradient element flips sign, and the parameters alone
# would pass a wrong sum.  So the gate reads what a wrong sum or denominator
# moves: the loss within PAR_LOSS_REL_TOL and the gradient norm within
# PAR_GNORM_REL_TOL, each about 7x its reading on the card at PAR_DEPTH
# (1.3e-7 and 1.46e-5; a per-rank mean averaged over the two ranks moves the
# loss by about (L0 - L1) / 30), and AdamW's first moment after the step,
# (1 - b1) times the summed clipped gradients, per tensor within
# PAR_GRAD_TOL of its largest one-process value (ROADMAP C.2's gradient
# rounding limits)
PAR_LR = 1e-4
# F5TTS_v1_Base at full width with 4 of its 22 blocks: every path of the
# phase runs per block, so depth adds time (each Trainer run ends with a
# model_last.pt write), not coverage
PAR_DEPTH = 4
PAR_PARAM_TOL = 2.5 * PAR_LR
PAR_LOSS_REL_TOL = 1e-6
PAR_GNORM_REL_TOL = 1e-4
PAR_GRAD_TOL = (2e-2, 4e-3)  # max, mean abs over the tensor's largest reference value
PAR_ROWS = 15  # an odd global batch: the second rank's last row is a valid = 0 pad
PAR_FRAMES = 19_200  # the global batch's frame budget: 15 rows of 900-1250 frames
PAR_SERVE_WAV_STEPS = 3  # int16 steps a DP-served wav may differ from mesh=None's
RING_SHAPE = (2, 16, 4096, 64)
RING_LENS = (4096, 1500)
# the ring against kernel C (+ D, E) over all n.  o: absolute, 3-4x the
# readings of its first card runs (max 3.91e-3, mean 5.19e-5 at sp 4), since
# a typical |o| of random q, k, v at these n is only sqrt(e / n), 0.026-0.043;
# the gradients: ROADMAP C.2's rounding limits
RING_O_TOL = (1.2e-2, 2e-4)  # max, mean abs over valid query rows
RING_GRAD_TOL = (2e-2, 4e-3)  # max, mean abs over the largest reference value


def _shallow(cfg):
    """``cfg`` with ``PAR_DEPTH`` blocks: for the paths that run per block and
    check no depth-dependent number, to keep the script inside its time."""
    return dataclasses.replace(cfg, arch=dataclasses.replace(cfg.arch, depth=PAR_DEPTH))


def _par_dataset(np, vocab):
    """PAR_ROWS seeded mel rows of 900-1250 frames: one sampler batch."""
    from f5_tts_tpu_torch.train.dataset import CustomDataset

    rng = np.random.default_rng(23)
    chars = sorted(c for c in vocab if len(c) == 1 and c.isalpha() and c.isascii())
    rows = []
    for frames in rng.integers(900, 1251, PAR_ROWS):
        mel = (rng.standard_normal((int(frames), 100)) * 2.0 - 5.0).astype(np.float32)
        words = ["".join(rng.choice(chars, int(rng.integers(2, 8)))) for _ in range(30)]
        rows.append({"mel_spec": mel, "text": " ".join(words),
                     "duration": int(frames) * 256 / 24_000})
    return CustomDataset(rows, preprocessed_mel=True)


def _par_cfg(vocab_size: int | None = None):
    """F5TTS_v1_Base at full width, ``PAR_DEPTH`` blocks."""
    import dataclasses

    from f5_tts_tpu_torch.models.configs import MODEL_CONFIGS, with_vocab_size

    cfg = MODEL_CONFIGS["F5TTS_v1_Base"]
    if vocab_size is not None:
        cfg = with_vocab_size(cfg, vocab_size)
    return dataclasses.replace(cfg, arch=dataclasses.replace(cfg.arch, depth=PAR_DEPTH))


def _par_train(torch, workdir: str, mesh=None, zero1: bool = False) -> dict:
    """One Trainer update of ``_par_cfg`` (mixed precision, the
    zero-initialized projections filled) on ``_par_dataset``'s one batch."""
    import json as _json

    import numpy as np

    from f5_tts_tpu_torch.models.backbones import randomize_zero_init
    from f5_tts_tpu_torch.text.tokenizer import get_tokenizer
    from f5_tts_tpu_torch.train import step as S
    from f5_tts_tpu_torch.train.trainer import Trainer

    vocab, vocab_size = get_tokenizer(None, "pinyin")
    cfg = _par_cfg(vocab_size)
    opt = S.OptimConfig(mixed_precision=True, num_warmup_updates=0, learning_rate=PAR_LR,
                        total_updates=10)
    tr = Trainer(cfg, vocab, opt, ckpt_dir=workdir, batch_size_per_device=PAR_FRAMES,
                 max_samples=64, save_per_updates=10**9, last_per_updates=10**9,
                 log_every_updates=1, device="cuda", seed=23, mesh=mesh, zero1=zero1)
    model = _fresh_cfm(torch, cfg.arch, 23, device="cuda")
    randomize_zero_init(model.transformer, torch.Generator().manual_seed(23))
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, _, update = tr.train(model, _par_dataset(np, vocab), epochs=1, resume=False)
    torch.cuda.synchronize()
    state = tr.optimizer.state_dict()["state"]  # under ZeRO-1 a gather: every rank calls it
    out = dict(wall_s=time.perf_counter() - t0, update=update, launches=counts(),
               state_bytes=tr.optimizer.state_bytes(), model=model, zero1=tr.zero1,
               exp_avg=[state[i]["exp_avg"].cpu() for i in sorted(state)])
    log = os.path.join(workdir, "train_log.jsonl")
    if tr.is_main:
        out["log"] = [_json.loads(x) for x in open(log)][-1]
    return out


def _par_requests(np):
    from f5_tts_tpu_torch.infer.serve import Request

    rng = np.random.default_rng(24)
    return [Request(ref_mel=rng.standard_normal((int(rng.integers(150, 300)), 100))
                    .astype(np.float32),
                    text_ids=rng.integers(0, 2545, int(rng.integers(60, 120))).astype(np.int32),
                    duration=int(rng.integers(600, 1000)), seed=i) for i in range(4)]


def _par_serve(torch, mesh) -> dict:
    """``_par_cfg`` (bf16, NFE 32) serving 4 prompts through BatchServer:
    with ``mesh`` at batch 4 (2 rows per data rank), else at batch 2 (the
    same rows per engine call as a data rank's); the second pass, on the
    captured graphs, is counted."""
    import numpy as np

    from f5_tts_tpu_torch.infer.api import _seeded
    from f5_tts_tpu_torch.infer.engine import EngineOptions, InferenceEngine
    from f5_tts_tpu_torch.infer.serve import BatchServer
    from f5_tts_tpu_torch.models.vocos import Vocos

    cfg = _par_cfg()
    eng = InferenceEngine(_w(torch, cfg, 7).cuda(), cfg, vocoder=_seeded(Vocos, 1).cuda(),
                          dtype=torch.bfloat16, options=EngineOptions(nfe_step=NFE))
    srv = BatchServer(eng, mesh=mesh, batch_size=2 if mesh is None else 4)
    reqs = _par_requests(np)
    srv.run(reqs, overlap=1)  # each key's first hit captures its graph
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wavs, _ = srv.run(reqs, overlap=1, fetch_mel=True)
    torch.cuda.synchronize()
    return dict(wavs=[np.round(w * 32767.0).astype(np.int32) for w in wavs], launches=counts(),
                wall_s=time.perf_counter() - t0, calls=len(eng.graphs),
                mels=[srv.mels[i] for i in range(len(reqs))])


def _param_diff(torch, model, ref: dict) -> tuple[float, float]:
    """(max, mean) |p - ref| over every parameter of ``model``."""
    mx, total, count = 0.0, 0.0, 0
    for k, p in model.named_parameters():
        d = (p.detach().float() - ref[k].to(p.device).float()).abs()
        mx = max(mx, d.max().item())
        total += d.sum().item()
        count += d.numel()
    return mx, total / count


def _moment_diff(torch, got: list, ref: list) -> tuple[float, float]:
    """The worst tensor's (max, mean) |m - m_ref| / max |m_ref| over AdamW's
    first moments ``got`` against ``ref``, in parameter order."""
    mx, mean = 0.0, 0.0
    for a, r in zip(got, ref, strict=True):
        scale = max(r.abs().max().item(), 1e-30)
        e = (a.float() - r.float()).abs() / scale
        mx, mean = max(mx, e.max().item()), max(mean, e.mean().item())
    return mx, mean


def _par_rank(rank: int, root: str) -> None:
    """One of the two gloo ranks on the one card: the DP and the ZeRO-1
    update, then BatchServer over data = 2."""
    import gc

    import torch
    import torch.distributed as dist

    from f5_tts_tpu_torch.parallel.distributed import init_distributed
    from f5_tts_tpu_torch.parallel.mesh import make_train_mesh

    # the served mel is bitwise mesh=None's, so only the vocoder's fp32
    # convs move the wav: under cuDNN's TF32 default here and without TF32
    # in the reference, 1 int16 step in every reading but one (23)
    _fp32_as_parent(torch)
    init_distributed(f"file://{root}/pg", num_processes=2, process_id=rank, device="cuda:0",
                     backend="gloo")
    try:
        mesh = make_train_mesh(data=2)
        ref = torch.load(os.path.join(root, "ref.pt"), weights_only=True)
        ref_m = torch.load(os.path.join(root, "ref_m.pt"), weights_only=True)
        res = {}
        for name, zero1 in (("dp", False), ("zero1", True)):
            r = _par_train(torch, os.path.join(root, name), mesh=mesh, zero1=zero1)
            res[name] = {k: v for k, v in r.items() if k not in ("model", "exp_avg")}
            res[name]["max_diff"], res[name]["mean_diff"] = _param_diff(torch, r["model"], ref)
            res[name]["m_max"], res[name]["m_mean"] = _moment_diff(torch, r["exp_avg"], ref_m)
            del r
            gc.collect()
            torch.cuda.empty_cache()
        res["serve"] = _par_serve(torch, mesh)
        torch.save(res, os.path.join(root, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _ring_on_card(torch) -> dict:
    """Ring attention's per-shard body on the card at sp 2 and 4, the
    rotation in process (shard r's step s reads chunk (r - s) % sp): o and
    L against kernel C over all n, and dq, dk, dv of a loss that reads both
    against C + D + E over all n; C, D and E launch sp^2 times each."""
    from f5_tts_tpu_torch.ops import flash_attention as FA
    from f5_tts_tpu_torch.parallel.ring import ring_attention_in_process
    from f5_tts_tpu_torch.utils.device import device_ms

    b, h, n, d = RING_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(23)
    q, k, v = (torch.randn((b, h, n, d), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    lens = torch.tensor(RING_LENS, dtype=torch.int32, device="cuda")
    valid = torch.arange(n, device="cuda")[None] < lens[:, None]
    w = torch.randn((b, h, n, d), generator=gen, device="cuda") * valid[:, None, :, None]
    wl = torch.randn((b, h, n), generator=gen, device="cuda") * valid[:, None, :]

    def run(fn):
        qq, kk, vv = (t.clone().requires_grad_(True) for t in (q, k, v))
        o, L = fn(qq, kk, vv)
        loss = (o.float() * w).sum() + (L * wl).sum()
        return o.detach().float(), L.detach(), torch.autograd.grad(loss, (qq, kk, vv))

    o_ref, L_ref, g_ref = run(lambda q, k, v: FA.flash_attention_with_stats(q, k, v, lens))
    with torch.no_grad():
        c_ms = device_ms(lambda: FA.flash_attention_with_stats(q, k, v, lens), 10)
    keep = valid[:, None, :, None]
    out = {"shape": list(RING_SHAPE), "lens": list(RING_LENS), "C_over_n_ms": c_ms}
    for sp in (2, 4):
        reset_counts()
        o, L, g = run(lambda q, k, v: ring_attention_in_process(q, k, v, lens, sp, "flash",
                                                                return_lse=True))
        torch.cuda.synchronize()
        got = counts()
        launches = {x: got[x] for x in ("C", "D", "E")}
        err = (o - o_ref).abs()[keep.expand_as(o)]
        l_err = (L - L_ref).abs()[valid[:, None, :].expand_as(L)].max().item()
        g_err = {}
        for name, a, r in zip(("dq", "dk", "dv"), g, g_ref):
            scale = r.float().abs().max().item()
            e = (a.float() - r.float()).abs() / scale
            g_err[name] = (e.max().item(), e.mean().item())
        with torch.no_grad():
            ring_ms = device_ms(lambda: ring_attention_in_process(q, k, v, lens, sp, "flash"), 10)
        o_scale = o_ref.abs()[keep.expand_as(o_ref)].max().item()
        row = dict(launches=launches, o_max=err.max().item(), o_mean=err.mean().item(),
                   o_ref_max=o_scale, o_rel=(err.max().item() / o_scale,
                                             err.mean().item() / o_scale),
                   L_max=l_err, grads=g_err, fwd_ms=ring_ms)
        print(f"phase 23 ring sp {sp} {list(RING_SHAPE)} bf16 lens {list(RING_LENS)}: launches "
              f"{launches}; o vs C over n max {row['o_max']:.3e} mean {row['o_mean']:.3e} (over max "
              f"|o_ref| {o_scale:.3e}: {row['o_rel'][0]:.3e}, {row['o_rel'][1]:.3e}); L max "
              f"{l_err:.3e}; grads (max, mean over max |ref|) "
              + ", ".join(f"{k} ({a:.3e}, {m:.3e})" for k, (a, m) in g_err.items())
              + f"; forward {ring_ms:.4f} ms against C over n {c_ms:.4f} ms", flush=True)
        if launches != {"C": sp * sp, "D": sp * sp, "E": sp * sp}:
            fail(f"ring sp {sp}: launches {launches}, want {sp * sp} of C, D and E")
        if row["o_max"] > RING_O_TOL[0] or row["o_mean"] > RING_O_TOL[1] or l_err > LSE_TOL:
            fail(f"ring sp {sp}: o / L against kernel C over n: {row}")
        if any(a > RING_GRAD_TOL[0] or m > RING_GRAD_TOL[1] for a, m in g_err.values()):
            fail(f"ring sp {sp}: gradients against C + D + E over n: {g_err}")
        out[sp] = row
    return out


def phase_parallel(torch) -> dict:
    """Phase 23: the ring's per-shard body on the card; one process's update
    of ``_par_cfg`` on a global batch, the same through NCCL at world size
    1 (Trainer(mesh=make_train_mesh(data=1), zero1=True)); two gloo ranks on
    the one card (a DP and a ZeRO-1 update, then BatchServer over data = 2)
    against the one process.  Two ranks on one card share it: their wall is
    no scaling figure."""
    import gc
    import shutil
    import tempfile

    import numpy as np
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from f5_tts_tpu_torch.parallel.distributed import init_distributed
    from f5_tts_tpu_torch.parallel.mesh import make_train_mesh

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    out = {"ring": _ring_on_card(torch)}
    free()
    os.makedirs(os.path.join(REPO, ".cache"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_par_", dir=os.path.join(REPO, ".cache"))
    try:
        one = _par_train(torch, os.path.join(root, "one"))
        ref = {k: p.detach().cpu() for k, p in one.pop("model").named_parameters()}
        torch.save(ref, os.path.join(root, "ref.pt"))
        torch.save(one.pop("exp_avg"), os.path.join(root, "ref_m.pt"))
        print(f"phase 23 one process: 1 update of {PAR_ROWS} rows ({PAR_FRAMES} frames budget), "
              f"loss {one['log']['loss']:.6f}, grad norm {one['log']['grad_norm']:.6f}, "
              f"{one['wall_s']:.2f} s, launches {one['launches']}, AdamW state "
              f"{one['state_bytes']} bytes", flush=True)
        free()

        # NCCL at world size 1: the mesh path's collectives on one rank
        init_distributed(f"file://{root}/nccl_pg", num_processes=1, process_id=0, device="cuda:0")
        try:
            if dist.get_backend() != "nccl":
                fail(f"world size 1 on the card: backend {dist.get_backend()}, want nccl")
            r = _par_train(torch, os.path.join(root, "nccl"), mesh=make_train_mesh(data=1),
                           zero1=True)
        finally:
            dist.destroy_process_group()
        del r["exp_avg"]
        mx, mean = _param_diff(torch, r.pop("model"), ref)
        out["nccl"] = dict(max_diff=mx, mean_diff=mean, bitwise=mx == 0.0, loss=r["log"]["loss"],
                           grad_norm=r["log"]["grad_norm"], launches=r["launches"],
                           zero1=r["zero1"])
        print(f"phase 23 NCCL world 1 (data 1: the Trainer resolves zero1=True off, as ZeRO-1 "
              f"needs data > 1): max |p - one process| {mx:.3e}, mean {mean:.3e}, bitwise "
              f"{mx == 0.0}; loss {r['log']['loss']:.6f}", flush=True)
        if mx > 1e-6 or r["log"]["loss"] != one["log"]["loss"] or r["zero1"]:
            fail(f"NCCL world size 1 against one process: {out['nccl']}")
        free()

        serve_ref = _par_serve(torch, None)
        free()

        t0 = time.perf_counter()
        mp.start_processes(_par_rank, args=(root,), nprocs=2, start_method="spawn", join=True)
        spawn_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
                 for r in range(2)]
        depth = PAR_DEPTH
        for name in ("dp", "zero1"):
            log = ranks[0][name]["log"]
            lrel = abs(log["loss"] - one["log"]["loss"]) / abs(one["log"]["loss"])
            grel = abs(log["grad_norm"] - one["log"]["grad_norm"]) / one["log"]["grad_norm"]
            rows = [dict(max_diff=x[name]["max_diff"], mean_diff=x[name]["mean_diff"],
                         m_max=x[name]["m_max"], m_mean=x[name]["m_mean"], state_bytes=x[name]["state_bytes"], wall_s=x[name]["wall_s"],
                         launches={k: x[name]["launches"][k] for k in ("B", "C", "D", "E")})
                    for x in ranks]
            share = [x["state_bytes"] / one["state_bytes"] for x in rows]
            out[name] = dict(loss=log["loss"], loss_rel=lrel, grad_norm=log["grad_norm"],
                             grad_norm_rel=grel, ranks=rows, state_share=share)
            print(f"phase 23 gloo x2 {name}: loss {log['loss']:.6f} (rel {lrel:.2e} against one "
                  f"process), grad norm {log['grad_norm']:.6f} (rel {grel:.2e}); per rank "
                  f"{rows}; AdamW state share of one process's {share}", flush=True)
            if lrel > PAR_LOSS_REL_TOL or grel > PAR_GNORM_REL_TOL or \
                    any(x["max_diff"] > PAR_PARAM_TOL or x["m_max"] > PAR_GRAD_TOL[0]
                        or x["m_mean"] > PAR_GRAD_TOL[1] for x in rows):
                fail(f"{name} at data 2 against one process: {out[name]}")
            if any(x["launches"]["C"] != depth or x["launches"]["D"] != depth or
                   x["launches"]["E"] != depth or x["launches"]["B"] != 1 for x in rows):
                fail(f"{name}: launches per rank {[x['launches'] for x in rows]}, want C, D, E "
                     f"{depth} and B 1")
            if name == "zero1" and not all(0.5 <= s < 0.55 for s in share):
                fail(f"ZeRO-1: AdamW state share per rank {share}, want about 1/2")
        steps, mel_diff = [], []
        for x in ranks:
            sv = x["serve"]
            steps.append(max(int(np.abs(a - b).max()) if len(a) else 0
                             for a, b in zip(sv["wavs"], serve_ref["wavs"])))
            # a data rank's mel pads to its rows' bucket
            mel_diff.append(max(float(np.abs(a[:len(b)] - b).max())
                                for a, b in zip(sv["mels"], serve_ref["mels"])))
        out["serve"] = dict(max_int16_steps=steps, max_mel_diff=mel_diff,
                            launches=[x["serve"]["launches"] for x in ranks],
                            reference_launches=serve_ref["launches"],
                            wall_s=[x["serve"]["wall_s"] for x in ranks],
                            reference_wall_s=serve_ref["wall_s"], spawn_s=spawn_s)
        print(f"phase 23 BatchServer data 2 (two gloo ranks, batch 4) against mesh=None (batch "
              f"2): max int16 steps per rank {steps}, max |mel - mesh=None's| {mel_diff}; "
              f"launches per rank "
              f"{[{k: v for k, v in la.items() if v} for la in out['serve']['launches']]}, "
              f"mesh=None {({k: v for k, v in serve_ref['launches'].items() if v})}; spawn "
              f"{spawn_s:.1f} s", flush=True)
        if any(s > PAR_SERVE_WAV_STEPS for s in steps):
            fail(f"BatchServer over data 2 against mesh=None: {out['serve']}")
        for la in out["serve"]["launches"]:
            if la["A"] != depth * NFE or la["B"] != NFE:
                fail(f"BatchServer data 2: launches per rank {la}, want A {depth * NFE}, "
                     f"B {NFE}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


# parallelism over the model (phase 24).  The predictions behind the gates
# are in PERF.md, written before the first card run: the train step
# in fp32 differs from one process only where tensor parallelism splits a
# GEMM's K (the row-parallel sums) or its N and the pipeline its rows, so
# the loss moves by about 1e-7 and the gradient norm by about 1e-5 (a norm
# that counted a replicated tensor twice would move it by up to 40%, with
# the clip acting); serving runs in bf16, where the row-parallel partial
# sums are rounded before they are added, so the served mel and wav move
# as much as another bf16 rounding of the same model does: a generated-mel
# MAE of a few 1e-3 and some hundred int16 steps
MP_ROWS, MP_N, MP_MICRO = 4, 1024, 2
MP_MAX_NORM = 1e-3  # below the gradient norm: the clip acts, so a wrong norm shows
MP_LOSS_REL_TOL = 1e-5
MP_GNORM_REL_TOL = 1e-4
MP_MEL_MAE_TOL = PICARD_MEL_MAE_TOL
MP_WAV_STEPS = 100  # about 3.5x the 28 steps the card reads (PERF.md §6)
# one short request at bucket 256: tensor-parallel serving all-reduces its
# [2 rows, n, 1024] activations 1,408 times through host memory on gloo
MP_SERVE_TEXT, MP_SERVE_REF, MP_SERVE_DURATION = 40, 90, 250


def _mp_batch(torch):
    """The train step's batch on the card: seeded mel rows, text ids, lens."""
    import numpy as np

    rng = np.random.default_rng(31)
    mel = (rng.standard_normal((MP_ROWS, MP_N, 100)) * 2.0 - 5.0).astype(np.float32)
    text = rng.integers(0, 2545, (MP_ROWS, 300)).astype(np.int32)
    text[1:, 200:] = -1
    lens = np.array([MP_N, 900, 800, 1000], np.int32)
    return {k: torch.from_numpy(v).cuda() for k, v in
            (("mel", mel), ("text_ids", text), ("lens", lens))}


def _mp_step(torch, mesh=None, layout: bool = False) -> dict:
    """One ``train_step`` of full-depth F5TTS_v1_Base in fp32 (AdamW, the
    clip acting) on ``_mp_batch``; under ``mesh`` with ``ModelLayout`` and
    the pipeline's hook (``layout``): (metrics, AdamW's first moments in the
    one-device layout, launches, the model)."""
    import copy

    from f5_tts_tpu_torch.models.backbones import randomize_zero_init
    from f5_tts_tpu_torch.train import step as S

    arch = dataclasses.replace(_par_cfg().arch, depth=22)
    model = _fresh_cfm(torch, arch, 41, device="cuda")
    randomize_zero_init(model.transformer, torch.Generator().manual_seed(41))
    opt_cfg = S.OptimConfig(num_warmup_updates=0, total_updates=10, learning_rate=PAR_LR,
                            max_grad_norm=MP_MAX_NORM)
    kw, lay = {}, None
    if layout:
        from f5_tts_tpu_torch.parallel.layout import ModelLayout
        from f5_tts_tpu_torch.parallel.pipeline import make_dit_block_scan

        lay = ModelLayout(model, mesh, tensor_parallel=True, pipeline=True)
        lay.apply_(model)
        kw = dict(layout=lay, block_scan=make_dit_block_scan(arch, mesh, MP_MICRO,
                                                             backend="train_auto"))
    params = list(model.parameters()) if lay is None else lay.live_params(model)
    opt = S.make_optimizer(params, opt_cfg, layout=lay)
    ema = copy.deepcopy(model).requires_grad_(False)
    batch = _mp_batch(torch)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # cuDNN may pick a backward-filter algorithm with atomics for the convs;
    # two steps are held bitwise only under its deterministic ones, and in
    # fp32 (this process turned TF32 off in phases 2-3, the ranks start with it on)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        _, met = S.train_step(model, opt, ema, 0, batch, 41, opt_cfg, backend="train_auto",
                              **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    moments = [opt.inner.state[p]["exp_avg"] for p in params]  # on the card
    if lay is not None and lay.active:  # the one-device layout: over model and pipe
        moments = lay.gather_live(moments, batch["mel"].device)
    return dict(loss=met["loss"].item(), grad_norm=met["grad_norm"].item(), wall_s=wall,
                launches=launches, moments=moments, model=model, layout=lay)


def _mp_request(np):
    from f5_tts_tpu_torch.infer.serve import Request

    rng = np.random.default_rng(32)
    return Request(ref_mel=(rng.standard_normal((MP_SERVE_REF, 100)) - 4.0).astype(np.float32),
                   text_ids=rng.integers(0, 2545, MP_SERVE_TEXT).astype(np.int32),
                   duration=MP_SERVE_DURATION, seed=0)


def _mp_options(picard: bool):
    """NFE 32; the Picard sampler at W = 4, tol 0 when ``picard``."""
    from f5_tts_tpu_torch.infer.engine import EngineOptions

    return EngineOptions(nfe_step=NFE, time_parallel_window=PICARD_W if picard else 0,
                         picard_tol=0.0)


def _mp_engine(torch, picard: bool):
    """F5TTS_v1_Base at full depth, bf16, on seeded weights made on the card
    (the AdaLN gates and ``proj_out`` filled)."""
    from f5_tts_tpu_torch.infer.api import _seeded
    from f5_tts_tpu_torch.infer.engine import InferenceEngine
    from f5_tts_tpu_torch.models.backbones import randomize_zero_init
    from f5_tts_tpu_torch.models.vocos import Vocos

    cfg = _par_cfg()
    cfg = dataclasses.replace(cfg, arch=dataclasses.replace(cfg.arch, depth=22))
    model = _fresh_cfm(torch, cfg.arch, 7, device="cuda")
    randomize_zero_init(model.transformer, torch.Generator().manual_seed(7))
    return InferenceEngine(model, cfg, vocoder=_seeded(Vocos, 1).cuda(), dtype=torch.bfloat16,
                           options=_mp_options(picard))


def _mp_serve(torch, eng, server=None) -> dict:
    """One short request (``server.run`` or the engine's ``generate_batch``):
    its mel, int16 wav, launches and wall."""
    import numpy as np

    req = _mp_request(np)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if server is not None:
        wavs, _ = server.run([req], fetch_mel=True)
        mel = server.mels[0]
    else:
        mels, wavs, _ = eng.generate_batch([req.ref_mel], [req.text_ids], [req.duration],
                                           seeds=[req.seed])
        mel = mels[0]
    torch.cuda.synchronize()
    return dict(mel=mel, wav=np.round(wavs[0] * 32767.0).astype(np.int32), launches=counts(),
                wall_s=time.perf_counter() - t0)


def _fp32_as_parent(torch) -> None:
    """A spawned rank's fp32 matmuls and convolutions without TF32, as this
    script's process runs them since phases 2-3 (the vocoder's convs, fp32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _mp_serve_rank(rank: int, root: str) -> None:
    """One of two gloo ranks: tensor-parallel serving at model 2, then
    Picard over data 2."""
    import gc

    import torch
    import torch.distributed as dist

    from f5_tts_tpu_torch.infer.serve import BatchServer
    from f5_tts_tpu_torch.parallel.distributed import init_distributed
    from f5_tts_tpu_torch.parallel.mesh import make_mesh

    _fp32_as_parent(torch)
    init_distributed(f"file://{root}/pg_serve", num_processes=2, process_id=rank,
                     device="cuda:0", backend="gloo")
    try:
        eng = _mp_engine(torch, picard=False)
        srv = BatchServer(eng, mesh=make_mesh(data=1, model=2), batch_size=1,
                          tensor_parallel=True)
        heads = {m.to_q.weight.shape[0] // 64 for m in eng.model.modules()
                 if type(m).__name__ == "Attention"}
        res = {"tp": dict(_mp_serve(torch, eng, srv), heads=sorted(heads),
                          eager=eng._collective())}
        del eng, srv
        gc.collect()
        torch.cuda.empty_cache()
        eng = _mp_engine(torch, picard=True)
        eng.enable_time_parallel(make_mesh(data=2))
        res["picard"] = _mp_serve(torch, eng)
        torch.save(res, os.path.join(root, f"serve{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _mp_train_rank(rank: int, root: str) -> None:
    """One of four gloo ranks: the train step at data 1 x pipe 2 x model 2,
    then two ``train/cli.py`` runs at PAR_DEPTH (pp 2 x sp 2; ZeRO-1 with
    Adafactor at data 2 x model 2)."""
    import gc

    import numpy as np
    import torch
    import torch.distributed as dist

    from f5_tts_tpu_torch.parallel.distributed import init_distributed
    from f5_tts_tpu_torch.parallel.mesh import make_train_mesh

    _fp32_as_parent(torch)
    # train/cli.py reads torchrun's environment, as under torchrun
    os.environ.update(WORLD_SIZE="4", RANK=str(rank), LOCAL_RANK="0")
    init_distributed(f"file://{root}/pg_train", num_processes=4, process_id=rank,
                     device="cuda:0", backend="gloo")
    try:
        r = _mp_step(torch, make_train_mesh(data=1, pipe=2, model=2), layout=True)
        lay = r.pop("layout")
        res = {"step": {k: v for k, v in r.items() if k not in ("model", "moments")},
               "stage": lay.stage, "tp_rank": lay.tp_rank,
               "heads": sorted({m.to_q.weight.shape[0] // 64 for m in r["model"].modules()
                                if type(m).__name__ == "Attention" and m.to_q.weight.numel()})}
        if rank == 0:
            ref_m = torch.load(os.path.join(root, "ref_m.pt"), map_location="cuda",
                               weights_only=True)
            res["step"]["m_max"], res["step"]["m_mean"] = _moment_diff(torch, r["moments"],
                                                                       ref_m)
        del r, lay
        gc.collect()
        torch.cuda.empty_cache()

        from f5_tts_tpu_torch.text.tokenizer import get_tokenizer
        from f5_tts_tpu_torch.train import cli as TCLI
        from f5_tts_tpu_torch.train import dataset as TDS
        from f5_tts_tpu_torch.train import trainer as TT

        vocab, _ = get_tokenizer(None, "pinyin")
        TDS.load_dataset = lambda *a, **k: _par_dataset(np, vocab)
        real, seen = TT.Trainer, []

        class Recording(real):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                seen.append(self)

        TT.Trainer = Recording
        for name, flags, extra in (
                ("pp_sp", ["--pipeline_parallel", "2", "--sequence_parallel", "2"], []),
                ("zero1_adafactor", ["--tensor_parallel", "2", "--zero1"],
                 ["++optim.optimizer=adafactor"])):
            ck = os.path.join(root, f"cli_{name}")
            reset_counts()
            t0 = time.perf_counter()
            TCLI.main(["--model", "F5TTS_v1_Base", "--device", "cuda", "--epochs", "1",
                       "--ckpt_dir", ck, "--batch_size_per_gpu", str(PAR_FRAMES),
                       "--learning_rate", str(PAR_LR), "--num_warmup_updates", "1", *flags,
                       f"model.arch.depth={PAR_DEPTH}", "++ckpts.last_per_updates=1000000",
                       *extra])
            torch.cuda.synchronize()
            tr = seen[-1]
            log = [json.loads(x) for x in open(tr.log_file)] if rank == 0 else []
            res[name] = dict(wall_s=time.perf_counter() - t0, launches=counts(),
                             mesh=[list(tr.mesh.mesh_dim_names), list(tr.mesh.shape)],
                             state_bytes=tr.optimizer.state_bytes(),
                             one_device_bytes=_adafactor_bytes(tr),
                             micro=tr.pipeline_microbatches, zero1=tr.zero1,
                             remat=tr.model_cfg.arch.checkpoint_activations,
                             log=log[-1] if log else None)
            del tr
            seen.clear()
            gc.collect()
            torch.cuda.empty_cache()
        TT.Trainer = real
        torch.save(res, os.path.join(root, f"train{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _adafactor_bytes(tr) -> int | None:
    """Adafactor's state bytes for the trainer's model on one device (its
    factored row and column statistics, or a whole one), fp32; None for
    AdamW."""
    import math

    from f5_tts_tpu_torch.train.step import Adafactor

    if tr.opt_cfg.optimizer != "adafactor":
        return None
    total = 0
    for shape in tr.layout.shapes.values():
        dims = Adafactor.factored_dims(shape)
        n = math.prod(shape)
        total += n if dims is None else n // shape[dims[1]] + n // shape[dims[0]]
    return 4 * total


def _mel_mae(a, b) -> float:
    import numpy as np

    return float(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)).mean())


def _wav_steps(a, b) -> int:
    import numpy as np

    n = min(len(a), len(b))
    return int(np.abs(a[:n] - b[:n]).max()) if n else 0


def phase_model_parallel(torch) -> dict:
    """Phase 24 (module docstring): one process's full-depth train step,
    the same at NCCL world size 1 through the new code paths, the one-device
    serving references; two gloo ranks (tensor-parallel serving, Picard over
    data); four gloo ranks (the tp x pp train step, the CLI runs)."""
    import gc
    import shutil
    import tempfile

    import numpy as np
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from f5_tts_tpu_torch.parallel.distributed import init_distributed
    from f5_tts_tpu_torch.parallel.mesh import make_train_mesh

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    out = {}
    os.makedirs(os.path.join(REPO, ".cache"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_mp_", dir=os.path.join(REPO, ".cache"))
    try:
        one = _mp_step(torch)
        torch.save(one["moments"], os.path.join(root, "ref_m.pt"))
        ref_params = {k: p.detach().clone() for k, p in one.pop("model").named_parameters()}
        print(f"phase 24 one process: train_step of F5TTS_v1_Base (22 blocks) on {MP_ROWS} x "
              f"{MP_N} frames, fp32: loss {one['loss']:.7f}, grad norm {one['grad_norm']:.6f} "
              f"(clip at {MP_MAX_NORM}), {one['wall_s']:.2f} s, launches "
              f"{ {k: v for k, v in one['launches'].items() if v} }", flush=True)
        free()

        init_distributed(f"file://{root}/nccl_pg", num_processes=1, process_id=0, device="cuda:0")
        try:
            if dist.get_backend() != "nccl":
                fail(f"world size 1 on the card: backend {dist.get_backend()}, want nccl")
            r = _mp_step(torch, make_train_mesh(data=1, pipe=1, model=1), layout=True)
        finally:
            dist.destroy_process_group()
        got = dict(r.pop("model").named_parameters())
        bitwise = all(torch.equal(got[k].detach(), v) for k, v in ref_params.items())
        same_m = all(torch.equal(a, b) for a, b in zip(r["moments"], one.pop("moments")))
        out["nccl"] = dict(bitwise=bitwise, moments_bitwise=same_m, loss=r["loss"],
                           grad_norm=r["grad_norm"], layout_active=r["layout"].active)
        print(f"phase 24 NCCL world 1 (pipe 1, model 1: ModelLayout and the pipeline hook at "
              f"one stage): parameters bitwise {bitwise}, first moments bitwise {same_m}, loss "
              f"{r['loss']:.7f}, grad norm {r['grad_norm']:.6f}", flush=True)
        if not (bitwise and same_m and r["loss"] == one["loss"]
                and r["grad_norm"] == one["grad_norm"]):
            fail(f"NCCL world size 1 through the new paths against one process: {out['nccl']}")
        del r, got, ref_params
        free()

        refs = {}
        eng = _mp_engine(torch, False)
        for name, picard in (("tp", False), ("picard", True)):
            eng.options = _mp_options(picard)
            _mp_serve(torch, eng)  # the key's first hit: an eager call, the capture
            refs[name] = _mp_serve(torch, eng)
        del eng
        free()

        # the two serving ranks and the four training ranks at once, each set
        # in its own gloo group: they share the card and the host
        t0 = time.perf_counter()
        serving = mp.start_processes(_mp_serve_rank, args=(root,), nprocs=2,
                                     start_method="spawn", join=False)
        training = mp.start_processes(_mp_train_rank, args=(root,), nprocs=4,
                                      start_method="spawn", join=False)
        try:
            while not serving.join():
                pass
            out["serve_spawn_s"] = time.perf_counter() - t0
            while not training.join():
                pass
            out["train_spawn_s"] = time.perf_counter() - t0
        finally:  # a failed set leaves no rank of the other behind
            for p in serving.processes + training.processes:
                if p.is_alive():
                    p.terminate()
                    p.join(30)
        ranks = [torch.load(os.path.join(root, f"serve{r}.pt"), weights_only=False)
                 for r in range(2)]
        depth = 22
        for name, want_a in (("tp", depth * NFE), ("picard", depth * NFE)):
            rows = []
            for x in ranks:
                g = x[name]
                rows.append(dict(mel_mae=_mel_mae(g["mel"], refs[name]["mel"]),
                                 wav_steps=_wav_steps(g["wav"], refs[name]["wav"]),
                                 A=g["launches"]["A"], B=g["launches"]["B"], wall_s=g["wall_s"],
                                 **({"heads": g["heads"], "eager": g["eager"]}
                                    if name == "tp" else {})))
            out[name] = dict(ranks=rows, reference_wall_s=refs[name]["wall_s"],
                             reference_launches={k: refs[name]["launches"][k] for k in "AB"})
            print(f"phase 24 {'BatchServer model 2' if name == 'tp' else 'Picard data 2'} (two "
                  f"gloo ranks, eager) against the one-device engine: per rank {rows}; one "
                  f"device A {refs[name]['launches']['A']} B {refs[name]['launches']['B']}, "
                  f"{refs[name]['wall_s']:.2f} s", flush=True)
            for x in rows:
                if x["mel_mae"] > MP_MEL_MAE_TOL or x["wav_steps"] > MP_WAV_STEPS:
                    fail(f"{name}: against the one-device engine {rows}")
                if x["A"] != want_a or x["B"] != NFE:
                    fail(f"{name}: launches per rank A {x['A']} B {x['B']}, want {want_a}, {NFE}")
            if name == "tp" and any(x["heads"] != [8] or not x["eager"] for x in rows):
                fail(f"tensor-parallel serving: heads per rank / eager {rows}")
        ranks = [torch.load(os.path.join(root, f"train{r}.pt"), weights_only=False)
                 for r in range(4)]
        st = ranks[0]["step"]
        lrel = abs(st["loss"] - one["loss"]) / abs(one["loss"])
        grel = abs(st["grad_norm"] - one["grad_norm"]) / one["grad_norm"]
        per_rank = [dict(stage=x["stage"], tp_rank=x["tp_rank"], heads=x["heads"],
                         wall_s=x["step"]["wall_s"],
                         launches={k: x["step"]["launches"][k] for k in ("B", "C", "D", "E")})
                    for x in ranks]
        out["step"] = dict(loss=st["loss"], loss_rel=lrel, grad_norm=st["grad_norm"],
                           grad_norm_rel=grel, m_max=st["m_max"], m_mean=st["m_mean"],
                           ranks=per_rank, one_wall_s=one["wall_s"])
        print(f"phase 24 train_step data 1 x pipe 2 x model 2 (four gloo ranks, {MP_MICRO} "
              f"microbatches): loss {st['loss']:.7f} (rel {lrel:.2e}), grad norm "
              f"{st['grad_norm']:.6f} (rel {grel:.2e}), first moments (max, mean over max |ref|) "
              f"({st['m_max']:.3e}, {st['m_mean']:.3e}); per rank {per_rank}", flush=True)
        if lrel > MP_LOSS_REL_TOL or grel > MP_GNORM_REL_TOL or st["m_max"] > PAR_GRAD_TOL[0] \
                or st["m_mean"] > PAR_GRAD_TOL[1]:
            fail(f"tp x pp train step against one process: {out['step']}")
        want = depth // 2 * MP_MICRO
        for x in per_rank:
            la = x["launches"]
            if (la["C"], la["D"], la["E"], la["B"]) != (want, want, want, 1) or x["heads"] != [8]:
                fail(f"tp x pp: per rank {x}, want C, D, E {want}, B 1, 8 heads")
        for name in ("pp_sp", "zero1_adafactor"):
            rows = [x[name] for x in ranks]
            log = rows[0]["log"]
            out[name] = dict(log=log, ranks=[{k: v for k, v in x.items() if k != "log"}
                                             for x in rows])
            print(f"phase 24 train/cli.py {name} at {PAR_DEPTH} blocks: loss {log['loss']:.6f}, "
                  f"grad norm {log['grad_norm']:.6f}; per rank "
                  f"{[{k: v for k, v in x.items() if k != 'log'} for x in rows]}", flush=True)
            if not (log["update"] == 1 and np.isfinite(log["loss"])
                    and np.isfinite(log["grad_norm"])):
                fail(f"{name}: {log}")
            for x in rows:
                c = x["launches"]
                if name == "pp_sp":  # 2 blocks a stage, 8 microbatches, 2 ring steps each
                    base = PAR_DEPTH // 2 * x["micro"] * 2
                    ok = x["mesh"] == [["data", "pipe", "seq", "model"], [1, 2, 2, 1]]
                else:
                    base = PAR_DEPTH
                    ok = x["mesh"] == [["data", "model"], [2, 2]] and x["zero1"]
                if not ok or (c["C"], c["D"], c["E"]) != (base, base, base):
                    fail(f"{name}: per rank {x}, want C, D, E {base}")
            if name == "zero1_adafactor":
                share = [x["state_bytes"] / x["one_device_bytes"] for x in rows]
                out[name]["state_share"] = share
                print(f"phase 24 ZeRO-1 Adafactor at data 2: state bytes per rank "
                      f"{[x['state_bytes'] for x in rows]}, share of one device's "
                      f"{rows[0]['one_device_bytes']}: {share}", flush=True)
                if not all(0.5 <= x < 0.55 for x in share):
                    fail(f"ZeRO-1 Adafactor: state share per rank {share}, want about 1/2")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


# ---------------------------------------------------------------- phase 25
# the tooling slice: Picard AOT bundles, the eval batch synthesis, ECAPA on
# the card, the request profile
TOOL_BUCKET = 512  # the Picard bundle's bucket and the profiled request's
TOOL_REF_BUCKET = 256  # the wav entry's ref bucket
TOOL_TOLS = (0.0, 1e-3)  # picard_tol: exact steps, and JAX's default
TOOL_ENTRIES = {0.0: ("wav", "mel"), 1e-3: ("wav",)}  # the entries each bundle holds
EVAL_UTTS, EVAL_BATCH = 4, 2
ECAPA_COS_MIN = 0.9999  # per embedding, card against the CPU


def _tool_requests(np):
    """The wav request (250 ref frames: ref bucket 256) and mel request of
    the Picard bundle, both at bucket 512."""
    from f5_tts_tpu_torch.audio.io import load_wav

    wav, _ = load_wav(REF_WAV)
    wav = np.tile(wav, -(-250 * 256 // len(wav)))[: 250 * 256]
    rng = np.random.default_rng(25)
    ids = rng.integers(0, 2545, 120).astype(np.int32)
    mel_ref = rng.standard_normal((200, 100)).astype(np.float32)
    return {"wav": lambda eng: eng.generate_batch_from_wav(wav, [ids], [500], seeds=[3]),
            "mel": lambda eng: eng.generate_batch([mel_ref], [ids], [500], seeds=[3])}


def _counting(owner, *names):
    """Count every call of ``owner``'s functions ``names`` (a module's or a
    class's); returns (the list the calls append to, the undo)."""
    calls, saved = [], {n: getattr(owner, n) for n in names}
    for n, fn in saved.items():
        setattr(owner, n, lambda *a, fn=fn, **k: calls.append(1) or fn(*a, **k))

    def undo():
        for n, fn in saved.items():
            setattr(owner, n, fn)

    return calls, undo


def _backbone_calls():
    """Count every Python DiT forward (``dit.forward``, ``dit.forward_cfg``)."""
    from f5_tts_tpu_torch.models import dit

    return _counting(dit, "forward", "forward_cfg")


def _picard_bundles(torch, root: str) -> dict:
    """One Picard bundle per tolerance (the entries of ``TOOL_ENTRIES``),
    exported with W1, served with W2 against the live Picard engine on W2:
    mel and int16 wav bitwise, equal sweeps and A / B launches, no backbone
    forward at load or serve; the export seconds, bundle bytes and
    replayed walls."""
    import copy
    import gc

    import numpy as np

    from f5_tts_tpu_torch.infer.api import _seeded
    from f5_tts_tpu_torch.infer.engine import EngineOptions, InferenceEngine
    from f5_tts_tpu_torch.models.configs import MODEL_CONFIGS
    from f5_tts_tpu_torch.models.vocos import Vocos
    from f5_tts_tpu_torch.runtime import aot

    cfg = MODEL_CONFIGS["F5TTS_v1_Base"]
    depth = cfg.arch.depth
    w1, w2 = _w(torch, cfg, 0), _w(torch, cfg, 5)
    voc = _seeded(Vocos, 1).cuda()
    reqs = _tool_requests(np)
    spec = {"wav": ("wav", 1, TOOL_BUCKET, TOOL_REF_BUCKET), "mel": ("mel", 1, TOOL_BUCKET, None)}

    def options(tol):
        return EngineOptions(nfe_step=NFE, time_parallel_window=PICARD_W, picard_tol=tol)

    # one engine per weight set; each tolerance is its options (a key of its own)
    e1, live = (InferenceEngine(copy.deepcopy(w).cuda(), cfg, vocoder=voc, dtype=torch.bfloat16,
                                options=options(TOOL_TOLS[0])) for w in (w1, w2))
    out = {}
    for tol in TOOL_TOLS:
        d = os.path.join(root, f"picard_tol{tol:g}")
        e1.options = live.options = options(tol)
        t0 = time.perf_counter()
        aot.export_engine(e1, d, [spec[e] for e in TOOL_ENTRIES[tol]])
        export_s = time.perf_counter() - t0
        meta = aot.read_meta(d)
        calls, undo = _backbone_calls()
        try:
            t0 = time.perf_counter()
            bundle = aot.AotEngine(d, copy.deepcopy(w2).cuda(), cfg, vocoder=voc)
            load_s = time.perf_counter() - t0
            load_forwards = len(calls)
            r = {"export_s": export_s, "load_s": load_s, "bundle_bytes": aot.bundle_bytes(d),
                 "export_seconds": meta["export_seconds"],
                 "program_bytes": {k: v["bytes"] for k, v in meta["programs"].items()},
                 "load_forwards": load_forwards}
            for entry in TOOL_ENTRIES[tol]:
                req = reqs[entry]
                n0 = len(calls)
                req(bundle)  # the key's first hit: the eager call and the capture
                capture_forwards = len(calls) - n0
                req(live)
                n0 = len(calls)
                got = req(bundle)
                serve_forwards = len(calls) - n0
                want = req(live)
                same = bool(np.array_equal(got[0], want[0])
                            and np.array_equal(got[1][0], want[1][0]) and got[2] == want[2])
                launches = {}
                for tag, eng in (("live", live), ("aot", bundle)):
                    reset_counts()
                    req(eng)
                    torch.cuda.synchronize()
                    c = counts()
                    launches[tag] = {"A": c["A"], "B": c["B"], "sweeps": eng.last_sweeps}
                sweeps = launches["live"]["sweeps"]
                r[entry] = {"bitwise": same, "sweeps": sweeps, "launches": launches,
                            "capture_forwards": capture_forwards, "serve_forwards": serve_forwards,
                            "mel_max_abs": float(np.abs(got[0] - want[0]).max())}
                print(f"phase 25 Picard bundle tol {tol:g} {entry} entry (W1 bundle served with "
                      f"W2 vs the live Picard engine on W2): bitwise {same}, sweeps "
                      f"{launches['aot']['sweeps']} / {sweeps}, launches {launches}, backbone "
                      f"forwards at load {load_forwards}, at the capture {capture_forwards}, in a "
                      f"replayed call {serve_forwards}",
                      flush=True)
                if not same or launches["aot"] != launches["live"] \
                        or launches["aot"]["A"] != depth * sweeps \
                        or launches["aot"]["B"] != sweeps or load_forwards or serve_forwards \
                        or capture_forwards \
                        or (tol == 0.0 and sweeps != NFE):
                    fail(f"Picard bundle tol {tol:g} {entry}: {r[entry]}, load forwards "
                         f"{load_forwards}")
            walls = {tag: _wall_ms(torch, lambda e=eng: reqs["wav"](e))
                     for tag, eng in (("live", live), ("aot", bundle))}
            r["wall_ms"] = walls
            print(f"phase 25 Picard bundle tol {tol:g}: export {export_s:.1f} s (per program "
                  f"{({k: round(v, 1) for k, v in meta['export_seconds'].items()})}), "
                  f"{r['bundle_bytes']} bytes, load {load_s:.2f} s; wav request wall (ms, 3 "
                  f"replays) bundle {[round(x, 1) for x in walls['aot']]} against live "
                  f"{[round(x, 1) for x in walls['live']]}", flush=True)
        finally:
            undo()
        out[f"tol_{tol:g}"] = r
        del bundle
        gc.collect()
        torch.cuda.empty_cache()
    del e1, live
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _eval_meta(np, root: str) -> str:
    """A seeded seedtts ``meta.lst`` of ``EVAL_UTTS`` utterances under
    ``root/seedtts_testset/en`` (prompts cut from the example clip, one
    made quiet so the RMS rescale runs); returns the metalist root."""
    from f5_tts_tpu_torch.audio.io import load_wav, save_wav

    d = os.path.join(root, "data", "seedtts_testset", "en")
    os.makedirs(d)
    speech, sr = load_wav(REF_WAV)
    words = ["morning", "river", "quiet", "signal", "garden", "window", "bright", "answer"]
    rng = np.random.default_rng(25)
    lines = []
    for i in range(EVAL_UTTS):
        clip = speech[i * sr // 3: i * sr // 3 + int((2.0 + 0.3 * i) * sr)]
        save_wav(os.path.join(d, f"p{i}.wav"), clip * (0.3 if i == 1 else 1.0), sr)
        text = " ".join(words[j] for j in rng.integers(0, len(words), 8 + 2 * i))
        lines.append(f"utt{i}|{REF_TEXT}|p{i}.wav|{text}.\n")
    with open(os.path.join(d, "meta.lst"), "w", encoding="utf-8") as f:
        f.writelines(lines)
    return os.path.join(root, "data")


def _eval_batch(torch, root: str) -> tuple:
    """``eval_infer_batch.main`` on the seeded list (F5TTS_v1_Base, seeded,
    NFE 32, batch 2) against ``BatchServer(mesh=None)`` on the same
    requests and weights: four wavs and ``rtf.txt``, each file bitwise; A
    and B launches of its own run, depth x NFE and NFE per engine
    call (each replay, and the eager call of each key's capture).  Returns
    (the record, the reference ``F5TTS``)."""
    import numpy as np

    from f5_tts_tpu_torch.audio.io import save_wav
    from f5_tts_tpu_torch.eval import eval_infer_batch
    from f5_tts_tpu_torch.eval.testsets import get_seedtts_testset_metainfo, prepare_eval_prompts
    from f5_tts_tpu_torch.infer.api import F5TTS
    from f5_tts_tpu_torch.infer.engine import InferenceEngine
    from f5_tts_tpu_torch.infer.serve import BatchServer, Request

    data = _eval_meta(np, root)
    captures, undo = _counting(InferenceEngine, "_capture", "_capture_picard")
    try:
        reset_counts()
        t0 = time.perf_counter()
        out_dir = eval_infer_batch.main(["-t", "seedtts_test_en", "-n", "F5TTS_v1_Base",
                                         "--init_random", "-nfe", str(NFE), "-s", "7",
                                         "--metalst_root", data, "--batch_size", str(EVAL_BATCH),
                                         "--results_root", os.path.join(root, "results")])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = counts()
    finally:
        undo()
    n_calls = -(-EVAL_UTTS // EVAL_BATCH)  # BatchServer's batches: one engine call each
    runs = n_calls + len(captures)
    per_call = {"A": c["A"] / runs, "B": c["B"] / runs}
    files = sorted(os.listdir(out_dir))
    want_files = ["rtf.txt"] + [f"utt{i}.wav" for i in range(EVAL_UTTS)]
    tts = F5TTS(model="F5TTS_v1_Base", init_random=True, nfe_step=NFE)
    depth = tts.model_cfg.arch.depth
    prompts = prepare_eval_prompts(
        get_seedtts_testset_metainfo(os.path.join(data, "seedtts_testset", "en", "meta.lst")),
        tts.engine, tts.vocab, tts.tokenizer)
    reqs = [Request(ref_mel=p.ref_mel, text_ids=p.text_ids, duration=p.duration, seed=7)
            for p in prompts]
    wavs, _ = BatchServer(tts.engine, mesh=None, batch_size=EVAL_BATCH).run(reqs)
    ref_dir = os.path.join(root, "reference")
    os.makedirs(ref_dir)
    same = []
    for p, wav in zip(prompts, wavs):
        if 0 < p.ref_rms < 0.1:
            wav = wav * (p.ref_rms / 0.1)
        save_wav(os.path.join(ref_dir, p.utt + ".wav"), wav, tts.target_sample_rate)
        with open(os.path.join(ref_dir, p.utt + ".wav"), "rb") as a, \
                open(os.path.join(out_dir, p.utt + ".wav"), "rb") as b:
            same.append(a.read() == b.read())
    rtf = open(os.path.join(out_dir, "rtf.txt")).read().splitlines()
    launches = {"A": c["A"], "B": c["B"]}
    r = {"files": files, "bitwise": same, "wall_s": wall, "launches": launches,
         "engine_calls": n_calls, "captures": len(captures), "launches_per_call": per_call,
         "durations": [p.duration for p in prompts], "rtf_txt": rtf}
    print(f"phase 25 eval_infer_batch (F5TTS_v1_Base, NFE {NFE}, batch {EVAL_BATCH}, "
          f"{EVAL_UTTS} utterances, durations {r['durations']}): {wall:.1f} s, files {files}, "
          f"each wav bitwise BatchServer(mesh=None)'s: {same}; its launches {launches} (want "
          f"{depth} x {NFE} and {NFE} x ({n_calls} engine calls + {len(captures)} captures' "
          f"eager calls)), per call {per_call}; rtf.txt {rtf}", flush=True)
    if files != want_files or not all(same) or not captures \
            or launches != {"A": depth * NFE * runs, "B": NFE * runs}:
        fail(f"eval batch: {r}")
    return r, tts


def _ecapa(torch) -> dict:
    """One seeded ECAPA-TDNN forward (``feat_type`` features, random BN
    statistics) on the card and on the CPU: cosine similarity per embedding."""
    from f5_tts_tpu_torch.eval.ecapa_tdnn import ECAPA_TDNN_SMALL

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(25)
        model = ECAPA_TDNN_SMALL(feat_dim=1024, feat_type="features").eval()
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                m.running_mean.normal_(0.0, 0.1)
                m.running_var.uniform_(0.5, 2.0)
        feats = torch.randn(4, 300, 1024)
    with torch.no_grad():
        cpu = model(feats)
        card = model.cuda()(feats.cuda()).cpu()
    cos = torch.nn.functional.cosine_similarity(card, cpu, dim=-1).tolist()
    print(f"phase 25 ECAPA-TDNN (features [4, 300, 1024], emb 256) card vs CPU: cosine per "
          f"embedding {cos}, max abs {(card - cpu).abs().max().item():.3e}", flush=True)
    if not (card.shape == (4, 256) and min(cos) >= ECAPA_COS_MIN):
        fail(f"ECAPA card vs CPU: cosine {cos} < {ECAPA_COS_MIN}")
    return {"cosine": cos, "max_abs": (card - cpu).abs().max().item()}


def phase_tooling(torch) -> dict:
    """Phase 25 (module docstring): Picard bundles, the eval batch driver,
    ECAPA on the card, the request profile."""
    import gc
    import shutil
    import tempfile

    from f5_tts_tpu_torch.scripts import profile_request

    os.makedirs(os.path.join(REPO, ".cache"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_tool_", dir=os.path.join(REPO, ".cache"))
    out = {}
    try:
        t0 = time.perf_counter()
        out["picard_bundle"] = _picard_bundles(torch, root)
        out["picard_bundle_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["eval"], tts = _eval_batch(torch, root)
        out["eval_s"] = time.perf_counter() - t0
        out["ecapa"] = _ecapa(torch)
        t0 = time.perf_counter()
        prof = profile_request.profile(tts.engine, TOOL_BUCKET, 1, reps=3,
                                       trace_dir=os.path.join(root, "trace"))
        out["profile_s"] = time.perf_counter() - t0
        print(f"phase 25 profile_request (F5TTS_v1_Base, bucket {TOOL_BUCKET}, batch 1, NFE "
              f"{NFE}, replayed graph; medians of 3): "
              + ", ".join(f"{k} {v:.3f}" for k, v in prof.items() if v is not None), flush=True)
        if not (prof["compute_ms"] > 0 and prof["device_ms"]):
            fail(f"profile_request: {prof}")
        out["profile"] = prof
        del tts
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


NARROW_DEPTH = {"F5TTS_v1_Small": 18, "E2TTS_Small": 20}
SPEAK_ARGS = ["--heads", "2", "--files", "128", "--max-updates", "24", "--eval-every", "24",
              "--n-eval", "8", "--fresh"]
PICARD_ARGS = ["--epochs", "2", "--tols", "1e-3", "--iters", "2"]


def _narrow_serving(torch) -> dict:
    """F5TTS_v1_Small (dh 64, 48-channel groups) serves one replayed request:
    A depth x NFE per engine call, B none, no tap copies frozen."""
    import numpy as np

    from f5_tts_tpu_torch.infer.api import F5TTS

    tts = F5TTS(model="F5TTS_v1_Small", init_random=True)
    depth = tts.model_cfg.arch.depth
    quiet = lambda *a, **k: None  # noqa: E731
    t0 = time.perf_counter()
    tts.infer(REF_WAV, REF_TEXT, SHORT_TEXT, show_info=quiet, seed=7)  # captures the key
    first_s = time.perf_counter() - t0
    calls = _recorded_run(tts.engine)
    reset_counts()
    t0 = time.perf_counter()
    wav, sr, _ = tts.infer(REF_WAV, REF_TEXT, SHORT_TEXT, show_info=quiet, seed=7)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    la = counts()
    del tts.engine._run
    taps = [m.taps for m in tts.engine.model.modules() if hasattr(m, "freeze_taps")]
    out = dict(depth=depth, engine_calls=len(calls), launches=la, graphs=len(tts.engine.graphs),
               audio_s=len(wav) / sr, first_s=first_s, replayed_s=wall,
               a_per_step=la["A"] / max(len(calls) * NFE, 1))
    print(f"phase 26 F5TTS_v1_Small request (bf16, NFE {NFE}, replayed): {len(calls)} engine "
          f"call(s), A {la['A']} ({out['a_per_step']:.0f} per NFE step), B {la['B']}, "
          f"{out['audio_s']:.2f} s of audio, first hit {first_s:.2f} s, replayed {wall:.3f} s",
          flush=True)
    if not calls or la["A"] != depth * NFE * len(calls) or la["B"] != 0:
        fail(f"F5TTS_v1_Small request launches {la} over {len(calls)} calls, want A "
             f"{depth} x {NFE} per call and no B")
    if not np.isfinite(wav).all() or not len(wav) or any(t is not None for t in taps):
        fail("F5TTS_v1_Small request: non-finite wav, or tap copies frozen for a plain width")
    del tts
    torch.cuda.empty_cache()
    return out


def _narrow_forwards(torch) -> dict:
    """F5TTS_v1_Small forward_cfg and E2TTS_Small forward_cfg, fp32, n 256:
    card (A, the plain ConvPositionEmbedding) against the CPU."""
    import copy

    from f5_tts_tpu_torch.models import unett as U
    from f5_tts_tpu_torch.models.configs import MODEL_CONFIGS

    out = {}
    cfg, model, run = _full_width_dit(torch, "F5TTS_v1_Small")
    got, want, la, t_card, t_cpu = _card_vs_cpu(torch, copy.deepcopy(model).cuda(), run)
    rel = ((got - want).abs().max() / want.abs().max()).item()
    out["F5TTS_v1_Small"] = dict(rel=rel, launches={k: la[k] for k in ("A", "B")})
    gen = torch.Generator().manual_seed(41)
    b, n = 2, 256
    mask = torch.arange(n)[None, :] < torch.tensor([[256], [201]])
    x, cond = (torch.randn((b, n, 100), generator=gen) for _ in range(2))
    times = torch.tensor([0.3, 0.7])
    ucfg = MODEL_CONFIGS["E2TTS_Small"].arch
    text = torch.randint(0, ucfg.text_num_embeds, (b, 90), generator=gen).to(torch.int32)

    def run_unett(m, dev):
        with torch.inference_mode():
            tt, xx, cc, ts, mm = (t.to(dev) for t in (text, x, cond, times, mask))
            te_c = U.text_embedding(m, ucfg, tt, n)
            te_u = U.text_embedding(m, ucfg, tt, n, drop_text=True)
            pred, null = U.forward_cfg(m, ucfg, xx, cc, te_c, te_u, ts, mask=mm)
            return torch.cat([pred, null]).float().cpu()

    ugot, uwant, ula, ut_card, ut_cpu = _card_vs_cpu(torch, _fresh_backbone(torch, ucfg, 43),
                                                     run_unett)
    urel = ((ugot - uwant).abs().max() / uwant.abs().max()).item()
    out["E2TTS_Small"] = dict(rel=urel, launches={k: ula[k] for k in ("A", "B")})
    for name, (r, launched, ok) in {"F5TTS_v1_Small": (rel, la, torch.isfinite(got).all()),
                                    "E2TTS_Small": (urel, ula, torch.isfinite(ugot).all())}.items():
        print(f"phase 26 {name} forward_cfg fp32 n={n}: rel err {r:.3e} (tol "
              f"{FULL_WIDTH_REL_TOL}); launches A {launched['A']} B {launched['B']}", flush=True)
        if (launched["A"], launched["B"]) != (NARROW_DEPTH[name], 0):
            fail(f"{name} forward launches {launched}, want A {NARROW_DEPTH[name]}, B 0")
        if not ok or r > FULL_WIDTH_REL_TOL:
            fail(f"{name} forward: card and CPU disagree (rel {r})")
    return out


def _narrow_smoke(torch, root: str) -> dict:
    """``scripts/smoke.py --device cuda``: F5TTS_Tiny end to end."""
    from f5_tts_tpu_torch.scripts import smoke

    reset_counts()
    res = smoke.main([os.path.join(root, "smoke.wav"), "--device", "cuda"])
    la = res["launches"]
    a, b = la.get("flash_attention_fwd", 0), la.get("fused_convpos_fwd", 0)
    print(f"phase 26 smoke.py --device cuda (F5TTS_Tiny, dh 64, 4-channel groups): A {a}, B {b}",
          flush=True)
    if not a or b or not len(res["wav"]):
        fail(f"smoke on the card: launches {la}, want A and no B")
    return dict(launches=la, audio_s=len(res["wav"]) / res["sr"])


def _narrow_breakdown(torch, root: str) -> dict:
    """``bench_step_breakdown``: ``step`` (A, B), ``profile`` and
    ``profile_train 8 1024`` (B, C, D, E), few iterations, both tables."""
    from f5_tts_tpu_torch.scripts import bench_step_breakdown as BSB

    reset_counts()
    out = {"step": BSB.bench_step(iters=5)}
    reset_counts()
    out["profile"] = BSB.profile_step(iters=3, trace_dir=os.path.join(root, "prof"))
    reset_counts()
    out["profile_train"] = BSB.profile_train(8, 1024, "dots_flash", iters=2,
                                             trace_dir=os.path.join(root, "prof_train"))
    la, lt = out["step"]["launches"], out["profile_train"]["launches"]
    if not (la.get("flash_attention_fwd") and la.get("fused_convpos_fwd")):
        fail(f"bench_step_breakdown step launches {la}, want A and B")
    want = ("fused_convpos_fwd", "flash_attention_fwd_stats", "flash_attention_bwd_dq",
            "flash_attention_bwd_dkv")
    if not all(lt.get(k) for k in want):
        fail(f"bench_step_breakdown profile_train launches {lt}, want B, C, D and E")
    for k in ("profile", "profile_train"):
        top = out[k]["rows"][:3]
        out[k] = {key: v for key, v in out[k].items() if key != "rows"}
        out[k]["top3"] = [(r["name"][:60], round(r["ms"], 3), r["count"]) for r in top]
    return out


def _narrow_probes(torch, root: str) -> dict:
    """The speak probe at dh 64 (C, D, E in training, A in its evals and the
    engine pass) and the Picard probe at full width (B, C, D, E per
    micro-step; A depth and B one per sweep; sweeps at most NFE)."""
    import math

    from f5_tts_tpu_torch.scripts import train_picard_probe as PP
    from f5_tts_tpu_torch.scripts import train_speak_probe as SP

    out = {}
    reset_counts()
    t0 = time.perf_counter()
    sp = SP.main(SPEAK_ARGS + ["--ckpt-dir", os.path.join(root, "sp_ck"), "--out",
                               os.path.join(root, "sp.pt"), "--data-dir",
                               os.path.join(root, "sp_ds")])
    out["speak_s"] = time.perf_counter() - t0
    la, depth, ups = sp["launches"], sp["arch"]["depth"], sp["launches"]["train_updates"]
    tr, eng = la["train"], la["engine"]
    out["speak"] = {k: sp[k] for k in ("cer_curve", "engine_cer", "order_sensitivity_mse")}
    out["speak"]["launches"] = la
    print(f"phase 26 speak probe --heads 2: {ups} updates in {la['train_wall_s']:.1f} s, "
          f"launches {json.dumps(la)}; CER curve {sp['cer_curve']}, engine CER "
          f"{sp['engine_cer']}", flush=True)
    cde = [tr.get(k, 0) for k in ("flash_attention_fwd_stats", "flash_attention_bwd_dq",
                                  "flash_attention_bwd_dkv")]
    a_eng = eng.get("flash_attention_fwd", 0)
    if cde != [depth * ups] * 3 or tr.get("fused_convpos_fwd", 0) or not ups:
        fail(f"speak probe training launches {tr}, want C, D, E {depth} x {ups} and no B")
    if not a_eng or a_eng % (depth * sp["nfe"]) or not la["eval"].get("flash_attention_fwd"):
        fail(f"speak probe evals {la['eval']} / engine {eng}: want A in both, depth x NFE "
             "per engine call")
    if not os.path.isfile(sp["params"]) or not math.isfinite(sp["engine_cer"]):
        fail("speak probe: no params file or a non-finite engine CER")
    reset_counts()
    t0 = time.perf_counter()
    pp = PP.main(PICARD_ARGS + ["--out", os.path.join(root, "pp.pt"), "--data-dir",
                                os.path.join(root, "pp_ds")])
    out["picard_s"] = time.perf_counter() - t0
    s, reps = pp["summary"], pp["reports"]
    la, depth, micro = s["launches"], s["depth"], s["launches"]["train_micro_steps"]
    per = {k: la["train"].get(n, 0) / micro for k, n in (
        ("B", "fused_convpos_fwd"), ("C", "flash_attention_fwd_stats"),
        ("D", "flash_attention_bwd_dq"), ("E", "flash_attention_bwd_dkv"))}
    out["picard"] = dict(summary=s, reports=reps, per_micro=per)
    print(f"phase 26 Picard probe --epochs 2: {micro} micro-steps in {la['train_wall_s']:.1f} s, "
          f"per micro-step {per}; {json.dumps(reps)}", flush=True)
    if per["B"] != 1 or per["D"] != depth or per["E"] != depth or per["C"] not in (depth,
                                                                                   2 * depth):
        fail(f"Picard probe training launches per micro-step {per}, want B 1, C {depth} or "
             f"{2 * depth}, D and E {depth}")
    for tol, rec in la["picard"].items():
        sw = rec["sweeps"]
        if not 1 <= sw <= s["sequential_worst_case"] or rec.get("flash_attention_fwd") != \
                depth * sw or rec.get("fused_convpos_fwd") != sw:
            fail(f"Picard probe at tol {tol}: {rec}, want A {depth} and B 1 per sweep, "
                 f"sweeps <= NFE")
    return out


def phase_narrow(torch) -> dict:
    """Phase 26 (module docstring): the narrow configurations on the card,
    the step breakdown, the two probes."""
    import shutil
    import tempfile

    os.makedirs(os.path.join(REPO, ".cache"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_narrow_", dir=os.path.join(REPO, ".cache"))
    out, laps = {}, {}
    try:
        for key, fn in (("serving", lambda: _narrow_serving(torch)),
                        ("forwards", lambda: _narrow_forwards(torch)),
                        ("smoke", lambda: _narrow_smoke(torch, root)),
                        ("breakdown", lambda: _narrow_breakdown(torch, root)),
                        ("probes", lambda: _narrow_probes(torch, root))):
            t0 = time.perf_counter()
            out[key] = fn()
            laps[key] = time.perf_counter() - t0
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = laps
    print(f"phase 26 parts (s): {json.dumps(laps)}", flush=True)
    return out


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
    graphs = phase_graphs(torch)  # counts set to 0 before the serving layers' requests
    lap("18 (CUDA graphs, serving layers)")
    print(f"summary: graphs {graphs}", flush=True)
    bigvgan = phase_bigvgan(torch)  # counts set to 0 before the replays it counts
    lap("19 (BigVGAN, bigvgan mel, Picard)")
    print(f"summary: BigVGAN and Picard {bigvgan}", flush=True)
    train_rest = phase_train_rest(torch)  # counts set to 0 before each remat cell
    lap("20 (remat matrix, Adafactor, in-graph mel, async saves, spread)")
    print(f"summary: the rest of training {train_rest}", flush=True)
    phase_allocator(torch, train_rest["spread"])
    lap("21 (the spread with expandable segments)")
    print(f"summary: W8A8 serving {w8a8}; W8A8 full-width {w8a8_full}", flush=True)
    runtime = phase_runtime(torch, LIBRARY.build_seconds)  # counts set to 0 before each path
    lap("22 (runtime: benchmark, bench_train, AOT bundles, cold start)")
    print(f"summary: runtime {json.dumps(runtime)}", flush=True)
    par = phase_parallel(torch)  # counts set to 0 before each update, ring and served pass
    lap("23 (ring on the card, NCCL at world 1, DP / ZeRO-1 / DP serving on two gloo ranks)")
    print(f"summary: parallel {json.dumps(par, default=str)}", flush=True)
    mpar = phase_model_parallel(torch)  # counts set to 0 before each step, request and CLI run
    lap("24 (model parallel: NCCL at world 1, TP serving, Picard over data, tp x pp step, CLI)")
    print(f"summary: model parallel {json.dumps(mpar, default=str)}", flush=True)
    tool = phase_tooling(torch)  # counts set to 0 before each counted call
    lap("25 (Picard AOT bundles, eval batch, ECAPA, request profile)")
    print(f"summary: tooling {json.dumps(tool, default=str)}", flush=True)
    narrow = phase_narrow(torch)  # counts set to 0 before each counted run
    lap("26 (narrow configurations, step breakdown, speak and Picard probes)")
    print(f"summary: narrow {json.dumps(narrow, default=str)}", flush=True)
    # the card and the build again, where the end of a long output still shows them
    print(f"card: {smi}; kernels built in {LIBRARY.build_seconds or 0.0:.1f} s; phases done in "
          f"{time.perf_counter() - t_start:.1f} s after the build", flush=True)

    aot_launches = runtime["aot"]["launches"]

    def entry(name, source, replaces, launches, err, rows, config, key):
        r = next(r for r in rows if r["n"] == 1024)  # the 1024-frame bucket
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": err, "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"], "shape_n": 1024, "config": list(config),
                "over_library": r["over_library"], "configs_ms": r["configs_ms"],
                "aot_launches_per_call": aot_launches["aot"][key]}

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

    # phase 20: kernel C's launches per micro-step under each remat policy
    remat_launches = {k: v["per_micro"]["C"] for k, v in train_rest["matrix"].items()
                      if isinstance(v, dict)}
    fa = "f5_tts_tpu_torch/csrc/flash_attention.cu"
    fab = "f5_tts_tpu_torch/csrc/flash_attention_bwd.cu"
    kernels = [
        entry("flash_attention_fwd", fa, "f5_tts_tpu/ops/flash_attention.py:150", launches_a,
              flash_err, flash_rows, FA.FWD_CONFIG, "A"),
        entry("fused_convpos_fwd", "f5_tts_tpu_torch/csrc/fused_convpos.cu",
              "f5_tts_tpu/ops/fused_convpos.py:37", launches_b, conv_err, conv_rows, FC.CONFIG,
              "B"),
        dict(train_entry("flash_attention_fwd_stats", "C", "C_plain", "C_lib",
                         "f5_tts_tpu/ops/flash_attention.py:45", train["launches"]["C"], fa),
             launches_per_micro_step_by_remat_policy=remat_launches),
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
         "launches_from": "one W8A8 F5TTS_v1_Base engine call, NFE 32",
         "aot_launches_per_call": aot_launches["aot_w8a8"]["G"]},
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
    # phase 23: the ring's launches (the per-shard body at sp 2 and 4) and
    # each data rank's in the two-rank DP runs
    ring = {f"sp{sp}": par["ring"][sp]["launches"] for sp in (2, 4)}
    dp_rank = {name: [r["launches"] for r in par[name]["ranks"]] for name in ("dp", "zero1")}
    for entry_ in kernels:
        key = {"flash_attention_fwd_stats": "C", "flash_attention_bwd_dq": "D",
               "flash_attention_bwd_dkv": "E"}.get(entry_["name"])
        if key:
            entry_["ring_launches"] = {sp: la[key] for sp, la in ring.items()}
            entry_["data_parallel_launches_per_rank"] = {n: [la[key] for la in v]
                                                         for n, v in dp_rank.items()}
        elif entry_["name"] in ("flash_attention_fwd", "fused_convpos_fwd"):
            k = "A" if entry_["name"] == "flash_attention_fwd" else "B"
            entry_["data_parallel_serving_launches_per_rank"] = [
                la[k] for la in par["serve"]["launches"]]
            if k == "B":
                entry_["data_parallel_launches_per_rank"] = {n: [la["B"] for la in v]
                                                             for n, v in dp_rank.items()}
    # phase 24: launches per rank under tensor parallelism, the pipeline and Picard over data
    for entry_ in kernels:
        key = {"flash_attention_fwd": "A", "fused_convpos_fwd": "B",
               "flash_attention_fwd_stats": "C", "flash_attention_bwd_dq": "D",
               "flash_attention_bwd_dkv": "E"}.get(entry_["name"])
        if key in ("A", "B"):
            entry_["model_parallel_serving_launches_per_rank"] = {
                n: [x[key] for x in mpar[n]["ranks"]] for n in ("tp", "picard")}
        if key in ("B", "C", "D", "E"):
            entry_["model_parallel_train_launches_per_rank"] = {
                "tp2_pp2_step": [x["launches"][key] for x in mpar["step"]["ranks"]],
                **{n: [x["launches"][key] for x in mpar[n]["ranks"]]
                   for n in ("pp_sp", "zero1_adafactor")}}
    # phase 25: launches per call of the Picard bundles (and their sweeps)
    # and of the eval batch synthesis
    for entry_ in kernels:
        key = {"flash_attention_fwd": "A", "fused_convpos_fwd": "B"}.get(entry_["name"])
        if key:
            entry_["picard_bundle_launches_per_call"] = {
                f"{t}_{e}": {"launches": tool["picard_bundle"][t][e]["launches"]["aot"][key],
                             "sweeps": tool["picard_bundle"][t][e]["sweeps"]}
                for t, tol in (("tol_0", 0.0), ("tol_0.001", 1e-3)) for e in TOOL_ENTRIES[tol]}
            entry_["eval_batch_launches"] = tool["eval"]["launches"][key]
            entry_["eval_batch_launches_per_call"] = tool["eval"]["launches_per_call"][key]
    # phase 26: launches on the narrow configurations' paths and the probes
    sp = narrow["probes"]["speak"]["launches"]
    pp = narrow["probes"]["picard"]["summary"]["launches"]
    for entry_ in kernels:
        name = entry_["name"]
        if name in ("flash_attention_fwd", "fused_convpos_fwd"):
            key = "A" if name == "flash_attention_fwd" else "B"
            entry_["narrow_launches"] = {
                "F5TTS_v1_Small_request": narrow["serving"]["launches"][key],
                "F5TTS_Tiny_smoke": narrow["smoke"]["launches"].get(name, 0),
                "speak_probe_engine": sp["engine"].get(name, 0),
                "picard_probe_sweeps": {t: r.get(name, 0) for t, r in pp["picard"].items()}}
        if name in ("fused_convpos_fwd", "flash_attention_fwd_stats", "flash_attention_bwd_dq",
                    "flash_attention_bwd_dkv"):
            entry_.setdefault("narrow_launches", {}).update(
                speak_probe_train=sp["train"].get(name, 0),
                picard_probe_train=pp["train"].get(name, 0))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
