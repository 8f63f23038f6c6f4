"""What bounds kernel H: timing-only variants of its source, on the card.

Each variant is ``csrc/flash_attention_pipelined.cu`` with one part taken
out or changed, built beside a copy of ``common.cuh`` by the port's
``KernelLibrary`` into the git-ignored ``_build/variants/<name>/`` (one
nvcc each, all at once) and timed (device time per call,
``utils.device.device_ms``) at [2, 16, 1024, 64] lens {1024, 824} and
[2, 16, 4096, 64] lens {4096, 4059}, at ``exp_pipelined_flash.CONFIG``,
beside the kernel as built:

- ``no_softmax``: no max, exp2 or sums but the last tile's (the products
  and the TMA feed alone);
- ``no_exp2``: the softmax without its exp2s (p = s - m);
- ``no_pingpong``: the named-barrier turn removed;
- ``cubic_none``, ``cubic_1_4``, ``cubic_1_8``: exp2 on the FMA pipe for
  no score block, one in 4 or one in 8 (the kernel: one in 16);
- ``fa3_order``: FA3's order, S_{j+1} issued with P_j.V_j in one turn and
  S_{j+1}'s softmax under P_j.V_j (the kernel, the TPU experiment's order:
  S_{j+1} issued, S_j's softmax under it, then P_j.V_j in a second turn).

Results of the first three are wrong by design; every other variant's
error against the plain version is printed.  ``trace`` adds ``clock64``
reads around each phase of a consumer's step in one block and prints the
mean clocks per phase.  Run on the card, as two rounds:

    python -m f5_tts_tpu_torch.scripts.exp_pipelined_flash_variants
"""

from __future__ import annotations

import ctypes
import os
import shutil
from concurrent.futures import ThreadPoolExecutor

import torch

from f5_tts_tpu_torch.ops.cuda_build import BUILD_DIR, CSRC_DIR, KernelLibrary
from f5_tts_tpu_torch.ops.flash_attention import HEAD_DIM, LOG2E, flash_attention_plain
from f5_tts_tpu_torch.scripts import exp_pipelined_flash as XH

SOURCE = XH.KERNEL.source
VARIANTS_DIR = os.path.join(BUILD_DIR, "variants")

EXP2 = "s[4 * j + e] = fma_pipe ? exp2_cubic(x) : fast_exp2(x);"
TURN_BEGIN = "{ named_bar_sync(BAR_TURN + c, CONSUMERS); }"
TURN_END = "    named_bar_arrive(BAR_TURN + 1 - c, CONSUMERS);\n  }"
SOFTMAX = "    softmax<false>(cur, j * BK, a_lo, a_hi);  // under S_{j+1}\n"
STEP = "  __device__ __forceinline__ void step(float (&cur)[NS], float (&nxt)[NS], int j) {\n"
STEP_PHASES = [  # (the statement in step() a clock read follows, in order; the phase it ends)
    ("    turn_begin();\n", "TMA wait for K + turn"),
    (SOFTMAX, "issue S_{j+1} + softmax of S_j"),
    ("    hold(nxt);\n", "wait for S_{j+1}"),
    ("    pack_rescale(cur, a_lo, a_hi);\n", "pack + rescale"),
    ("    turn_begin();\n", "TMA wait for V + turn"),
    ("    hold(pa);\n", "issue + wait for P.V"),
]
# FA3's order: run()'s key loop after S_0 has landed, and its step
RUN_LOOP = """    release(&bars->k_empty[0]);
    int j = 0;
    for (; j + 2 < n; j += 2) {  // S_j in sa, then in sb
      step(sa, sb, j);
      step(sb, sa, j + 1);
    }
    if (j + 1 < n) {
      step(sa, sb, j);
      last(sb, j + 1);
    } else {
      last(sa, j);
    }
"""
RUN_LOOP_FA3 = """    float a_lo, a_hi;
    release(&bars->k_empty[0]);
    softmax_any(sa, 0, a_lo, a_hi);
    pack_rescale(sa, a_lo, a_hi);
    for (int j = 0; j + 2 < n; ++j) fa3_step<false>(j);
    if (n >= 2) {  // the last tile, which may lie across kv_len
      if (n * BK <= kv_len) {
        fa3_step<false>(n - 2);
      } else {
        fa3_step<true>(n - 2);
      }
    }
    last_pv(n - 1);
"""
# S_{j+1} and P_j.V_j issued in one turn, S_{j+1}'s softmax under P_j.V_j.
# On entry P_j is packed and O rescaled, nothing in flight; j + 1 < n.
STEP_FA3 = """  template <bool MASK>
  __device__ __forceinline__ void fa3_step(int j) {
    land_k(j + 1);
    land_v(j);
    turn_begin();
    wg_fence();
    issue_scores(sa, j + 1);
    issue_pv(j);
    turn_end();
    wg_wait<1>();
    hold(sa);
    release(&bars->k_empty[(j + 1) % S]);
    float a_lo, a_hi;
    softmax<MASK>(sa, (j + 1) * BK, a_lo, a_hi);  // under P_j.V_j
    wg_wait<0>();
    hold(acc);
    hold(pa);
    release(&bars->v_empty[j % S]);
    pack_rescale(sa, a_lo, a_hi);
  }

"""
RUN = "  __device__ __forceinline__ void run(const unsigned char* sq) {\n"
TRACE_POINTS = len(STEP_PHASES) + 1


def _replace(src: str, old: str, new: str) -> str:
    if old not in src:
        raise RuntimeError(f"kernel H's source changed; update the variant: {old!r}")
    return src.replace(old, new)


def variants(src: str) -> dict[str, str]:
    out = {"kernel": src}
    out["no_softmax"] = _replace(src, SOFTMAX, "    a_lo = a_hi = 1.f;\n")
    out["no_exp2"] = _replace(src, EXP2, "s[4 * j + e] = x;")
    v = _replace(src, TURN_BEGIN, "{}")
    v = _replace(v, TURN_END, "  }")
    out["no_pingpong"] = _replace(v, "if (c == 1) named_bar_arrive(BAR_TURN, CONSUMERS);", "")
    for name, every in (("cubic_none", 1 << 20), ("cubic_1_4", 4), ("cubic_1_8", 8)):
        out[name] = _replace(src, "constexpr int kCubicEvery = 16;",
                             f"constexpr int kCubicEvery = {every};")
    v = _replace(src, RUN_LOOP, RUN_LOOP_FA3)
    out["fa3_order"] = _replace(v, RUN, STEP_FA3 + RUN)
    # the trace: clock64 after each phase of step(), read unconditionally (a
    # branch inside an open wgmma group would serialise the kernel) and stored
    # for block (5, 7), lane 0 of every consumer warp, once every group retired
    head, rest = src.split(STEP, 1)
    body, tail = rest.split("\n  }\n", 1)
    body = "    const long long t0 = clock64();\n" + body + "\n"
    pos = 0
    for i, (stmt, _) in enumerate(STEP_PHASES):
        k = body.find(stmt, pos)
        if k < 0:
            raise RuntimeError(f"kernel H's source changed; update the trace: {stmt!r}")
        k += len(stmt)
        clock = f"    const long long t{i + 1} = clock64();\n"
        body = body[:k] + clock + body[k:]
        pos = k + len(clock)
    body += ("\n    if (blockIdx.x == 5 && blockIdx.y == 7 && lane == 0) {\n"
             "      long long* tr = g_trace[c][(threadIdx.x >> 5) & 3][j & 63];\n"
             + "".join(f"      tr[{i}] = t{i};\n" for i in range(len(STEP_PHASES) + 1))
             + "    }\n")
    t = head + STEP + body + "  }\n" + tail
    t = _replace(t, "namespace {\n", f"__device__ long long g_trace[2][4][64][{TRACE_POINTS}];\n"
                 "namespace {\n")
    out["trace"] = t + ('\nextern "C" int read_trace(void* host) {\n'
                        "  return static_cast<int>(cudaMemcpyFromSymbol(host, g_trace, "
                        "sizeof(g_trace)));\n}\n")
    return out


def _build_one(name: str, text: str) -> KernelLibrary:
    src_dir = os.path.join(VARIANTS_DIR, name, "src")
    os.makedirs(src_dir, exist_ok=True)
    shutil.copy(os.path.join(CSRC_DIR, "common.cuh"), src_dir)
    with open(os.path.join(src_dir, SOURCE), "w") as f:
        f.write(text)
    lib = KernelLibrary(csrc_dir=src_dir, build_dir=os.path.join(VARIANTS_DIR, name, "out"))
    lib.lib(SOURCE)
    return lib


def build(srcs: dict[str, str]) -> dict[str, ctypes.CDLL]:
    """Every variant built at once; one that fails to build is reported and
    left out."""
    with ThreadPoolExecutor(len(srcs)) as pool:
        futures = {name: pool.submit(_build_one, name, text) for name, text in srcs.items()}
    libs = {}
    for name, fut in futures.items():
        try:
            built = fut.result()
        except RuntimeError as e:
            print(f"variant {name}: not built: {e}", flush=True)
            continue
        if "Potential Performance Loss" in built.build_log:
            print(f"variant {name}: ptxas serialised its wgmma", flush=True)
        lib = built.lib(SOURCE)
        fn = getattr(lib, XH.KERNEL.name)  # H's C signature, as the wrapper declares it
        fn.argtypes = XH.KERNEL.argtypes
        fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> None:
    import numpy as np

    from f5_tts_tpu_torch.utils.device import card_name_and_power_limit, device_ms

    if not torch.cuda.is_available():
        raise SystemExit("exp_pipelined_flash_variants needs a CUDA card")
    print(card_name_and_power_limit())
    with open(os.path.join(CSRC_DIR, SOURCE)) as f:
        libs = build(variants(f.read()))
    gen = torch.Generator(device="cuda").manual_seed(0)
    cfg = XH.CONFIG
    for n, lens_l in ((1024, [1024, 824]), (4096, [4096, 4059])):
        q, k, v = (torch.randn((2, 16, n, HEAD_DIM), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
        want = flash_attention_plain(q.float(), k.float(), v.float(), lens)
        bms, by = XH.bound_ms(2, 16, n, lens_l)
        for rnd in range(2):
            for name, lib in libs.items():
                out = torch.empty_like(q)

                def call(fn=getattr(lib, XH.KERNEL.name), out=out):
                    code = fn(
                        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), out.data_ptr(),
                        2, 16, n, *cfg, HEAD_DIM ** -0.5 * LOG2E,
                        torch.cuda.current_stream().cuda_stream)
                    if code:
                        raise RuntimeError(f"variant {name}: CUDA error {code}")

                call()
                torch.cuda.synchronize()
                err = (out.float() - want).abs().max().item()
                ms = device_ms(call, 50 if n == 1024 else 10)
                print(f"[2, 16, {n}, 64] round {rnd} {name}: {ms:.4f} ms, {bms / ms:.1%} of the "
                      f"{bms:.4f} ms bound ({by}), max abs err {err:.2e}", flush=True)
                if name == "trace" and rnd == 1:
                    buf = np.zeros((2, 4, 64, TRACE_POINTS), dtype=np.int64)
                    if lib.read_trace(ctypes.c_void_p(buf.ctypes.data)):
                        raise RuntimeError("reading the trace failed")
                    steps = min(n // cfg[1] - 1, 64)  # the steps of one block
                    for c in range(2):
                        d = buf[c, :, :steps]
                        ph = np.diff(d, axis=2).mean(axis=(0, 1))
                        per = np.diff(d[:, :, 0], axis=1).mean()
                        lag = (buf[c, :, 0, 0] - buf[0, :, 0, 0]).mean()
                        print(f"  consumer {c}: {per:.0f} clocks a step, "
                              + ", ".join(f"{p} {x:.0f}" for (_, p), x in zip(STEP_PHASES, ph))
                              + f"; first step {lag:.0f} clocks after consumer 0's", flush=True)


if __name__ == "__main__":
    main()
