"""Cold start: a card-warmed AOT bundle against a cold live engine.

JAX counterpart: ``scripts/aot_coldstart_ab.py``.  Three stages:

  stage 1 (this process): export the programs of F5TTS_v1_Base (seeded
      weights, bf16) at mel b1@1024 and wav b1@1024/r512, and package the
      compiled kernels with them (``warm_artifacts``): the deploy-time cost.
  stage 2 (a fresh process): ``AotEngine`` load and the first synthesized
      utterance, in a process where ``nvcc`` cannot be found (``PATH``
      without it, ``CUDA_HOME`` an empty directory) and the package's build
      directory is empty, so the kernels can only come from the bundle.
  stage 3 (a fresh process): the same for a cold live ``InferenceEngine``
      with the kernel build cache present.

Each child counts the calls of the backbone's Python ``forward`` (the AOT
child must make none), reports whether it built a kernel
(``LIBRARY.build_seconds``) and whether it could find ``nvcc``.  Time to
first audio = load + first call; the weights' seeded construction is not
counted in either.

    python -m f5_tts_tpu_torch.scripts.aot_coldstart_ab [--out DIR] [--nfe 16]

Prints one JSON line: build_s, warm_s, cold_load_s, cold_first_call_s, and
the same for the live engine.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
MODEL = "F5TTS_v1_Base"
SPECS = [("mel", 1, 1024, None), ("wav", 1, 1024, 512)]

CHILD = r"""
import json, os, sys, time
sys.path.insert(0, os.environ["AB_ROOT"])
import numpy as np
import torch
from f5_tts_tpu_torch.infer.api import _seeded
from f5_tts_tpu_torch.infer.engine import EngineOptions, InferenceEngine
from f5_tts_tpu_torch.models import dit
from f5_tts_tpu_torch.models.cfm import CFM
from f5_tts_tpu_torch.models.configs import MODEL_CONFIGS
from f5_tts_tpu_torch.models.vocos import Vocos
from f5_tts_tpu_torch.ops import cuda_build

forwards = [0]
inner = dit.forward


def counted(*a, **k):
    forwards[0] += 1
    return inner(*a, **k)


dit.forward = counted  # every backbone forward of a DiT goes through it
cfg = MODEL_CONFIGS[os.environ["AB_MODEL"]]
model = _seeded(lambda: CFM(cfg.arch), 0).cuda()
voc = _seeded(Vocos, 1).cuda()
torch.cuda.synchronize()
t0 = time.perf_counter()
if os.environ["AB_MODE"] == "aot":
    from f5_tts_tpu_torch.runtime.aot import AotEngine

    eng = AotEngine(os.environ["AB_OUT"], model, cfg, vocoder=voc, warmup=False)
else:
    eng = InferenceEngine(model, cfg, vocoder=voc, dtype=torch.bfloat16,
                          options=EngineOptions(nfe_step=int(os.environ["AB_NFE"])))
torch.cuda.synchronize()
load_s = time.perf_counter() - t0
rng = np.random.default_rng(0)
ref = rng.standard_normal((282, cfg.mel.n_mel_channels)).astype(np.float32)
text = rng.integers(0, 2545, size=180).astype(np.int32)
t0 = time.perf_counter()
mels, wavs, gf = eng.generate_batch([ref], [text], [1023], seeds=[0])
first_s = time.perf_counter() - t0
t0 = time.perf_counter()
eng.generate_batch([ref], [text], [1023], seeds=[1], fetch_mel=False)
second_s = time.perf_counter() - t0
try:
    cuda_build.find_nvcc()
    nvcc = True
except RuntimeError:
    nvcc = False
print(json.dumps({"load_s": load_s, "first_call_s": first_s, "second_call_s": second_s,
                  "backbone_forwards": forwards[0],
                  "built_kernels": cuda_build.LIBRARY.build_seconds is not None,
                  "nvcc_found": nvcc, "prebuilt": cuda_build.LIBRARY.prebuilt,
                  "finite": bool(np.isfinite(wavs[0]).all()),
                  "audio_s": len(wavs[0]) / cfg.mel.target_sample_rate}))
"""


def _child(mode: str, out: str, nfe: int, env_extra: dict) -> dict:
    env = dict(os.environ, AB_ROOT=ROOT, AB_OUT=out, AB_MODE=mode, AB_NFE=str(nfe),
               AB_MODEL=MODEL, **env_extra)
    proc = subprocess.run([sys.executable, "-c", CHILD], env=env, capture_output=True,
                          text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{mode} child failed:\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _no_nvcc_env(tmp: str) -> dict:
    """``PATH`` without any directory holding ``nvcc``, ``CUDA_HOME`` an
    empty directory, and an empty kernel build directory."""
    path = [d for d in os.environ.get("PATH", "").split(os.pathsep)
            if d and not os.path.exists(os.path.join(d, "nvcc"))]
    empty_home, empty_build = os.path.join(tmp, "cuda_home"), os.path.join(tmp, "build")
    os.makedirs(empty_home)
    os.makedirs(empty_build)
    return {"PATH": os.pathsep.join(path), "CUDA_HOME": empty_home,
            "F5TTS_KERNEL_BUILD_DIR": empty_build}


def run(out: str, nfe: int = 16, skip_build: bool = False) -> dict:
    """The three stages; ``skip_build`` reuses a bundle already at ``out``
    (its kernels packaged)."""
    import torch

    from f5_tts_tpu_torch.infer.engine import EngineOptions
    from f5_tts_tpu_torch.runtime.aot import (
        build_engine,
        bundle_bytes,
        export_engine,
        warm_artifacts,
    )

    build_s = warm_s = None
    if not skip_build:
        eng = build_engine(MODEL, options=EngineOptions(nfe_step=nfe))
        t0 = time.perf_counter()
        export_engine(eng, out, SPECS)
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        n = warm_artifacts(out)
        warm_s = time.perf_counter() - t0
        print(f"exported {len(SPECS)} operating points in {build_s:.1f}s, packaged {n} kernel "
              f"libraries in {warm_s:.1f}s", file=sys.stderr)
        del eng
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        aot = _child("aot", out, nfe, _no_nvcc_env(tmp))
    live = _child("live", out, nfe, {})
    return {"metric": "aot_coldstart", "model": MODEL, "nfe": nfe, "build_s": build_s,
            "warm_s": warm_s, "bundle_bytes": bundle_bytes(out),
            "cold_load_s": aot["load_s"], "cold_first_call_s": aot["first_call_s"],
            "cold_second_call_s": aot["second_call_s"],
            "cold_first_audio_s": aot["load_s"] + aot["first_call_s"],
            "aot_backbone_forwards": aot["backbone_forwards"],
            "aot_built_kernels": aot["built_kernels"], "aot_nvcc_found": aot["nvcc_found"],
            "aot_kernels_from": aot["prebuilt"], "aot_finite": aot["finite"],
            "live_load_s": live["load_s"], "live_first_call_s": live["first_call_s"],
            "live_second_call_s": live["second_call_s"],
            "live_first_audio_s": live["load_s"] + live["first_call_s"],
            "live_backbone_forwards": live["backbone_forwards"],
            "live_built_kernels": live["built_kernels"], "audio_s": aot["audio_s"]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="bundle directory (a temporary one if unset)")
    ap.add_argument("--nfe", type=int, default=16)
    ap.add_argument("--skip-build", action="store_true", help="reuse the bundle at --out")
    args = ap.parse_args(argv)
    if args.out:
        rep = run(args.out, args.nfe, args.skip_build)
    else:
        with tempfile.TemporaryDirectory() as out:
            rep = run(out, args.nfe)
    print(json.dumps(rep))
    return rep


if __name__ == "__main__":
    main()
