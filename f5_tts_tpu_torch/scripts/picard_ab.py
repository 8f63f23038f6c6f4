"""A/B the time-parallel (Picard) ODE sampler against the sequential NFE loop.

JAX counterpart: ``scripts/picard_ab.py``.  Two engines on the same seeded
weights (the zero-initialized projections filled, as JAX's script fills
them), the same prompt and the same seeds: the serial wall and RTF of each
(after a first call, which on the card captures the key's graphs), the mel
MAE between them, and the sweeps the Picard engine took
(``engine.last_sweeps``).  On one device the window puts W steps on the
matmul's M axis but pays more than one forward per accepted step, so this
is a latency lever only across devices; the script records the one-device
number.

    python -m f5_tts_tpu_torch.scripts.picard_ab [--nfe 16] [--window 8] \
        [--tol 1e-3] [--iters 6] [--device cpu]
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time

import numpy as np


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="picard_ab")
    ap.add_argument("--nfe", type=int, default=16)
    ap.add_argument("--window", type=int, default=8)
    ap.add_argument("--tol", type=float, default=1e-3)
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--model", default="F5TTS_v1_Base")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from f5_tts_tpu_torch.infer.api import _seeded
    from f5_tts_tpu_torch.infer.engine import EngineOptions, InferenceEngine
    from f5_tts_tpu_torch.models.backbones import randomize_zero_init
    from f5_tts_tpu_torch.models.cfm import CFM
    from f5_tts_tpu_torch.models.configs import MODEL_CONFIGS
    from f5_tts_tpu_torch.models.vocos import Vocos
    from f5_tts_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device, "picard_ab")
    model_cfg = MODEL_CONFIGS[args.model]
    on_card = dev.type == "cuda"
    dtype = torch.bfloat16 if on_card else torch.float32
    model = _seeded(lambda: CFM(model_cfg.arch), 0)
    randomize_zero_init(model.transformer, torch.Generator().manual_seed(100))
    voc = _seeded(Vocos, 1).to(dev)

    rng = np.random.default_rng(0)
    ref_frames, duration = (282, 1023) if on_card else (64, 255)
    ref = rng.standard_normal((ref_frames, model_cfg.mel.n_mel_channels)).astype(np.float32)
    text = rng.integers(0, 2545, size=min(180, duration // 2)).astype(np.int32)
    sr = model_cfg.mel.target_sample_rate

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    results = {}
    seq_tag, pic_tag = "sequential", f"picard_w{args.window}"
    for tag, window in ((seq_tag, 0), (pic_tag, args.window)):
        eng = InferenceEngine(copy.deepcopy(model).to(dev), model_cfg, vocoder=voc, dtype=dtype,
                              options=EngineOptions(nfe_step=args.nfe,
                                                    time_parallel_window=window,
                                                    picard_tol=args.tol))
        mels, wavs, _ = eng.generate_batch([ref], [text], [duration], seeds=[0])  # capture
        sweeps = eng.last_sweeps
        sync()
        t0 = time.perf_counter()
        for i in range(args.iters):
            _, wavs, _ = eng.generate_batch([ref], [text], [duration], seeds=[i + 1],
                                            fetch_mel=False)
        sync()
        wall = (time.perf_counter() - t0) / args.iters
        audio_s = len(wavs[0]) / sr
        results[tag] = {"wall_ms": wall * 1e3, "rtf": wall / audio_s, "mel": mels[0],
                        "sweeps": sweeps}
        print(f"{tag}: {wall * 1000:.1f} ms/utt -> RTF {wall / audio_s:.4f}", file=sys.stderr)
        del eng

    sweeps = results[pic_tag]["sweeps"]
    mae = float(np.abs(results[seq_tag]["mel"] - results[pic_tag]["mel"]).mean())
    rep = {
        "metric": f"picard_ab_nfe{args.nfe}_w{args.window}",
        "wall_ms_sequential": results[seq_tag]["wall_ms"],
        "wall_ms_picard": results[pic_tag]["wall_ms"],
        "rtf_sequential": results[seq_tag]["rtf"],
        "rtf_picard": results[pic_tag]["rtf"],
        "speedup": results[seq_tag]["rtf"] / results[pic_tag]["rtf"],
        "sweeps": sweeps,
        "evals_per_step": sweeps * min(args.window, args.nfe) / args.nfe,
        "mel_mae": mae,
        "tol": args.tol,
        "device": str(dev),
    }
    print(json.dumps(rep))
    return rep


if __name__ == "__main__":
    main()
