"""A/B the W8A8 int8 serving option against the dense engine on the card.

JAX counterpart: ``scripts/quant_ab.py``.  Two ``InferenceEngine``s of
F5TTS_v1_Base hold the same random weights (the zero-initialized AdaLN
tables, final norm and ``proj_out`` randomized, so that the blocks'
quantized contribution reaches the mel); one is built with
``EngineOptions(quantize=True)``.  Both serve the same prompt with the same
seeds.  Quality gate: the mel MAE between the two must stay under
``--mel-mae-gate`` (log-mel units).  Prints one JSON line with both RTFs,
their ratio and the MAE; the card's name and power limit go to stderr with
the per-engine times.

    python -m f5_tts_tpu_torch.scripts.quant_ab [--nfe 16] [--iters 8] [--device cuda]

On the CPU (``--device cpu``) the backbone runs in fp32 at a short
duration, as the JAX script does off the TPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nfe", type=int, default=16)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--mel-mae-gate", type=float, default=0.10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from f5_tts_tpu_torch.infer.engine import EngineOptions, InferenceEngine
    from f5_tts_tpu_torch.models.backbones import randomize_zero_init
    from f5_tts_tpu_torch.models.cfm import CFM
    from f5_tts_tpu_torch.models.configs import MODEL_CONFIGS
    from f5_tts_tpu_torch.models.vocos import Vocos
    from f5_tts_tpu_torch.utils.device import card_name_and_power_limit, resolve_device

    device = resolve_device(args.device, who="quant_ab")
    on_card = device.type == "cuda"
    if on_card:
        print(card_name_and_power_limit(), file=sys.stderr)
    model_cfg = MODEL_CONFIGS["F5TTS_v1_Base"]
    dtype = torch.bfloat16 if on_card else torch.float32

    def build(seed: int):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            m = CFM(model_cfg.arch)
        randomize_zero_init(m.transformer, torch.Generator().manual_seed(100))
        return m.to(device)

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(1)
        voc = Vocos().to(device)

    rng = np.random.default_rng(0)
    ref_frames, duration = (282, 1023) if on_card else (64, 255)
    ref = rng.standard_normal((ref_frames, model_cfg.mel.n_mel_channels)).astype(np.float32)
    text = rng.integers(0, 2545, size=min(180, duration // 2)).astype(np.int32)
    sr = model_cfg.mel.target_sample_rate

    results = {}
    for tag, quant in (("bf16" if on_card else "fp32", False), ("int8", True)):
        eng = InferenceEngine(build(0), model_cfg, vocoder=voc, dtype=dtype,
                              options=EngineOptions(nfe_step=args.nfe, quantize=quant))
        mels, _, _ = eng.generate_batch([ref], [text], [duration], seeds=[0])  # warm-up
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(args.iters):
            _, wavs, _ = eng.generate_batch([ref], [text], [duration], seeds=[i + 1],
                                            fetch_mel=False)
        wall = (time.perf_counter() - t0) / args.iters
        audio_s = len(wavs[0]) / sr
        results[tag] = {"rtf": wall / audio_s, "mel": mels[0]}
        print(f"{tag}: {wall * 1000:.1f} ms/utt -> RTF {wall / audio_s:.4f}", file=sys.stderr)
        del eng

    dense, q = (results[t] for t in results)
    mae = float(np.abs(dense["mel"] - q["mel"]).mean())
    print(json.dumps({
        "metric": "quant_ab_nfe%d" % args.nfe,
        "rtf_bf16": dense["rtf"],
        "rtf_int8": q["rtf"],
        "speedup": dense["rtf"] / q["rtf"],
        "mel_mae": mae,
        "gate": args.mel_mae_gate,
        "pass_quality_gate": mae < args.mel_mae_gate,
        "device": torch.cuda.get_device_name(device) if on_card else "cpu",
    }))


if __name__ == "__main__":
    main()
