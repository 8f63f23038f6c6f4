"""One-command smoke test: text to a wav file with a tiny random model.

JAX counterpart: ``scripts/smoke.py``.  Runs the whole chain, text ->
tokenize -> CFM ODE -> vocoder -> wav, through ``F5TTS(model="F5TTS_Tiny",
init_random=True, nfe_step=4)`` on a 1.5 s tone reference, and prints the
same ``ok:`` line.  JAX pins the CPU; the port runs on the card unless
``--device cpu`` is given.  On the card F5TTS_Tiny's attention (dh 64) runs
kernel A and its ConvPositionEmbedding (4-channel groups) the plain
composition (``models/layers.conv_pos_takes_kernel``); the kernel launches
of the request are printed.

    python -m f5_tts_tpu_torch.scripts.smoke [out.wav] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="smoke")
    ap.add_argument("out", nargs="?", default="smoke_out.wav")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from f5_tts_tpu_torch.audio.io import save_wav
    from f5_tts_tpu_torch.infer.api import F5TTS
    from f5_tts_tpu_torch.ops import cuda_build

    sr = 24000
    t = np.arange(int(sr * 1.5)) / sr
    ref = (0.2 * np.sin(2 * np.pi * 220 * t)
           * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t))).astype(np.float32)
    tts = F5TTS(model="F5TTS_Tiny", init_random=True, nfe_step=4, device=args.device)
    print(f"device: {tts.device}")
    before = cuda_build.launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        ref_path = os.path.join(tmp, "smoke_ref.wav")
        save_wav(ref_path, ref, sr)
        wav, out_sr, spec = tts.infer(
            ref_path, "a simple reference tone.",
            "the quick brown fox jumps over the lazy dog.",
            seed=0, file_wave=args.out, show_info=print,
        )
    launches = cuda_build.launches_since(before)
    assert wav is not None and np.isfinite(wav).all()
    print(f"kernel launches: {json.dumps(launches)}")
    print(f"ok: {args.out} ({len(wav)/out_sr:.2f}s @ {out_sr} Hz, "
          f"mel {spec.shape[0]}x{spec.shape[1]}, seed {tts.seed})")
    return {"wav": wav, "sr": out_sr, "spec": spec, "seed": tts.seed, "launches": launches}


if __name__ == "__main__":
    main()
