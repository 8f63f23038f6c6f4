"""UTMOS naturalness scoring over a wav dir (reference eval/eval_utmos.py).

JAX counterpart: ``f5_tts_tpu/eval/eval_utmos.py`` (a copy with the imports
changed to the port's).
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--audio_dir", required=True)
    p.add_argument("--ext", default="wav")
    a = p.parse_args(argv)
    from f5_tts_tpu_torch.eval.metrics import run_utmos

    results = run_utmos(a.audio_dir)
    out = f"{a.audio_dir}/_utmos_results.jsonl"
    with open(out, "w") as f:
        for r in results:
            f.write(json.dumps(r) + "\n")
        mean = float(np.mean([r["utmos"] for r in results])) if results else float("nan")
        f.write(f"\nUTMOS: {mean:.5f}\n")
    print(f"UTMOS: {mean:.5f} -> {out}")
    return mean


if __name__ == "__main__":
    main()
