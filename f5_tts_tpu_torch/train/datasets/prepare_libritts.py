"""Prepare LibriTTS (reference src/f5_tts/train/datasets/prepare_libritts.py):
walks train-clean-100/360 + train-other-500 subsets, pairs .wav with
.normalized.txt transcripts, writes data/LibriTTS_100_360_500_char/.

JAX counterpart: ``f5_tts_tpu/train/datasets/prepare_libritts.py``, copied with the
imports moved to this package; ``datasets`` is imported only inside ``prepare``.
"""

from __future__ import annotations

import argparse
import json
import os
from glob import glob

from f5_tts_tpu_torch.audio.io import load_wav


def prepare(libritts_root: str, out_dir: str, subsets=("train-clean-100", "train-clean-360", "train-other-500")):
    os.makedirs(out_dir, exist_ok=True)
    from datasets.arrow_writer import ArrowWriter

    durations, vocab = [], set()
    with ArrowWriter(path=os.path.join(out_dir, "raw.arrow")) as writer:
        for subset in subsets:
            base = os.path.join(libritts_root, subset)
            if not os.path.isdir(base):
                print(f"skip missing subset {subset}")
                continue
            for wav in sorted(glob(os.path.join(base, "*", "*", "*.wav"))):
                txt = wav.replace(".wav", ".normalized.txt")
                if not os.path.isfile(txt):
                    continue
                text = open(txt, encoding="utf-8").read().strip()
                audio, sr = load_wav(wav)
                dur = len(audio) / sr
                if not (0.3 <= dur <= 30):
                    continue
                writer.write({"audio_path": wav, "text": text, "duration": dur})
                durations.append(dur)
                vocab.update(text)
        writer.finalize()
    with open(os.path.join(out_dir, "duration.json"), "w") as f:
        json.dump({"duration": durations}, f)
    with open(os.path.join(out_dir, "vocab.txt"), "w", encoding="utf-8") as f:
        f.write(" \n")
        for c in sorted(vocab - {" "}):
            f.write(c + "\n")
    print(f"wrote {len(durations)} rows ({sum(durations)/3600:.1f} h)")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("libritts_root")
    p.add_argument("--out_dir", default="data/LibriTTS_100_360_500_char")
    args = p.parse_args(argv)
    prepare(args.libritts_root, args.out_dir)


if __name__ == "__main__":
    main()
