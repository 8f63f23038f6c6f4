"""Prepare LJSpeech (reference src/f5_tts/train/datasets/prepare_ljspeech.py):
reads metadata.csv (id|raw|normalized), uses the normalized column, writes
data/LJSpeech_char/raw.arrow + duration.json + vocab.txt.

JAX counterpart: ``f5_tts_tpu/train/datasets/prepare_ljspeech.py``, copied with the
imports moved to this package; ``datasets`` is imported only inside ``prepare``.
"""

from __future__ import annotations

import argparse
import json
import os

from f5_tts_tpu_torch.audio.io import load_wav


def prepare(ljspeech_root: str, out_dir: str):
    meta = os.path.join(ljspeech_root, "metadata.csv")
    rows = []
    with open(meta, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split("|")
            if len(parts) < 3:
                continue
            wav = os.path.join(ljspeech_root, "wavs", parts[0] + ".wav")
            rows.append((wav, parts[2]))

    os.makedirs(out_dir, exist_ok=True)
    from datasets.arrow_writer import ArrowWriter

    durations, texts = [], []
    with ArrowWriter(path=os.path.join(out_dir, "raw.arrow")) as writer:
        for wav, text in rows:
            if not os.path.isfile(wav):
                continue
            audio, sr = load_wav(wav)
            dur = len(audio) / sr
            if not (0.3 <= dur <= 30):
                continue
            durations.append(dur)
            texts.append(text)
            writer.write({"audio_path": wav, "text": text, "duration": dur})
        writer.finalize()
    with open(os.path.join(out_dir, "duration.json"), "w") as f:
        json.dump({"duration": durations}, f)
    chars = sorted({c for t in texts for c in t})
    if " " in chars:
        chars.remove(" ")
    with open(os.path.join(out_dir, "vocab.txt"), "w", encoding="utf-8") as f:
        f.write(" \n")
        for c in chars:
            f.write(c + "\n")
    print(f"wrote {len(durations)} rows ({sum(durations) / 3600:.2f} h) -> {out_dir}")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("ljspeech_root", help="dir containing metadata.csv and wavs/")
    p.add_argument("--out_dir", default="data/LJSpeech_char")
    args = p.parse_args(argv)
    prepare(args.ljspeech_root, args.out_dir)


if __name__ == "__main__":
    main()
