"""Prepare a training dataset from a ``audio_file|text`` CSV
(reference src/f5_tts/train/datasets/prepare_csv_wavs.py).

Usage:
    python -m f5_tts_tpu_torch.train.datasets.prepare_csv_wavs \
        /path/to/metadata.csv /output/dataset/path [--pretrain] [--workers N]

Writes <out>/raw.arrow + duration.json + vocab.txt.  With --pretrain the
bundled Emilia pinyin vocab is used (finetune-compatible); otherwise a vocab is
built from the dataset's own characters (char-style).

JAX counterpart: ``f5_tts_tpu/train/datasets/prepare_csv_wavs.py``, copied with the
imports moved to this package; ``datasets`` is imported only inside ``prepare``.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
from concurrent.futures import ThreadPoolExecutor

from f5_tts_tpu_torch.text.pinyin import convert_char_to_pinyin
from f5_tts_tpu_torch.text.tokenizer import _PKG_VOCAB


def probe_duration(path: str) -> float | None:
    try:
        from f5_tts_tpu_torch.audio.io import load_wav

        wav, sr = load_wav(path)
        return len(wav) / sr
    except Exception:
        return None


def read_csv(csv_path: str):
    rows = []
    base = os.path.dirname(os.path.abspath(csv_path))
    with open(csv_path, encoding="utf-8-sig") as f:
        reader = csv.reader(f, delimiter="|")
        header = next(reader, None)
        assert header and header[0].strip() == "audio_file", "CSV must start with 'audio_file|text'"
        for parts in reader:
            if len(parts) >= 2:
                path = parts[0].strip()
                if not os.path.isabs(path):  # relative to the csv's directory
                    path = os.path.join(base, path)
                rows.append((path, "|".join(parts[1:]).strip()))
    return rows


def prepare(csv_path: str, out_dir: str, pretrain: bool = False, workers: int = 4, pinyin: bool = True):
    rows = read_csv(csv_path)
    os.makedirs(out_dir, exist_ok=True)

    with ThreadPoolExecutor(max_workers=workers) as ex:
        durations = list(ex.map(lambda r: probe_duration(r[0]), rows))

    kept, kept_durs = [], []
    for (path, text), dur in zip(rows, durations):
        if dur is None:
            print(f"skip (unreadable): {path}")
            continue
        kept.append((path, text))
        kept_durs.append(dur)

    # batch pinyin conversion (reference does batched convert_char_to_pinyin)
    if pinyin:
        converted = convert_char_to_pinyin([t for _, t in kept], polyphone=True)
        texts = ["".join(c) for c in converted]
    else:
        texts = [t for _, t in kept]

    from datasets.arrow_writer import ArrowWriter

    arrow_path = os.path.join(out_dir, "raw.arrow")
    with ArrowWriter(path=arrow_path, writer_batch_size=100) as writer:
        for (path, _), text, dur in zip(kept, texts, kept_durs):
            writer.write({"audio_path": path, "text": text, "duration": dur})
        writer.finalize()

    with open(os.path.join(out_dir, "duration.json"), "w", encoding="utf-8") as f:
        json.dump({"duration": kept_durs}, f)

    vocab_out = os.path.join(out_dir, "vocab.txt")
    if pretrain:
        import shutil

        shutil.copy2(_PKG_VOCAB, vocab_out)
    else:
        chars = sorted({c for t in texts for c in t})
        if " " in chars:
            chars.remove(" ")
        with open(vocab_out, "w", encoding="utf-8") as f:
            f.write(" \n")  # space must be index 0
            for c in chars:
                f.write(c + "\n")
    total_h = sum(kept_durs) / 3600
    print(f"wrote {len(kept)} rows, {total_h:.2f} h -> {out_dir}")
    return out_dir


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("csv_path")
    p.add_argument("out_dir")
    p.add_argument("--pretrain", action="store_true", help="use the bundled Emilia pinyin vocab")
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--no-pinyin", action="store_true", help="skip pinyin conversion (char/byte data)")
    args = p.parse_args(argv)
    prepare(args.csv_path, args.out_dir, pretrain=args.pretrain, workers=args.workers,
            pinyin=not args.no_pinyin)


if __name__ == "__main__":
    main()
