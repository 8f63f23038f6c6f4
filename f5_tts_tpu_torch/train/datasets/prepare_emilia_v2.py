"""Prepare Emilia v2 / Emilia-YODAS (reference prepare_emilia_v2.py): the
newer release layout — per-language dirs of .tar-extracted {id}.mp3/.wav +
{id}.json metadata files.

JAX counterpart: ``f5_tts_tpu/train/datasets/prepare_emilia_v2.py``, copied with the
imports moved to this package; ``datasets`` is imported only inside ``prepare``.
"""

from __future__ import annotations

import argparse
import json
import os
from glob import glob

from f5_tts_tpu_torch.text.pinyin import convert_char_to_pinyin
from f5_tts_tpu_torch.train.datasets.prepare_emilia import repetition_found


def prepare(root: str, out_dir: str, lang: str = "EN", min_dnsmos: float = 3.0):
    os.makedirs(out_dir, exist_ok=True)
    from datasets.arrow_writer import ArrowWriter

    durations, vocab = [], set()
    skipped = 0
    with ArrowWriter(path=os.path.join(out_dir, "raw.arrow")) as writer:
        for meta_path in sorted(glob(os.path.join(root, lang, "**", "*.json"), recursive=True)):
            try:
                obj = json.load(open(meta_path, encoding="utf-8"))
            except json.JSONDecodeError:
                continue
            text = obj.get("text", "")
            dur = float(obj.get("duration", 0))
            dnsmos = float(obj.get("dnsmos", 99))
            if not (0.3 <= dur <= 30) or dnsmos < min_dnsmos or repetition_found(text):
                skipped += 1
                continue
            wav = None
            for ext in (".wav", ".mp3", ".flac"):
                cand = os.path.splitext(meta_path)[0] + ext
                if os.path.isfile(cand):
                    wav = cand
                    break
            if wav is None:
                skipped += 1
                continue
            tokens = convert_char_to_pinyin([text], polyphone=True)[0]
            writer.write({"audio_path": wav, "text": "".join(tokens), "duration": dur})
            durations.append(dur)
            vocab.update(tokens)
        writer.finalize()
    with open(os.path.join(out_dir, "duration.json"), "w") as f:
        json.dump({"duration": durations}, f)
    with open(os.path.join(out_dir, "vocab.txt"), "w", encoding="utf-8") as f:
        f.write(" \n")
        for c in sorted({ch for t in vocab for ch in t} - {" "}):
            f.write(c + "\n")
    print(f"wrote {len(durations)} rows ({sum(durations)/3600:.1f} h), skipped {skipped}")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("root")
    p.add_argument("--lang", default="EN")
    p.add_argument("--out_dir", default=None)
    args = p.parse_args(argv)
    prepare(args.root, args.out_dir or f"data/Emilia_{args.lang}_v2_pinyin", lang=args.lang)


if __name__ == "__main__":
    main()
