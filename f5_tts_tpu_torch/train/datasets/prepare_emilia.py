"""Prepare Emilia ZH+EN (reference src/f5_tts/train/datasets/prepare_emilia.py):
reads the Emilia jsonl manifests (one json per utterance with wav/text/dnsmos),
applies the reference's quality filters, converts zh to pinyin, writes
data/Emilia_ZH_EN_pinyin/{raw.arrow,duration.json,vocab.txt}.

JAX counterpart: ``f5_tts_tpu/train/datasets/prepare_emilia.py``, copied with the
imports moved to this package; ``datasets`` is imported only inside ``prepare``.
"""

from __future__ import annotations

import argparse
import json
import os
from glob import glob

from f5_tts_tpu_torch.text.pinyin import convert_char_to_pinyin

# reference filter lists (prepare_emilia.py:24-60): known-bad utterances and
# zh symbol filtering
ZH_FILTERS = ["い", "て"]
EN_FILTERS = ["ا", "い", "て"]


def repetition_found(text: str, length: int = 2, tolerance: int = 10) -> bool:
    """Dirty-data repetition filter (reference model/utils.py:191-199)."""
    from collections import defaultdict

    counts = defaultdict(int)
    for i in range(len(text) - length + 1):
        counts[text[i : i + length]] += 1
    return any(c > tolerance for c in counts.values())


def iter_manifests(root: str, lang: str):
    for path in sorted(glob(os.path.join(root, lang.upper(), "*.jsonl"))):
        with open(path, encoding="utf-8") as f:
            for line in f:
                try:
                    obj = json.loads(line)
                except json.JSONDecodeError:
                    continue
                yield path, obj


def prepare(emilia_root: str, out_dir: str, langs=("ZH", "EN"), min_dnsmos: float = 3.0):
    os.makedirs(out_dir, exist_ok=True)
    from datasets.arrow_writer import ArrowWriter

    durations = []
    vocab = set()
    n_bad = 0
    with ArrowWriter(path=os.path.join(out_dir, "raw.arrow")) as writer:
        for lang in langs:
            filters = ZH_FILTERS if lang == "ZH" else EN_FILTERS
            for mpath, obj in iter_manifests(emilia_root, lang):
                text = obj.get("text", "")
                dur = float(obj.get("duration", 0))
                wav = obj.get("wav", "")
                dnsmos = float(obj.get("dnsmos", 99))
                if not (0.3 <= dur <= 30) or dnsmos < min_dnsmos:
                    n_bad += 1
                    continue
                if any(f in text for f in filters) or repetition_found(text):
                    n_bad += 1
                    continue
                if lang == "ZH":
                    text = text.translate(str.maketrans({",": "，", "!": "！", "?": "？"}))
                conv = convert_char_to_pinyin([text], polyphone=True)[0]
                text_out = "".join(conv)
                vocab.update(conv)
                wav_path = wav if os.path.isabs(wav) else os.path.join(os.path.dirname(mpath), wav)
                writer.write({"audio_path": wav_path, "text": text_out, "duration": dur})
                durations.append(dur)
        writer.finalize()
    with open(os.path.join(out_dir, "duration.json"), "w") as f:
        json.dump({"duration": durations}, f)
    chars = sorted({c for tok in vocab for c in tok} | set("".join(sorted(vocab))))
    with open(os.path.join(out_dir, "vocab.txt"), "w", encoding="utf-8") as f:
        f.write(" \n")
        for c in sorted(set(chars) - {" "}):
            f.write(c + "\n")
    print(f"wrote {len(durations)} rows ({sum(durations)/3600:.1f} h), skipped {n_bad}")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("emilia_root", help="Emilia corpus root with ZH/ EN/ jsonl manifests")
    p.add_argument("--out_dir", default="data/Emilia_ZH_EN_pinyin")
    p.add_argument("--langs", nargs="+", default=["ZH", "EN"])
    args = p.parse_args(argv)
    prepare(args.emilia_root, args.out_dir, langs=args.langs)


if __name__ == "__main__":
    main()
