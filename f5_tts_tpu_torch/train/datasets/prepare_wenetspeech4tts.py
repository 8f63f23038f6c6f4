"""Prepare WenetSpeech4TTS (reference src/f5_tts/train/datasets/prepare_wenetspeech4tts.py):
walks Premium/Standard/Basic subset dirs pairing .wav with .txt transcripts,
converts to pinyin, writes data/WenetSpeech4TTS_<subset>_pinyin/.

JAX counterpart: ``f5_tts_tpu/train/datasets/prepare_wenetspeech4tts.py``, copied with the
imports moved to this package; ``datasets`` is imported only inside ``prepare``.
"""

from __future__ import annotations

import argparse
import json
import os
from glob import glob

from f5_tts_tpu_torch.audio.io import load_wav
from f5_tts_tpu_torch.text.pinyin import convert_char_to_pinyin


def prepare(root: str, out_dir: str, subsets=("Premium",)):
    os.makedirs(out_dir, exist_ok=True)
    from datasets.arrow_writer import ArrowWriter

    durations, vocab = [], set()
    with ArrowWriter(path=os.path.join(out_dir, "raw.arrow")) as writer:
        for subset in subsets:
            base = os.path.join(root, subset)
            if not os.path.isdir(base):
                print(f"skip missing subset {subset}")
                continue
            for wav in sorted(glob(os.path.join(base, "**", "*.wav"), recursive=True)):
                txt = os.path.splitext(wav)[0] + ".txt"
                if not os.path.isfile(txt):
                    continue
                raw = open(txt, encoding="utf-8").read().strip().splitlines()
                text = raw[0].strip() if raw else ""
                if not text:
                    continue
                audio, sr = load_wav(wav)
                dur = len(audio) / sr
                if not (0.3 <= dur <= 30):
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
        for tok in sorted({c for t in vocab for c in t} - {" "}):
            f.write(tok + "\n")
    print(f"wrote {len(durations)} rows ({sum(durations)/3600:.1f} h)")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("root", help="WenetSpeech4TTS root")
    p.add_argument("--subsets", nargs="+", default=["Premium"])
    p.add_argument("--out_dir", default=None)
    args = p.parse_args(argv)
    out = args.out_dir or f"data/WenetSpeech4TTS_{'_'.join(args.subsets)}_pinyin"
    prepare(args.root, out, subsets=args.subsets)


if __name__ == "__main__":
    main()
