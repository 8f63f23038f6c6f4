"""WER/SIM aggregation drivers (reference eval_seedtts_testset.py /
eval_librispeech_test_clean.py): score a directory of generated wavs against a
metalist, write per-utterance jsonl + mean.

JAX counterpart: ``f5_tts_tpu/eval/eval_testset.py`` (a copy with the imports
changed to the port's).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def collect_items(metainfo, gen_wav_dir: str, mode: str):
    items = []
    for utt, prompt_text, prompt_wav, gt_text, gt_wav in metainfo:
        gen = os.path.join(gen_wav_dir, utt + ".wav")
        if not os.path.isfile(gen):
            continue
        if mode == "wer":
            items.append((utt, gen, gt_text))
        else:  # sim
            items.append((utt, gen, prompt_wav))
    return items


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-e", "--eval_task", default="wer", choices=["wer", "sim", "utmos"])
    p.add_argument("-l", "--lang", default="en", choices=["en", "zh"])
    p.add_argument("-g", "--gen_wav_dir", required=True)
    p.add_argument("-t", "--testset", default="seedtts_test_en")
    p.add_argument("--metalst_root", default="data")
    p.add_argument("--librispeech_test_clean_path", default="data/LibriSpeech/test-clean")
    p.add_argument("--ckpt_dir", default="checkpoints")
    p.add_argument("--sim_ckpt", default="checkpoints/wavlm_large_finetune.pth")
    p.add_argument("--device", default=None, help="the SIM model's device: cuda (default) or cpu")
    args = p.parse_args(argv)

    from f5_tts_tpu_torch.eval import metrics
    from f5_tts_tpu_torch.eval.testsets import (
        get_librispeech_test_clean_metainfo,
        get_seedtts_testset_metainfo,
    )

    if args.testset == "ls_pc_test_clean":
        metalst = os.path.join(args.metalst_root, "librispeech_pc_test_clean_cross_sentence.lst")
        metainfo = get_librispeech_test_clean_metainfo(metalst, args.librispeech_test_clean_path)
    else:
        lang = args.testset.split("_")[-1]
        metalst = os.path.join(args.metalst_root, "seedtts_testset", lang, "meta.lst")
        metainfo = get_seedtts_testset_metainfo(metalst)

    if args.eval_task == "utmos":
        results = metrics.run_utmos(args.gen_wav_dir)
        keyname = "utmos"
    elif args.eval_task == "wer":
        items = collect_items(metainfo, args.gen_wav_dir, "wer")
        results = metrics.run_wer(items, args.lang, args.ckpt_dir)
        keyname = "wer"
    else:
        items = collect_items(metainfo, args.gen_wav_dir, "sim")
        results = metrics.run_sim(items, args.sim_ckpt, args.device)
        keyname = "sim"

    out_path = os.path.join(args.gen_wav_dir, f"_{keyname}_results.jsonl")
    with open(out_path, "w") as f:
        for r in results:
            f.write(json.dumps(r, ensure_ascii=False) + "\n")
        mean = float(np.mean([r[keyname] for r in results])) if results else float("nan")
        f.write(f"\n{keyname.upper()}: {mean:.5f}\n")
    print(f"{keyname.upper()}: {mean:.5f} -> {out_path}")
    return mean


if __name__ == "__main__":
    main()
