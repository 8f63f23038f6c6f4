"""Eval testset loading + prompt preparation (reference src/f5_tts/eval/utils_eval.py).

Metalist formats preserved:
- seedtts meta.lst: ``utt|prompt_text|prompt_wav|gt_text[|gt_wav]``
- librispeech_pc cross-sentence .lst: tab-separated
  ``ref_utt ref_dur ref_txt gen_utt gen_dur gen_txt`` resolving flac paths
  under the LibriSpeech test-clean tree.

Prompt preparation mirrors get_inference_prompt (utils_eval.py:72-205):
RMS-normalize the prompt, estimate target duration from byte-length ratios (or
ground-truth duration), bucket utterances by target length for batched
synthesis.

JAX counterpart: ``f5_tts_tpu/eval/testsets.py`` (a copy with the imports
changed to the port's).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from f5_tts_tpu_torch.audio.io import load_wav, resample, rms
from f5_tts_tpu_torch.infer.pipeline import text_to_ids


def get_seedtts_testset_metainfo(metalst: str):
    metainfo = []
    with open(metalst, encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split("|")
            if len(parts) == 5:
                utt, prompt_text, prompt_wav, gt_text, gt_wav = parts
            else:
                utt, prompt_text, prompt_wav, gt_text = parts
                gt_wav = os.path.join(os.path.dirname(metalst), "wavs", utt + ".wav")
            if not os.path.isabs(prompt_wav):
                prompt_wav = os.path.join(os.path.dirname(metalst), prompt_wav)
            metainfo.append((utt, prompt_text, prompt_wav, gt_text, gt_wav))
    return metainfo


def get_librispeech_test_clean_metainfo(metalst: str, librispeech_test_clean_path: str):
    metainfo = []
    with open(metalst, encoding="utf-8") as f:
        for line in f:
            ref_utt, ref_dur, ref_txt, gen_utt, gen_dur, gen_txt = line.strip().split("\t")
            ref_spk, ref_chap, _ = ref_utt.split("-")
            ref_wav = os.path.join(librispeech_test_clean_path, ref_spk, ref_chap, ref_utt + ".flac")
            gen_spk, gen_chap, _ = gen_utt.split("-")
            gen_wav = os.path.join(librispeech_test_clean_path, gen_spk, gen_chap, gen_utt + ".flac")
            metainfo.append((gen_utt, ref_txt, ref_wav, " " + gen_txt, gen_wav))
    return metainfo


@dataclass
class EvalPrompt:
    utt: str
    ref_mel: np.ndarray  # [n_ref, d]
    text_ids: np.ndarray  # [nt]
    duration: int  # total frames
    ref_frames: int
    ref_rms: float


def prepare_eval_prompts(
    metainfo,
    engine,
    vocab,
    tokenizer: str = "pinyin",
    speed: float = 1.0,
    use_truth_duration: bool = False,
    target_rms: float = 0.1,
    min_s: float = 3.0,
    max_s: float = 40.0,
) -> list[EvalPrompt]:
    """Loads prompt audio, computes mels/ids/durations (utils_eval.py:72-205)."""
    mel_cfg = engine.model_cfg.mel
    sr_t = mel_cfg.target_sample_rate
    hop = mel_cfg.hop_length
    out = []
    for utt, prompt_text, prompt_wav, gt_text, gt_wav in metainfo:
        wav, sr = load_wav(prompt_wav)
        ref_rms = rms(wav)
        if 0 < ref_rms < target_rms:
            wav = wav * (target_rms / ref_rms)
        if sr != sr_t:
            wav = resample(wav, sr, sr_t)
        ref_frames = len(wav) // hop
        ids = text_to_ids([prompt_text + gt_text], vocab, tokenizer)[0]
        ids = ids[ids != -1]
        if use_truth_duration:
            gwav, gsr = load_wav(gt_wav)
            gt_frames = int(len(gwav) / gsr * sr_t / hop / speed)
            duration = ref_frames + gt_frames
        else:
            ref_bytes = max(len(prompt_text.encode("utf-8")), 1)
            gen_bytes = len(gt_text.encode("utf-8"))
            duration = ref_frames + int(ref_frames / ref_bytes * gen_bytes / speed)
        total_s = duration * hop / sr_t
        if not (min_s <= total_s <= max_s):
            duration = int(np.clip(duration, min_s * sr_t / hop, max_s * sr_t / hop))
        ref_mel = engine.ref_mel(wav)[:ref_frames]
        out.append(EvalPrompt(utt, ref_mel, ids, int(duration), ref_frames, ref_rms))
    return out
