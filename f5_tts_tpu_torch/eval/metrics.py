"""Objective metrics: WER / speaker SIM / UTMOS (reference src/f5_tts/eval/utils_eval.py:306-426).

The edit-distance WER core is implemented natively (no jiwer dependency);
ASR backends (faster-whisper for EN, funasr paraformer for ZH), the WavLM
ECAPA speaker encoder, and UTMOS are external models — adapters load them if
installed/provided locally and raise actionable errors otherwise (this build
has no network egress; eval tooling stays an optional extra, as in the
reference's [eval] extra).

JAX counterpart: ``f5_tts_tpu/eval/metrics.py`` (a copy with the imports
changed to the port's).
"""

from __future__ import annotations

import string
import unicodedata

import numpy as np


def _norm_text(text: str, lang: str) -> list[str]:
    """Reference normalization (utils_eval.py:330-350): strip punctuation,
    lowercase; zh compares per-character."""
    text = text.lower()
    keep = []
    for ch in text:
        if ch in string.punctuation:
            continue
        cat = unicodedata.category(ch)
        if cat.startswith("P"):
            continue
        keep.append(ch)
    text = "".join(keep)
    if lang == "zh":
        return [c for c in text.replace(" ", "")]
    return text.split()


def edit_distance(ref: list, hyp: list) -> int:
    """Levenshtein distance (insert/delete/substitute cost 1)."""
    m, n = len(ref), len(hyp)
    if m == 0:
        return n
    prev = np.arange(n + 1)
    for i in range(1, m + 1):
        cur = np.empty(n + 1, dtype=np.int64)
        cur[0] = i
        for j in range(1, n + 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ref[i - 1] != hyp[j - 1]))
        prev = cur
    return int(prev[n])


def word_error_rate(truth: str, hypothesis: str, lang: str = "en") -> float:
    ref = _norm_text(truth, lang)
    hyp = _norm_text(hypothesis, lang)
    if not ref:
        return 0.0 if not hyp else 1.0
    return edit_distance(ref, hyp) / len(ref)


# ---------------------------------------------------------------------------
# ASR adapters


def load_asr_model(lang: str, ckpt_dir: str = "checkpoints"):
    """EN: faster-whisper large-v3; ZH: funasr paraformer (reference
    utils_eval.py:284-300).  Requires the tool + local weights."""
    if lang == "zh":
        try:
            from funasr import AutoModel
        except ImportError as e:
            raise RuntimeError("funasr not installed; `pip install funasr` for zh WER") from e
        return AutoModel(
            model=f"{ckpt_dir}/paraformer-zh", disable_update=True,
        )
    try:
        from faster_whisper import WhisperModel
    except ImportError as e:
        raise RuntimeError(
            "faster-whisper not installed; `pip install faster-whisper` for en WER"
        ) from e
    return WhisperModel(f"{ckpt_dir}/Systran/faster-whisper-large-v3", device="cpu")


def transcribe(asr_model, lang: str, wav_path: str) -> str:
    if lang == "zh":
        res = asr_model.generate(input=wav_path, batch_size_s=300, disable_pbar=True)
        return res[0]["text"]
    segments, _ = asr_model.transcribe(wav_path, beam_size=5, language="en")
    return "".join(s.text for s in segments)


def run_wer(items: list[tuple[str, str, str]], lang: str, ckpt_dir: str = "checkpoints"):
    """items: (utt, gen_wav_path, truth_text) -> list of per-utt dicts + mean.
    Mirrors reference run_asr_wer (utils_eval.py:306-374)."""
    asr = load_asr_model(lang, ckpt_dir)
    results = []
    for utt, wav_path, truth in items:
        hypo = transcribe(asr, lang, wav_path)
        wer = word_error_rate(truth, hypo, lang)
        results.append({"wav": utt, "truth": truth, "hypo": hypo, "wer": wer})
    return results


# ---------------------------------------------------------------------------
# speaker similarity / MOS (external torch models)


def run_sim(items: list[tuple[str, str, str]], ckpt_path: str, device: str | None = None):
    """items: (utt, gen_wav, prompt_wav); WavLM-large ECAPA cosine similarity
    @16kHz (reference utils_eval.py:380-426).  Needs the UniSpeech wavlm ckpt.
    ``device``: the card unless the caller names the CPU (the port's
    addition)."""
    import torch

    from f5_tts_tpu_torch.eval.ecapa_tdnn import ECAPA_TDNN_SMALL
    from f5_tts_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device, "run_sim")
    model = ECAPA_TDNN_SMALL(feat_dim=1024, feat_type="wavlm_large", device=dev)
    state = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    model.load_state_dict(state["model"], strict=False)
    model.to(dev).eval()

    from f5_tts_tpu_torch.audio.io import load_wav, resample

    results = []
    with torch.no_grad():
        for utt, gen_wav, prompt_wav in items:
            w1, sr1 = load_wav(gen_wav)
            w2, sr2 = load_wav(prompt_wav)
            w1 = resample(w1, sr1, 16_000)
            w2 = resample(w2, sr2, 16_000)
            e1 = model(torch.from_numpy(w1).unsqueeze(0).to(dev))
            e2 = model(torch.from_numpy(w2).unsqueeze(0).to(dev))
            sim = torch.nn.functional.cosine_similarity(e1, e2)[0].item()
            results.append({"wav": utt, "sim": sim})
    return results


def run_utmos(wav_dir: str):
    """UTMOS22 strong via torch.hub (reference eval_utmos.py) — needs cached hub."""
    import glob

    import torch

    predictor = torch.hub.load("tarepan/SpeechMOS:v1.2.0", "utmos22_strong", trust_repo=True)
    from f5_tts_tpu_torch.audio.io import load_wav

    results = []
    for path in sorted(glob.glob(f"{wav_dir}/*.wav")):
        wav, sr = load_wav(path)
        score = predictor(torch.from_numpy(wav).unsqueeze(0), sr)
        results.append({"wav": path, "utmos": float(score)})
    return results
