"""Reference-audio preprocessing (reference utils_infer.py:298-378):
2-stage silence-split clipping to <=12 s, edge trim + 50 ms pad, terminal
punctuation fix, and an md5-keyed cache."""

from __future__ import annotations

import hashlib

import numpy as np

from f5_tts_tpu_torch.audio.io import load_wav
from f5_tts_tpu_torch.audio.silence import remove_silence_edges, split_on_silence

_ref_audio_cache: dict[str, tuple[np.ndarray, int]] = {}
_ref_text_cache: dict[str, str] = {}


def clip_ref_audio(wav: np.ndarray, sr: int, show_info=print) -> np.ndarray:
    """Clip reference audio to <=12 s preferring long-silence boundaries."""

    def accumulate(segs):
        acc = np.zeros(0, dtype=np.float32)
        for seg in segs:
            if len(acc) > 6 * sr and len(acc) + len(seg) > 12 * sr:
                show_info("Audio is over 12s, clipping short.")
                break
            acc = np.concatenate([acc, seg])
        return acc

    # 1. long-silence split
    clipped = accumulate(split_on_silence(wav, sr, min_silence_len=1000, silence_thresh=-50, keep_silence=1000))
    # 2. short-silence split if still too long
    if len(clipped) > 12 * sr:
        clipped = accumulate(split_on_silence(wav, sr, min_silence_len=100, silence_thresh=-40, keep_silence=1000))
    # 3. hard cut
    if len(clipped) > 12 * sr:
        clipped = clipped[: 12 * sr]
        show_info("Audio is over 12s, clipping short. (hard cut)")
    clipped = remove_silence_edges(clipped, sr)
    return np.concatenate([clipped, np.zeros(int(0.05 * sr), dtype=np.float32)])


def ensure_terminal_punctuation(text: str) -> str:
    if not text.endswith(". ") and not text.endswith("。"):
        text = text + " " if text.endswith(".") else text + ". "
    return text


def preprocess_ref_audio_text(
    ref_audio: str | tuple[np.ndarray, int],
    ref_text: str,
    show_info=print,
    transcribe_fn=None,
) -> tuple[tuple[np.ndarray, int], str]:
    """Returns ((clipped_wav, sr), ref_text).  ``transcribe_fn(wav, sr) -> str``
    is the pluggable ASR fallback (reference uses Whisper; this zero-egress
    build requires the caller to provide one or pass ref_text)."""
    if isinstance(ref_audio, str):
        with open(ref_audio, "rb") as f:
            audio_hash = hashlib.md5(f.read()).hexdigest()
        if audio_hash in _ref_audio_cache:
            show_info("Using cached preprocessed reference audio...")
            wav, sr = _ref_audio_cache[audio_hash]
        else:
            wav, sr = load_wav(ref_audio)
            wav = clip_ref_audio(wav, sr, show_info=show_info)
            _ref_audio_cache[audio_hash] = (wav, sr)
    else:
        wav, sr = ref_audio
        audio_hash = hashlib.md5(np.ascontiguousarray(wav).tobytes()).hexdigest()
        wav = clip_ref_audio(np.asarray(wav, dtype=np.float32), sr, show_info=show_info)

    if not ref_text.strip():
        if audio_hash in _ref_text_cache:
            ref_text = _ref_text_cache[audio_hash]
        elif transcribe_fn is not None:
            show_info("No reference text provided, transcribing reference audio...")
            ref_text = transcribe_fn(wav, sr)
            _ref_text_cache[audio_hash] = ref_text
        else:
            raise ValueError(
                "ref_text is empty and no transcribe_fn provided; pass the reference"
                " transcript or a local ASR callable."
            )
    ref_text = ensure_terminal_punctuation(ref_text)
    return (wav, sr), ref_text
