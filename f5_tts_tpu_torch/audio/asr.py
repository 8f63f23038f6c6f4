"""Whisper transcription of the reference audio when ``ref_text`` is empty.

JAX counterpart: ``f5_tts_tpu/audio/asr.py`` (itself reference
utils_infer.py:153-184, openai/whisper-large-v3-turbo through
``transformers``).  The model resolves as JAX resolves it: an explicit
``model_path``, then ``$F5_TTS_TPU_WHISPER``, then the local HF cache, then
a download where the network is reachable (``utils/hub.resolve_whisper``).
``transformers`` is imported only when a transcriber is made.  The
pipeline runs on the device it is given (``F5TTS`` passes its own); the
returned callable plugs into ``preprocess_ref_audio_text(transcribe_fn=...)``.
"""

from __future__ import annotations

import numpy as np

from f5_tts_tpu_torch.utils.hub import WHISPER_REPO, resolve_whisper

_pipes: dict = {}  # (snapshot, device) -> pipeline, built once each


def whisper_available(model_path: str | None = None, hf_cache_dir: str | None = None) -> bool:
    """True when an ASR model resolves without manual wiring."""
    return resolve_whisper(model_path, hf_cache_dir) is not None


def make_whisper_transcriber(model_path: str | None = None, language: str | None = None,
                             hf_cache_dir: str | None = None, device: str = "cuda"):
    """``transcribe_fn(wav: np.ndarray, sr: int) -> str`` over the resolved
    Whisper snapshot, its pipeline on ``device``."""
    model_path = resolve_whisper(model_path, hf_cache_dir)
    if not model_path:
        raise RuntimeError(
            f"no Whisper model: populate the local HF cache with {WHISPER_REPO},"
            " set $F5_TTS_TPU_WHISPER to a local snapshot, or pass model_path")
    key = (model_path, str(device))
    if key not in _pipes:
        from transformers import pipeline

        _pipes[key] = pipeline("automatic-speech-recognition", model=model_path,
                               device=str(device))
    pipe = _pipes[key]
    kwargs = {"task": "transcribe", "language": language} if language else {"task": "transcribe"}

    def transcribe(wav: np.ndarray, sr: int) -> str:
        out = pipe({"raw": np.asarray(wav, dtype=np.float32), "sampling_rate": sr},
                   chunk_length_s=30, batch_size=8, generate_kwargs=kwargs,
                   return_timestamps=False)
        return out["text"].strip()

    return transcribe
