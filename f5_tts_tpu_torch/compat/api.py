"""Alias of the reference ``f5_tts.api`` surface (reference src/f5_tts/api.py)."""

from f5_tts_tpu_torch.infer.api import F5TTS  # noqa: F401
