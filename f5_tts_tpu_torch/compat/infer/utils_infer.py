"""Alias of ``f5_tts.infer.utils_infer`` (reference src/f5_tts/infer/utils_infer.py)."""

from f5_tts_tpu_torch.audio.preprocess import preprocess_ref_audio_text  # noqa: F401
from f5_tts_tpu_torch.audio.silence import remove_silence_edges  # noqa: F401
from f5_tts_tpu_torch.infer.pipeline import (  # noqa: F401
    CFG_STRENGTH as cfg_strength,
    CROSS_FADE_DURATION as cross_fade_duration,
    FIX_DURATION as fix_duration,
    NFE_STEP as nfe_step,
    SPEED as speed,
    SWAY_SAMPLING_COEF as sway_sampling_coef,
    TARGET_RMS as target_rms,
    infer_batch_process,
    infer_process,
)
from f5_tts_tpu_torch.text.chunk import chunk_text  # noqa: F401
