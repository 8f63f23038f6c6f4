"""Alias of ``f5_tts.model.utils`` (reference src/f5_tts/model/utils.py)."""

from f5_tts_tpu_torch.eval.metrics import word_error_rate  # noqa: F401
from f5_tts_tpu_torch.models.cfm import (  # noqa: F401
    lens_to_mask,
    mask_from_frac_lengths,
    timestep_schedule as get_epss_timesteps_schedule,
)
from f5_tts_tpu_torch.text.pinyin import convert_char_to_pinyin  # noqa: F401
from f5_tts_tpu_torch.text.tokenizer import get_tokenizer, tokens_to_ids as list_str_to_idx  # noqa: F401
from f5_tts_tpu_torch.train.datasets.prepare_emilia import repetition_found  # noqa: F401
from f5_tts_tpu_torch.utils.seed import seed_everything  # noqa: F401
