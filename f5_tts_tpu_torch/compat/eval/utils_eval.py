"""Alias of ``f5_tts.eval.utils_eval``."""

from f5_tts_tpu_torch.eval.metrics import run_sim, run_utmos, run_wer, word_error_rate  # noqa: F401
from f5_tts_tpu_torch.eval.testsets import (  # noqa: F401
    get_librispeech_test_clean_metainfo,
    get_seedtts_testset_metainfo,
    prepare_eval_prompts as get_inference_prompt,
)
