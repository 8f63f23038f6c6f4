"""Import-path compatibility with the reference ``f5_tts`` package, on the port.

JAX counterpart: the repo's top-level ``f5_tts/`` alias, which resolves the
reference's import paths to the JAX package and keeps the name ``f5_tts``.
This package holds the same paths under ``f5_tts_tpu_torch.compat``, each
resolving to the port's implementation:

    from f5_tts_tpu_torch.compat.api import F5TTS
    from f5_tts_tpu_torch.compat.infer.utils_infer import chunk_text, infer_process
    from f5_tts_tpu_torch.compat.model.utils import convert_char_to_pinyin, get_tokenizer
"""
