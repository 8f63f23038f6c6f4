"""Hub resolution of checkpoints and vocoders by model name.

JAX counterpart: ``f5_tts_tpu/utils/hub.py`` (itself reference api.py:65-81,
infer_cli.py:274-296), copied.  The reference maps model names to hub files
and downloads them; this resolves the same names local cache first:

  1. a populated local HF cache (``~/.cache/huggingface`` or ``hf_cache_dir``)
     via ``local_files_only`` lookups, which touch no network;
  2. a hub download, tried only when the cache misses and ``HF_HUB_OFFLINE``
     is not set (any failure returns None, so callers raise their own
     message).

Without ``huggingface_hub`` installed every lookup returns None.
``resolve_whisper`` serves the ASR fallback (``audio/asr.py``).
"""

from __future__ import annotations

import os


def model_hub_spec(model: str, mel_spec_type: str = "vocos") -> tuple[str, str]:
    """Model name -> (repo_id, filename-in-repo).

    Mirrors the reference's name/step/type overrides exactly
    (reference api.py:65-77, infer_cli.py:274-289).
    """
    repo_name, ckpt_step, ckpt_type = "F5-TTS", 1250000, "safetensors"
    if model == "F5TTS_Base":
        if mel_spec_type == "vocos":
            ckpt_step = 1200000
        elif mel_spec_type == "bigvgan":
            model, ckpt_type = "F5TTS_Base_bigvgan", "pt"
    elif model == "E2TTS_Base":
        repo_name, ckpt_step = "E2-TTS", 1200000
    return f"SWivid/{repo_name}", f"{model}/model_{ckpt_step}.{ckpt_type}"


VOCODER_HUB = {
    # reference utils_infer.py:108-146
    "vocos": ("charactr/vocos-mel-24khz", "pytorch_model.bin"),
    "bigvgan": ("nvidia/bigvgan_v2_24khz_100band_256x", "bigvgan_generator.pt"),
}

WHISPER_REPO = "openai/whisper-large-v3-turbo"  # reference utils_infer.py:163


def parse_hf_uri(uri: str) -> tuple[str, str]:
    """``hf://org/repo/sub/path.ext`` -> ("org/repo", "sub/path.ext")."""
    rest = uri[len("hf://") :]
    parts = rest.split("/")
    if len(parts) < 3:
        raise ValueError(f"malformed hf:// uri (need org/repo/filename): {uri}")
    return "/".join(parts[:2]), "/".join(parts[2:])


def resolve_hf_file(repo_id: str, filename: str, hf_cache_dir: str | None = None) -> str | None:
    """Local-cache-first hub file resolution; None when unresolvable."""
    try:
        from huggingface_hub import hf_hub_download
    except ImportError:
        return None
    try:  # pure cache lookup — never touches the network
        return hf_hub_download(
            repo_id=repo_id, filename=filename, cache_dir=hf_cache_dir, local_files_only=True
        )
    except Exception:
        pass
    if os.environ.get("HF_HUB_OFFLINE"):
        return None
    try:  # cache miss: try the real download (the reference's default path)
        return hf_hub_download(repo_id=repo_id, filename=filename, cache_dir=hf_cache_dir)
    except Exception:
        return None


def resolve_checkpoint(
    model: str, mel_spec_type: str = "vocos", hf_cache_dir: str | None = None
) -> str | None:
    repo_id, filename = model_hub_spec(model, mel_spec_type)
    return resolve_hf_file(repo_id, filename, hf_cache_dir)


def resolve_vocoder(vocoder_name: str, hf_cache_dir: str | None = None) -> str | None:
    if vocoder_name not in VOCODER_HUB:
        return None
    repo_id, filename = VOCODER_HUB[vocoder_name]
    return resolve_hf_file(repo_id, filename, hf_cache_dir)


def resolve_whisper(model_path: str | None = None, hf_cache_dir: str | None = None) -> str | None:
    """Whisper snapshot dir for the ASR fallback: explicit path ->
    $F5_TTS_TPU_WHISPER -> local HF cache -> (if online) download."""
    path = model_path or os.environ.get("F5_TTS_TPU_WHISPER")
    if path:
        return path
    try:
        from huggingface_hub import snapshot_download
    except ImportError:
        return None
    try:
        return snapshot_download(WHISPER_REPO, cache_dir=hf_cache_dir, local_files_only=True)
    except Exception:
        pass
    if os.environ.get("HF_HUB_OFFLINE"):
        return None
    try:
        return snapshot_download(WHISPER_REPO, cache_dir=hf_cache_dir)
    except Exception:
        return None
