"""Public Python API: ``F5TTS(...).infer(...)``.

JAX counterpart: ``f5_tts_tpu/infer/api.py:43-296`` (itself the reference
``f5_tts.api.F5TTS`` surface): the same constructor keywords and the same
``infer()`` signature and (wav, sr, spec) return.

The engine runs on the card: ``device=None`` means ``"cuda"`` and raises if
CUDA is unavailable; only an explicit ``device="cpu"`` runs on the CPU (the
DiT then runs in fp32, on the card in bf16).  Checkpoints load from
``ckpt_file`` / ``vocoder_local_path`` (reference-named ``.pt`` or
``.safetensors``); ``init_random=True`` builds seeded random weights.  Hub
resolution, the Whisper fallback for an empty ``ref_text`` and AOT artifacts
are not ported yet and raise (see ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import random
import sys

import numpy as np
import torch

from f5_tts_tpu_torch.audio.io import save_wav
from f5_tts_tpu_torch.audio.preprocess import preprocess_ref_audio_text
from f5_tts_tpu_torch.infer.engine import EngineOptions, InferenceEngine
from f5_tts_tpu_torch.infer.pipeline import (
    CFG_STRENGTH,
    CROSS_FADE_DURATION,
    NFE_STEP,
    SPEED,
    SWAY_SAMPLING_COEF,
    TARGET_RMS,
    PipelineOptions,
    infer_process,
)
from f5_tts_tpu_torch.models.cfm import CFM
from f5_tts_tpu_torch.models.configs import MODEL_CONFIGS, with_vocab_size
from f5_tts_tpu_torch.models.vocos import Vocos
from f5_tts_tpu_torch.text.tokenizer import get_tokenizer
from f5_tts_tpu_torch.utils import ckpt as ckpt_util

_NOT_PORTED = "is not ported to the PyTorch package yet (see ROADMAP.md)"


def resolve_device(device: str | None) -> torch.device:
    """``None`` means the card; the CPU only when asked for by name."""
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("F5TTS runs on a CUDA device and none is available; "
                           "pass device='cpu' to run on the CPU")
    return dev


def _seeded(build, seed: int):
    """Build a module with torch's default init under a fixed seed, leaving
    the global RNG state as it was."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build()


class F5TTS:
    def __init__(
        self,
        model: str = "F5TTS_v1_Base",
        ckpt_file: str = "",
        vocab_file: str = "",
        ode_method: str = "euler",
        use_ema: bool = True,
        vocoder_local_path: str | None = None,
        device: str | None = None,
        dtype: torch.dtype | None = None,
        nfe_step: int = NFE_STEP,
        init_random: bool = False,
        artifacts: str | None = None,
    ):
        if ode_method not in ("euler", "midpoint"):
            raise ValueError("fixed-step solvers only: euler or midpoint")
        if artifacts:
            raise NotImplementedError(f"serving AOT artifacts {_NOT_PORTED}")
        self.device = resolve_device(device)
        model_cfg = MODEL_CONFIGS[model]
        self.vocab, vocab_size = get_tokenizer(vocab_file or None, model_cfg.tokenizer)
        model_cfg = with_vocab_size(model_cfg, vocab_size)
        self.model_cfg = model_cfg
        self.tokenizer = model_cfg.tokenizer
        if dtype is None:
            dtype = torch.float32 if self.device.type == "cpu" else torch.bfloat16
        self.seed = -1
        self.mel_spec_type = model_cfg.mel.mel_spec_type
        self.target_sample_rate = model_cfg.mel.target_sample_rate
        if self.mel_spec_type != "vocos":
            raise NotImplementedError(f"the {self.mel_spec_type} vocoder {_NOT_PORTED}")

        if ckpt_file.startswith("hf://") or (not ckpt_file and not init_random):
            raise NotImplementedError(
                f"resolving checkpoints from the hub {_NOT_PORTED}: pass ckpt_file= "
                "(a .pt or .safetensors file), or init_random=True")
        if ckpt_file:
            cfm = CFM(model_cfg.arch)
            ckpt_util.load_dit_state(cfm, ckpt_util.load_torch_state(ckpt_file, use_ema=use_ema))
        else:
            cfm = _seeded(lambda: CFM(model_cfg.arch), 0)

        if vocoder_local_path:
            voc = Vocos()
            ckpt_util.load_into(voc, ckpt_util.load_torch_state(vocoder_local_path, use_ema=False))
        elif init_random:
            voc = _seeded(Vocos, 1)
        else:
            raise NotImplementedError(
                f"resolving the vocoder from the hub {_NOT_PORTED}: pass vocoder_local_path=")

        self.engine = InferenceEngine(
            cfm.to(self.device), model_cfg, vocoder=voc.to(self.device), dtype=dtype,
            options=EngineOptions(nfe_step=nfe_step, ode_method=ode_method),
        )

    def export_wav(self, wav, file_wave, remove_silence=False):
        save_wav(file_wave, wav, self.target_sample_rate)

    def infer(
        self,
        ref_file: str | tuple[np.ndarray, int],
        ref_text: str,
        gen_text: str,
        show_info=print,
        progress=None,  # surface compat
        target_rms: float = TARGET_RMS,
        cross_fade_duration: float = CROSS_FADE_DURATION,
        sway_sampling_coef: float = SWAY_SAMPLING_COEF,
        cfg_strength: float = CFG_STRENGTH,
        nfe_step: int = NFE_STEP,
        speed: float = SPEED,
        fix_duration: float | None = None,
        remove_silence: bool = False,
        file_wave: str | None = None,
        file_spec: str | None = None,
        seed: int | None = None,
    ):
        if seed is None:
            seed = random.randint(0, sys.maxsize) % (2**31 - 1)
        self.seed = seed
        if not ref_text.strip():
            raise NotImplementedError(f"transcribing the reference audio (Whisper) {_NOT_PORTED}: "
                                      "pass ref_text")
        if file_spec is not None:
            raise NotImplementedError(f"exporting the spectrogram image {_NOT_PORTED}")
        (wav, sr), ref_text = preprocess_ref_audio_text(ref_file, ref_text, show_info=show_info)
        self.last_ref_text = ref_text

        eng = self.engine
        eng.options = dataclasses.replace(eng.options, nfe_step=nfe_step,
                                          cfg_strength=cfg_strength,
                                          sway_sampling_coef=sway_sampling_coef)
        out_wav, out_sr, spec = infer_process(
            eng, (wav, sr), ref_text, gen_text, self.vocab, tokenizer=self.tokenizer,
            opts=PipelineOptions(target_rms=target_rms, cross_fade_duration=cross_fade_duration,
                                 speed=speed, fix_duration=fix_duration, seed=seed),
            show_info=show_info,
        )
        if remove_silence and out_wav is not None:
            from f5_tts_tpu_torch.audio.silence import remove_silence_edges

            out_wav = remove_silence_edges(out_wav, out_sr)
        if file_wave is not None and out_wav is not None:
            self.export_wav(out_wav, file_wave)
        return out_wav, out_sr, spec
