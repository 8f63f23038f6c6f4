"""Public Python API: ``F5TTS(...).infer(...)``.

JAX counterpart: ``f5_tts_tpu/infer/api.py:43-296`` (itself the reference
``f5_tts.api.F5TTS`` surface): the same constructor keywords and the same
``infer()`` signature and (wav, sr, spec) return.

``model`` names any shipped architecture of the three backbones
(``F5TTS_v1_Base``, ``E2TTS_Base``, ``F5TTS_MMDiT_Base`` ...), or, with
``model_cfg`` (a reference-schema YAML path, a flat arch dict or a
``ModelConfig``, as JAX takes it), a custom one.  The vocoder follows the
config's ``mel.mel_spec_type``: Vocos, or BigVGAN v2 for ``"bigvgan"``
(JAX ``api.py:127-168``; the released ``F5TTS_Base_bigvgan`` is F5TTS_Base
with that mel).  The engine runs on the card: ``device=None``
means ``"cuda"`` and raises if CUDA is unavailable; only an explicit
``device="cpu"`` runs on the CPU (the backbone then runs in fp32, on the
card in bf16).  Checkpoints load from ``ckpt_file`` / ``vocoder_local_path``
(reference-named ``.pt`` or ``.safetensors``, or a ``.npz`` snapshot in the
JAX package's layout, ``utils/ckpt.save_pytree``) or an ``hf://org/repo/path``
URI; with neither, the model and vocoder names resolve through the local HF
cache first, then a download where the network is reachable
(``utils/hub.py``, JAX ``api.py:92-131``); ``init_random=True`` builds
seeded random weights.  An empty ``ref_text`` is transcribed by Whisper
(``audio/asr.py``, on the ``F5TTS``'s device) when a model resolves, and
``file_spec`` writes the generated mel as an image (JAX ``api.py:186-250``).
AOT artifacts are not ported yet and raise (see ROADMAP.md).

W8A8 serving is an ``EngineOptions`` field, not a keyword here, as in the
JAX ``F5TTS``: build an ``InferenceEngine(..., options=EngineOptions(
quantize=True))``, or replace ``self.engine`` with one.  ``infer()``
updates only the sampler fields of the engine's options
(``dataclasses.replace``), so it keeps whatever ``quantize`` the engine was
built with, as JAX ``api.py:265`` does.
"""

from __future__ import annotations

import dataclasses
import random
import sys
import warnings

import numpy as np
import torch

from f5_tts_tpu_torch.audio.io import load_wav, save_wav
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
from f5_tts_tpu_torch.models.bigvgan import BigVGAN
from f5_tts_tpu_torch.models.cfm import CFM
from f5_tts_tpu_torch.models.configs import MODEL_CONFIGS, from_yaml_dict, with_vocab_size
from f5_tts_tpu_torch.models.vocos import Vocos
from f5_tts_tpu_torch.text.tokenizer import get_tokenizer
from f5_tts_tpu_torch.utils import ckpt as ckpt_util
from f5_tts_tpu_torch.utils import hub
from f5_tts_tpu_torch.utils.device import resolve_device

_NOT_PORTED = "is not ported to the PyTorch package yet (see ROADMAP.md)"


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
        hf_cache_dir: str | None = None,  # local HF cache for name -> file resolution
        dtype: torch.dtype | None = None,
        nfe_step: int = NFE_STEP,
        init_random: bool = False,
        model_cfg: str | dict | None = None,
        artifacts: str | None = None,
    ):
        if ode_method not in ("euler", "midpoint"):
            raise ValueError("fixed-step solvers only: euler or midpoint")
        if artifacts:
            raise NotImplementedError(f"serving AOT artifacts {_NOT_PORTED}")
        self.device = resolve_device(device)
        self.hf_cache_dir = hf_cache_dir
        if isinstance(model_cfg, str):  # a reference configs/*.yaml (infer_cli.py:268-272)
            from f5_tts_tpu_torch.train.cli import parse_simple_yaml

            model_cfg = from_yaml_dict(parse_simple_yaml(model_cfg).get("model", {}))
        elif isinstance(model_cfg, dict):  # a flat arch dict (infer_gradio.py:1037-1068)
            arch_kw = dict(model_cfg)
            backbone = arch_kw.pop("backbone", "DiT")
            model_cfg = from_yaml_dict({"name": model, "backbone": backbone, "arch": arch_kw})
        elif not model_cfg:
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

        if not ckpt_file and not init_random:  # reference api.py:78-81
            ckpt_file = hub.resolve_checkpoint(model, self.mel_spec_type, hf_cache_dir) or ""
        elif ckpt_file.startswith("hf://"):  # reference infer_cli.py:292-293
            resolved = hub.resolve_hf_file(*hub.parse_hf_uri(ckpt_file), hf_cache_dir)
            if resolved is None:
                raise FileNotFoundError(
                    f"{ckpt_file} not in the local HF cache and not downloadable")
            ckpt_file = resolved
        if ckpt_file:
            cfm = CFM(model_cfg.arch)
            if ckpt_file.endswith(".npz"):  # a JAX-layout backbone snapshot (JAX :111-113)
                state = ckpt_util.backbone_state_from_npz(ckpt_file, model_cfg.arch)
            else:
                state = ckpt_util.load_torch_state(ckpt_file, use_ema=use_ema)
            ckpt_util.load_dit_state(cfm, state)
        elif init_random:
            cfm = _seeded(lambda: CFM(model_cfg.arch), 0)
        else:
            raise ValueError(
                f"no checkpoint: {model} was not found in the local HF cache and"
                " could not be downloaded. Pass ckpt_file=, populate the HF cache"
                f" (repo {hub.model_hub_spec(model, self.mel_spec_type)[0]}),"
                " or pass init_random=True for smoke testing.")

        if not vocoder_local_path and not init_random:  # reference utils_infer.py:108-146
            vocoder_local_path = hub.resolve_vocoder(self.mel_spec_type, hf_cache_dir)
        vocoder_cls = BigVGAN if self.mel_spec_type == "bigvgan" else Vocos
        if vocoder_local_path:
            voc = vocoder_cls()
            if vocoder_local_path.endswith(".npz"):  # JAX layout (JAX :136-144)
                tree = ckpt_util.load_pytree(vocoder_local_path)
                vstate = (ckpt_util.bigvgan_state_from_jax_params(tree) if vocoder_cls is BigVGAN
                          else ckpt_util.vocos_state_from_jax_params(tree))
            else:
                vstate = ckpt_util.load_torch_state(vocoder_local_path, use_ema=False)
            if vocoder_cls is BigVGAN:
                ckpt_util.load_bigvgan_state(voc, vstate)
            else:
                ckpt_util.load_into(voc, vstate)
        elif init_random:
            voc = _seeded(vocoder_cls, 1)
        else:
            voc = None
            warnings.warn(
                "no vocoder weights (vocoder_local_path not set and init_random=False): the "
                "engine runs mel-only and waveform calls will fail; download Vocos/BigVGAN "
                "weights and pass vocoder_local_path",
                stacklevel=2)

        self.engine = InferenceEngine(
            cfm.to(self.device), model_cfg, vocoder=None if voc is None else voc.to(self.device),
            dtype=dtype, options=EngineOptions(nfe_step=nfe_step, ode_method=ode_method),
        )

    def transcribe(self, ref_audio, language=None):
        """Whisper's transcript of a path or a (wav, sr) pair (reference
        api.py:86-96)."""
        from f5_tts_tpu_torch.audio.asr import make_whisper_transcriber

        fn = make_whisper_transcriber(language=language, hf_cache_dir=self.hf_cache_dir,
                                      device=str(self.device))
        wav, sr = load_wav(ref_audio) if isinstance(ref_audio, str) else ref_audio
        return fn(wav, sr)

    def export_wav(self, wav, file_wave, remove_silence=False):
        save_wav(file_wave, wav, self.target_sample_rate)

    def export_spectrogram(self, spec, file_spec):
        """The mel [n_mels, frames] as an image (matplotlib, imported here)."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.figure(figsize=(12, 4))
        plt.imshow(spec, origin="lower", aspect="auto")
        plt.colorbar()
        plt.savefig(file_spec)
        plt.close()

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
        transcribe_fn = None
        if not ref_text.strip():
            # resolve once, against the constructor's HF cache, and hand the
            # snapshot on (JAX api.py:230-243); nothing resolved: the
            # preprocessing raises, as JAX's does
            from f5_tts_tpu_torch.audio.asr import make_whisper_transcriber

            wpath = hub.resolve_whisper(hf_cache_dir=self.hf_cache_dir)
            if wpath:
                transcribe_fn = make_whisper_transcriber(wpath, device=str(self.device))
        (wav, sr), ref_text = preprocess_ref_audio_text(ref_file, ref_text, show_info=show_info,
                                                        transcribe_fn=transcribe_fn)
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
        if file_spec is not None and spec is not None:
            self.export_spectrogram(spec, file_spec)
        return out_wav, out_sr, spec
