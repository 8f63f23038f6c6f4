"""Command-line inference (reference src/f5_tts/infer/infer_cli.py).

JAX counterpart: ``f5_tts_tpu/infer/cli.py``: the same flags and defaults,
the same TOML handling (flags override the TOML, which overrides the
defaults; asset paths resolve relative to the TOML; multi-voice ``[voice]``
tags in gen_text with per-voice TOML tables).  Model names and ``hf://``
paths resolve through the local HF cache (``utils/hub.py``); --ckpt_file /
--vocoder_local_path load local weights.  It runs on the card unless
``--device cpu``.  The vocoder follows the model config's
``mel_spec_type``; a ``--vocoder_name`` that disagrees with it raises
``ValueError`` (JAX parses the flag and never reads it).  JAX's persistent
compilation cache has no counterpart:
the engine's CUDA graphs live in their process and are captured again at
each start.

    python -m f5_tts_tpu_torch.infer.cli -c examples/basic.toml --init_random
"""

from __future__ import annotations

import argparse
import os
import re
import tomllib
from datetime import datetime

import numpy as np

from f5_tts_tpu_torch.audio.io import save_wav
from f5_tts_tpu_torch.audio.preprocess import preprocess_ref_audio_text
from f5_tts_tpu_torch.infer import pipeline as P


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="f5-tts_infer-cli",
        description="CLI for F5/E2 TTS on a CUDA card with batch processing.",
    )
    p.add_argument("-c", "--config", type=str, default="", help="TOML config path")
    p.add_argument("-m", "--model", type=str)
    p.add_argument("-mc", "--model_cfg", type=str,
                   help="custom model-arch YAML (reference configs/*.yaml schema)")
    p.add_argument("-p", "--ckpt_file", type=str)
    p.add_argument("-v", "--vocab_file", type=str)
    p.add_argument("-r", "--ref_audio", type=str)
    p.add_argument("-s", "--ref_text", type=str)
    p.add_argument("-t", "--gen_text", type=str)
    p.add_argument("-f", "--gen_file", type=str)
    p.add_argument("-o", "--output_dir", type=str)
    p.add_argument("-w", "--output_file", type=str)
    p.add_argument("--save_chunk", action="store_true")
    p.add_argument("--no_legacy_text", action="store_false", dest="use_legacy_text",
                   help="keep unicode chunk file names instead of lossy ASCII "
                   "transliterations (reference infer_cli.py:116-120)")
    p.add_argument("--remove_silence", action="store_true")
    p.add_argument("--vocoder_name", type=str, choices=["vocos", "bigvgan"])
    p.add_argument("--vocoder_local_path", type=str)
    p.add_argument("--target_rms", type=float)
    p.add_argument("--cross_fade_duration", type=float)
    p.add_argument("--nfe_step", type=int)
    p.add_argument("--cfg_strength", type=float)
    p.add_argument("--sway_sampling_coef", type=float)
    p.add_argument("--speed", type=float)
    p.add_argument("--fix_duration", type=float)
    p.add_argument("--device", type=str)
    p.add_argument("--init_random", action="store_true",
                   help="random weights (smoke testing without a checkpoint)")
    return p


def _ascii_transliterate(s: str) -> str:
    """Lossy ASCII file-name form (the reference uses ``unidecode``,
    infer_cli.py:365-366); prefer the library when installed, else NFKD-fold
    and drop what has no ASCII decomposition."""
    try:
        from unidecode import unidecode

        return unidecode(s)
    except ImportError:
        import unicodedata

        return unicodedata.normalize("NFKD", s).encode("ascii", "ignore").decode()


def load_config(args) -> dict:
    config = {}
    if args.config:
        with open(args.config, "rb") as f:
            config = tomllib.load(f)
        # resolve file paths relative to the TOML's own directory when they
        # don't exist from the cwd — the bundled examples/*.toml reference
        # their assets/ clips this way, so `f5-tts_infer-cli -c examples/
        # basic.toml` works from any directory (the reference gets the same
        # effect with importlib-resource paths, infer_cli.py:126-140)
        base = os.path.dirname(os.path.abspath(args.config))
        for section in [config, *config.get("voices", {}).values()]:
            for key in ("ref_audio", "gen_file"):
                p = section.get(key)
                if p and not os.path.isabs(p) and not os.path.exists(p):
                    cand = os.path.join(base, p)
                    if os.path.exists(cand):
                        section[key] = cand
    return config


def _mel_spec_type(model: str, model_cfg: str | None) -> str:
    """The mel front end (and so the vocoder) of the model ``F5TTS`` builds."""
    if model_cfg:
        from f5_tts_tpu_torch.models.configs import from_yaml_dict
        from f5_tts_tpu_torch.train.cli import parse_simple_yaml

        return from_yaml_dict(parse_simple_yaml(model_cfg).get("model", {})).mel.mel_spec_type
    from f5_tts_tpu_torch.models.configs import MODEL_CONFIGS

    return MODEL_CONFIGS[model].mel.mel_spec_type


def main(argv=None) -> str | None:
    args = build_parser().parse_args(argv)
    config = load_config(args)

    def opt(name, default=None):
        v = getattr(args, name, None)
        # identity checks, not `in`: 0 == False and 0.0 == False in Python,
        # which used to drop explicit zero flags (e.g. --sway_sampling_coef 0)
        if v is not None and v is not False and v != "":
            return v
        return config.get(name, default)

    from f5_tts_tpu_torch.infer.api import F5TTS

    model = opt("model", "F5TTS_v1_Base")
    vocoder_name = opt("vocoder_name")
    if vocoder_name:
        mel_type = _mel_spec_type(model, opt("model_cfg") or None)
        if vocoder_name != mel_type:
            raise ValueError(f"--vocoder_name {vocoder_name} disagrees with the model config's "
                             f"mel_spec_type {mel_type!r}: the vocoder follows the config")
    tts = F5TTS(
        model=model,
        ckpt_file=opt("ckpt_file", "") or "",
        vocab_file=opt("vocab_file", "") or "",
        vocoder_local_path=opt("vocoder_local_path"),
        device=opt("device"),
        nfe_step=int(opt("nfe_step", P.NFE_STEP)),
        init_random=bool(opt("init_random", False)),
        model_cfg=opt("model_cfg") or None,
    )
    cfg_strength = float(opt("cfg_strength", P.CFG_STRENGTH))
    sway = float(opt("sway_sampling_coef", P.SWAY_SAMPLING_COEF))
    if (cfg_strength != tts.engine.options.cfg_strength
            or sway != tts.engine.options.sway_sampling_coef):
        import dataclasses

        tts.engine.options = dataclasses.replace(
            tts.engine.options, cfg_strength=cfg_strength, sway_sampling_coef=sway
        )

    gen_text = opt("gen_text", "")
    gen_file = opt("gen_file", "")
    if gen_file:
        gen_text = open(gen_file, "r", encoding="utf-8").read()

    main_voice = {"ref_audio": opt("ref_audio"), "ref_text": opt("ref_text", "")}
    voices = dict(config.get("voices", {}))
    voices["main"] = main_voice
    for name, v in voices.items():
        v["ref"], v["ref_text"] = preprocess_ref_audio_text(v["ref_audio"], v["ref_text"])

    speed = float(opt("speed", P.SPEED))
    segments = []
    for text in re.split(r"(?=\[\w+\])", gen_text):
        if not text.strip():
            continue
        m = re.match(r"\[(\w+)\]", text)
        voice = m[1] if m and m[1] in voices else "main"
        text = re.sub(r"\[(\w+)\]", "", text).strip()
        v = voices[voice]
        out_wav, sr, spec = P.infer_process(
            tts.engine, v["ref"], v["ref_text"], text, tts.vocab, tokenizer=tts.tokenizer,
            opts=P.PipelineOptions(
                target_rms=float(opt("target_rms", P.TARGET_RMS)),
                cross_fade_duration=float(opt("cross_fade_duration", P.CROSS_FADE_DURATION)),
                speed=float(voices[voice].get("speed", speed)),
                fix_duration=opt("fix_duration", P.FIX_DURATION),
            ),
        )
        if out_wav is not None:
            segments.append((out_wav, text))

    if not segments:
        print("no audio generated")
        return None
    final = np.concatenate([w for w, _ in segments])
    out_dir = opt("output_dir", "tests")
    os.makedirs(out_dir, exist_ok=True)
    out_file = opt("output_file", f"infer_cli_{datetime.now().strftime('%Y%m%d_%H%M%S')}.wav")
    path = os.path.join(out_dir, out_file)
    if bool(opt("remove_silence", False)):
        from f5_tts_tpu_torch.audio.silence import remove_silence_edges

        final = remove_silence_edges(final, tts.target_sample_rate)
    save_wav(path, final, tts.target_sample_rate)
    if bool(opt("save_chunk", False)):
        # chunk files carry their text (reference infer_cli.py:362-370:
        # "{i}_{text}.wav", truncated at 200 chars; legacy mode transliterates
        # to ASCII for .wav-unfriendly filesystems)
        # not via opt(): store_false means an explicit False IS the signal
        legacy = args.use_legacy_text and not config.get("no_legacy_text", False)
        chunk_dir = os.path.join(out_dir, f"{os.path.splitext(out_file)[0]}_chunks")
        os.makedirs(chunk_dir, exist_ok=True)
        for i, (seg, seg_text) in enumerate(segments):
            name = seg_text[:200] + " ... " if len(seg_text) > 200 else seg_text
            if legacy:
                name = _ascii_transliterate(name)
            name = re.sub(r"[/\\\0]", "_", name)
            save_wav(os.path.join(chunk_dir, f"{i}_{name}.wav"), seg, tts.target_sample_rate)
    print(path)
    return path


if __name__ == "__main__":
    main()
