"""Speech-editing CLI (reference speech_edit.py is a script with hardcoded
demo values; this exposes the same operation with flags).

JAX counterpart: ``f5_tts_tpu/infer/speech_edit_cli.py``, with the same
flags plus ``--device`` (the card unless ``cpu``).

    python -m f5_tts_tpu_torch.infer.speech_edit_cli --init_random \
        --audio examples/assets/basic_ref_en.wav --original_text "..." \
        --target_text "..." --edit 0.5,1.0
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(prog="f5-tts_speech-edit")
    p.add_argument("--model", default="F5TTS_v1_Base")
    p.add_argument("--ckpt_file", default="")
    p.add_argument("--vocoder_local_path", default=None)
    p.add_argument("--audio", required=True, help="source wav")
    p.add_argument("--original_text", required=True)
    p.add_argument("--target_text", required=True)
    p.add_argument("--edit", action="append", required=True,
                   help="span to regenerate as start,end seconds (repeatable)")
    p.add_argument("--fix_duration", action="append", type=float, default=None,
                   help="per-span replacement duration in seconds (repeatable)")
    p.add_argument("--output", default="speech_edit_out.wav")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--nfe_step", type=int, default=32)
    p.add_argument("--init_random", action="store_true")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from f5_tts_tpu_torch.audio.io import save_wav
    from f5_tts_tpu_torch.infer.api import F5TTS
    from f5_tts_tpu_torch.infer.speech_edit import edit_speech

    spans = []
    for s in args.edit:
        a, b = s.split(",")
        spans.append((float(a), float(b)))

    tts = F5TTS(model=args.model, ckpt_file=args.ckpt_file,
                vocoder_local_path=args.vocoder_local_path,
                nfe_step=args.nfe_step, init_random=args.init_random, device=args.device)
    wav, sr = edit_speech(
        tts.engine, tts.vocab, tts.tokenizer, args.audio,
        args.original_text, args.target_text, spans,
        fix_durations=args.fix_duration, seed=args.seed,
    )
    save_wav(args.output, wav, sr)
    print(args.output)


if __name__ == "__main__":
    main()
