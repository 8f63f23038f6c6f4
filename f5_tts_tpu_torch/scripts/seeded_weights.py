"""Seeded random weights in the reference's file layouts, for the serving
and eval pipelines (``run_serving.sh``, ``eval_infer_batch.sh``) where no
released checkpoint is on the machine.

Writes ``<out>/<model>.safetensors`` (the backbone, EMA-prefixed as a
release, ``utils/ckpt.export_safetensors``) and ``<out>/vocos.pt`` (the
Vocos state dict, ``utils/ckpt.write_checkpoint``), holding what
``F5TTS(model=..., init_random=True)`` builds: the CFM from seed 0, Vocos
from seed 1.  Prints the two paths.

    python -m f5_tts_tpu_torch.scripts.seeded_weights OUT_DIR [--model F5TTS_v1_Base]
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> tuple[str, str]:
    ap = argparse.ArgumentParser(prog="seeded_weights")
    ap.add_argument("out")
    ap.add_argument("--model", default="F5TTS_v1_Base")
    args = ap.parse_args(argv)

    from f5_tts_tpu_torch.infer.api import _seeded
    from f5_tts_tpu_torch.models.cfm import CFM
    from f5_tts_tpu_torch.models.configs import MODEL_CONFIGS, with_vocab_size
    from f5_tts_tpu_torch.models.vocos import Vocos
    from f5_tts_tpu_torch.text.tokenizer import get_tokenizer
    from f5_tts_tpu_torch.utils.ckpt import export_safetensors, write_checkpoint

    cfg = MODEL_CONFIGS[args.model]
    _, vocab_size = get_tokenizer(None, cfg.tokenizer)
    cfg = with_vocab_size(cfg, vocab_size)
    os.makedirs(args.out, exist_ok=True)
    model_path = os.path.join(args.out, f"{args.model}.safetensors")
    voc_path = os.path.join(args.out, "vocos.pt")
    export_safetensors(_seeded(lambda: CFM(cfg.arch), 0).state_dict(), model_path)
    write_checkpoint(voc_path, _seeded(Vocos, 1).state_dict())
    print(model_path)
    print(voc_path)
    return model_path, voc_path


if __name__ == "__main__":
    main()
