"""LibriSpeech-PC cross-sentence WER/SIM scoring
(reference eval/eval_librispeech_test_clean.py) — preset wrapper.

JAX counterpart: ``f5_tts_tpu/eval/eval_librispeech_test_clean.py`` (a copy with the imports
changed to the port's).
"""

from __future__ import annotations

import argparse

from f5_tts_tpu_torch.eval import eval_testset


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-e", "--eval_task", default="wer", choices=["wer", "sim"])
    p.add_argument("-g", "--gen_wav_dir", required=True)
    p.add_argument("--metalst_root", default="data")
    p.add_argument("--librispeech_test_clean_path", default="data/LibriSpeech/test-clean")
    p.add_argument("--ckpt_dir", default="checkpoints")
    p.add_argument("--sim_ckpt", default="checkpoints/wavlm_large_finetune.pth")
    p.add_argument("--device", default=None, help="the SIM model's device: cuda (default) or cpu")
    a = p.parse_args(argv)
    return eval_testset.main([
        "-e", a.eval_task, "-l", "en", "-g", a.gen_wav_dir, "-t", "ls_pc_test_clean",
        "--metalst_root", a.metalst_root,
        "--librispeech_test_clean_path", a.librispeech_test_clean_path,
        "--ckpt_dir", a.ckpt_dir, "--sim_ckpt", a.sim_ckpt,
        *(["--device", a.device] if a.device else []),
    ])


if __name__ == "__main__":
    main()
