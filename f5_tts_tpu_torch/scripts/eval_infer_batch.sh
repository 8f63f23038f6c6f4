#!/usr/bin/env bash
# Orchestrated eval sweep over the PyTorch port (JAX counterpart:
# scripts/eval_infer_batch.sh; reference src/f5_tts/eval/eval_infer_batch.sh):
# 3 seeds x 3 test sets of synthesis, then WER and SIM scoring.
# Usage: f5_tts_tpu_torch/scripts/eval_infer_batch.sh <ckpt_file> [expname]
# PYTHON (default python) picks the interpreter.  The test sets and the
# metric models are read where eval_infer_batch and eval_testset look for
# them (data/, checkpoints/).

set -euo pipefail
CKPT=${1:?usage: eval_infer_batch.sh <ckpt_file> [expname]}
EXP=${2:-F5TTS_v1_Base}
PY=${PYTHON:-python}

for seed in 0 1 2; do
  for testset in seedtts_test_zh seedtts_test_en ls_pc_test_clean; do
    "$PY" -m f5_tts_tpu_torch.eval.eval_infer_batch \
      -s "$seed" -n "$EXP" -p "$CKPT" -t "$testset" -nfe 32
  done
done

for seed in 0 1 2; do
  for t in seedtts_test_zh:zh seedtts_test_en:en; do
    testset=${t%%:*}; lang=${t##*:}
    dir="results/${EXP}_1250000/${testset}/seed${seed}_euler_nfe32_vocos_ss-1.0_cfg2.0_speed1.0"
    "$PY" -m f5_tts_tpu_torch.eval.eval_testset -e wer -l "$lang" -g "$dir" -t "$testset" &
    "$PY" -m f5_tts_tpu_torch.eval.eval_testset -e sim -l "$lang" -g "$dir" -t "$testset" &
  done
done
wait
