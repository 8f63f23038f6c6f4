#!/usr/bin/env bash
# Serving deployment pipeline over the PyTorch port (JAX counterpart:
# scripts/run_serving.sh; reference runtime/triton_trtllm/run.sh stages):
#   1. build the AOT serving bundle (set ARTIFACTS=), or use the live engine
#   2. start the HTTP server (the live engine captures its CUDA graphs with
#      engine.warmup_all before it listens)
#   3. smoke-test a request           4. offline RTF benchmark
# Usage: f5_tts_tpu_torch/scripts/run_serving.sh <ckpt_file> <vocos_ckpt> <ref_wav> "<ref text>"
# Default: the bundle under artifacts/ with its kernels packaged (--warm).
#   ARTIFACTS=other/dir f5_tts_tpu_torch/scripts/run_serving.sh ...   # another bundle location
#   ARTIFACTS= f5_tts_tpu_torch/scripts/run_serving.sh ...            # the live engine
# PYTHON (default python) and DEVICE (default cuda) pick the interpreter
# and the device.  Each stage prints its wall in seconds.

set -euo pipefail
CKPT=${1:?ckpt file}
VOC=${2:?vocos ckpt}
REF=${3:?ref wav}
REF_TEXT=${4:?ref text}
PORT=${PORT:-8000}
ARTIFACTS=${ARTIFACTS-artifacts}
PY=${PYTHON:-python}
DEVICE=${DEVICE:-cuda}

now() { date +%s.%N; }
lap() { awk -v a="$1" -v b="$(now)" -v s="$2" 'BEGIN { printf "[%s] wall %.2f s\n", s, b - a }'; }

t=$(now)
if [[ -n "$ARTIFACTS" ]]; then
  echo "[1/4] building the AOT serving bundle -> $ARTIFACTS"
  # --warm packages the built kernels with the bundle: a cold server builds none
  "$PY" -m f5_tts_tpu_torch.scripts.build_engine --out "$ARTIFACTS" --model F5TTS_v1_Base \
    --nfe 16 --ckpt "$CKPT" --vocoder "$VOC" --batches 1 2 --buckets 1024 --ref-buckets 512 \
    --device "$DEVICE" --warm
  AOT_FLAG=(--artifacts "$ARTIFACTS")
else
  echo "[1/4] live engine: the server warms its graphs at start (engine.warmup_all)"
  AOT_FLAG=()
fi
lap "$t" 1/4

t=$(now)
echo "[2/4] starting the HTTP server on :$PORT"
if [[ -n "$ARTIFACTS" ]]; then
  "$PY" -m f5_tts_tpu_torch.infer.http_server --ckpt_file "$CKPT" --vocoder_local_path "$VOC" \
    --ref_audio "$REF" --ref_text "$REF_TEXT" --port "$PORT" --device "$DEVICE" \
    --nfe_step 16 "${AOT_FLAG[@]}" &
else
  REF="$REF" REF_TEXT="$REF_TEXT" CKPT="$CKPT" VOC="$VOC" PORT="$PORT" DEVICE="$DEVICE" \
  "$PY" - <<'PY' &
import os

from f5_tts_tpu_torch.infer.api import F5TTS
from f5_tts_tpu_torch.infer.http_server import serve

e = os.environ
tts = F5TTS(model="F5TTS_v1_Base", ckpt_file=e["CKPT"], vocoder_local_path=e["VOC"],
            nfe_step=16, device=e["DEVICE"])
tts.engine.warmup_all([512, 1024, 2048], (1,))
serve(tts, e["REF"], e["REF_TEXT"], "0.0.0.0", int(e["PORT"]))
PY
fi
SERVER_PID=$!
trap 'kill $SERVER_PID 2>/dev/null || true; wait $SERVER_PID 2>/dev/null || true' EXIT
PORT="$PORT" SERVER_PID="$SERVER_PID" "$PY" - <<'PY'
import os
import time
import urllib.request

deadline = time.time() + 900
while True:
    try:
        urllib.request.urlopen(f"http://localhost:{os.environ['PORT']}/health", timeout=5)
        break
    except OSError:
        if time.time() > deadline or not os.path.exists(f"/proc/{os.environ['SERVER_PID']}"):
            raise SystemExit("the HTTP server did not come up")
        time.sleep(1)
PY
lap "$t" 2/4

t=$(now)
echo "[3/4] smoke test"
PORT="$PORT" "$PY" - <<'PY'
import os

from f5_tts_tpu_torch.infer.http_server import request_tts

wav, sr = request_tts("Hello from the serving pipeline.", port=int(os.environ["PORT"]))
print(f"got {len(wav)/sr:.2f}s of audio")
PY
lap "$t" 3/4

t=$(now)
echo "[4/4] offline benchmark"
"$PY" -m f5_tts_tpu_torch.runtime.benchmark --backend-type flash --nfe 16 \
  --ckpt_file "$CKPT" --vocoder_local_path "$VOC" --device "$DEVICE"
lap "$t" 4/4
