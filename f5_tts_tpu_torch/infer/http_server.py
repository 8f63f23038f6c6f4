"""HTTP TTS server and client (replaces the reference's Triton HTTP
surface, runtime/triton_trtllm/client_http.py).

JAX counterpart: ``f5_tts_tpu/infer/http_server.py``.  POST /tts with JSON
{"text": ..., "seed": optional} -> WAV bytes; GET /health ->
{"status": "ok"}; GET /stats -> the dynamic batcher's queue and compute
stats.  stdlib ``http.server`` (threaded); generation goes through the
engine's CUDA graphs, as the CLI and socket paths do.  ``serve(...,
ready=fn)`` hands the server to ``fn`` before it serves, so a caller can
read its port and ``shutdown()`` it; the batcher is then closed and the
``F5TTS`` gets its engine back.  AOT artifacts are not ported yet (no
``--artifacts``).

    python -m f5_tts_tpu_torch.infer.http_server --init_random \
        --ref_audio examples/assets/basic_ref_en.wav --ref_text "..."
"""

from __future__ import annotations

import argparse
import io
import json
import threading
import wave
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


def wav_bytes(wav: np.ndarray, sample_rate: int) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        pcm = (np.clip(wav, -1, 1) * 32767).astype("<i2")
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


class _NullLock:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def make_handler(tts, ref, ref_text, lock, batcher=None):
    from f5_tts_tpu_torch.infer import pipeline as P

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass

        def _json(self, obj, status=200):
            body = json.dumps(obj).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._json({"status": "ok"})
            elif self.path == "/stats":
                # dynamic-batching queue/compute stats (Triton inference-statistics
                # equivalent, reference client_grpc.py:425-447)
                self._json(batcher.stats() if batcher is not None else {"batching": "off"})
            else:
                self.send_response(404)
                self.end_headers()

        def do_POST(self):
            if self.path != "/tts":
                self.send_response(404)
                self.end_headers()
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length))
                text = req["text"]
                opts = P.PipelineOptions(seed=req.get("seed"))
                with lock:  # one compiled-graph call at a time per process
                    wav, sr, _ = P.infer_process(
                        tts.engine, ref, ref_text, text, tts.vocab,
                        tokenizer=tts.tokenizer, opts=opts,
                        show_info=lambda *a, **k: None,
                    )
                body = wav_bytes(wav, sr)
                self.send_response(200)
                self.send_header("Content-Type", "audio/wav")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            except Exception as e:  # noqa: BLE001
                body = json.dumps({"error": str(e)}).encode()
                self.send_response(500)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

    return Handler


def serve(tts, ref_audio: str, ref_text: str, host="0.0.0.0", port=8000,
          max_batch: int = 4, queue_delay_ms: float = 4.0, ready=None):
    from f5_tts_tpu_torch.audio.preprocess import preprocess_ref_audio_text

    ref, text = preprocess_ref_audio_text(ref_audio, ref_text)
    engine = tts.engine
    batcher = None
    if max_batch > 1:
        # online dynamic batching: concurrent /tts requests merge into shared
        # device batches (Triton dynamic_batching equivalent, config.pbtxt:15-20)
        from f5_tts_tpu_torch.infer.batcher import BatchedEngine, DynamicBatcher

        batcher = DynamicBatcher(engine, max_batch=max_batch, queue_delay_ms=queue_delay_ms)
        tts.engine = BatchedEngine(batcher)
        lock = _NullLock()  # the batcher serializes device work
    else:
        lock = threading.Lock()
    handler = make_handler(tts, ref, text, lock, batcher=batcher)
    server = ThreadingHTTPServer((host, port), handler)
    print(f"HTTP TTS on {host}:{server.server_address[1]} (max_batch={max_batch})")
    if ready is not None:
        ready(server)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        if batcher is not None:
            batcher.close()
            tts.engine = engine


def request_tts(text: str, host="localhost", port=8000, seed=None, timeout=300) -> tuple[np.ndarray, int]:
    """Client: returns (wav float32, sample_rate)."""
    import http.client

    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    body = json.dumps({"text": text, "seed": seed})
    conn.request("POST", "/tts", body, {"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    if resp.status != 200:
        raise RuntimeError(f"server error {resp.status}: {data[:200]}")
    with wave.open(io.BytesIO(data), "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        pcm = np.frombuffer(w.readframes(n), dtype="<i2")
    return pcm.astype(np.float32) / 32767.0, sr


def main(argv=None):
    p = argparse.ArgumentParser(prog="f5-tts_http-server")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--model", default="F5TTS_v1_Base")
    p.add_argument("--ckpt_file", default="")
    p.add_argument("--vocoder_local_path", default=None)
    p.add_argument("--ref_audio", required=True)
    p.add_argument("--ref_text", default="")
    p.add_argument("--init_random", action="store_true")
    p.add_argument("--nfe_step", type=int, default=32)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--max_batch", type=int, default=4,
                   help="online dynamic-batching max batch (1 disables)")
    p.add_argument("--queue_delay_ms", type=float, default=4.0,
                   help="batch window opened by the first queued request")
    args = p.parse_args(argv)
    from f5_tts_tpu_torch.infer.api import F5TTS

    tts = F5TTS(model=args.model, ckpt_file=args.ckpt_file,
                vocoder_local_path=args.vocoder_local_path,
                nfe_step=args.nfe_step, init_random=args.init_random, device=args.device)
    serve(tts, args.ref_audio, args.ref_text, args.host, args.port,
          max_batch=args.max_batch, queue_delay_ms=args.queue_delay_ms)


if __name__ == "__main__":
    main()
