"""gRPC TTS server — the Triton-gRPC-surface counterpart
(reference runtime/triton_trtllm/: Triton serves model "f5_tts" over gRPC
with dynamic batching; clients are client_grpc.py).

Stack: gRPC thread-pool front-end -> shared inference pipeline -> online
DynamicBatcher -> bucketed compiled engine.  Concurrent RPCs merge into
shared device batches exactly like the HTTP/socket paths.

    python -m f5_tts_tpu_torch.runtime.grpc_server --ref_audio ref.wav \
        --ref_text "..." --port 50051 --max_batch 4

JAX counterpart: ``f5_tts_tpu/runtime/grpc_server.py``.  The port has no
XLA compile cache to enable at start-up (its kernels build once into
``ops/cuda_build.py``'s cache), and takes ``--device`` (the card unless
``cpu`` is asked for).
"""

from __future__ import annotations

import argparse
import io
import json
import threading
import wave
from concurrent import futures

import numpy as np

from f5_tts_tpu_torch.runtime.grpc_api import f5tts_pb2 as pb
from f5_tts_tpu_torch.runtime.grpc_api.stubs import F5TTSServicer, add_f5tts_servicer


def _decode_wav_bytes(data: bytes) -> tuple[np.ndarray, int]:
    with wave.open(io.BytesIO(data), "rb") as w:
        sr = w.getframerate()
        pcm = np.frombuffer(w.readframes(w.getnframes()), dtype="<i2")
        if w.getnchannels() > 1:
            pcm = pcm.reshape(-1, w.getnchannels()).mean(axis=1)
    return pcm.astype(np.float32) / 32767.0, sr


class TTSService(F5TTSServicer):
    def __init__(self, tts, ref_audio: str, ref_text: str, batcher=None,
                 stream_chunk_s: float = 0.25):
        from f5_tts_tpu_torch.audio.preprocess import preprocess_ref_audio_text

        self.tts = tts
        self.batcher = batcher
        self.stream_chunk_s = stream_chunk_s
        self.default_ref, self.default_ref_text = preprocess_ref_audio_text(ref_audio, ref_text)
        # per-(ref bytes) preprocess cache for request-supplied references
        self._ref_cache: dict[int, tuple] = {}
        self._ref_cache_lock = threading.Lock()

    def _resolve_ref(self, request):
        if not request.reference_wav:
            return self.default_ref, self.default_ref_text
        key = hash(request.reference_wav)
        with self._ref_cache_lock:
            hit = self._ref_cache.get(key)
        if hit is not None:
            return hit
        wav, sr = _decode_wav_bytes(request.reference_wav)
        ref = ((wav, sr), request.reference_text or self.default_ref_text)
        with self._ref_cache_lock:
            if len(self._ref_cache) > 64:
                self._ref_cache.clear()
            self._ref_cache[key] = ref
        return ref

    def _synthesize(self, request):
        from f5_tts_tpu_torch.infer import pipeline as P

        ref, ref_text = self._resolve_ref(request)
        opts = P.PipelineOptions(
            seed=int(request.seed) if request.has_seed else None,
            speed=request.speed or P.SPEED,
        )
        wav, sr, _ = P.infer_process(
            self.tts.engine, ref, ref_text, request.target_text, self.tts.vocab,
            tokenizer=self.tts.tokenizer, opts=opts, show_info=lambda *a, **k: None,
        )
        if wav is None:
            wav = np.zeros(0, np.float32)
        return wav, sr

    # ------------------------------------------------------------------ RPCs
    def Synthesize(self, request, context):
        wav, sr = self._synthesize(request)
        pcm = (np.clip(wav, -1, 1) * 32767.0).astype("<i2")
        return pb.SynthesizeResponse(
            waveform=pcm.tobytes(), sample_rate=sr, duration_s=len(wav) / sr
        )

    def SynthesizeStream(self, request, context):
        wav, sr = self._synthesize(request)
        pcm = (np.clip(wav, -1, 1) * 32767.0).astype("<i2")
        step = max(1, int(self.stream_chunk_s * sr))
        for i in range(0, len(pcm), step):
            chunk = pcm[i : i + step]
            yield pb.SynthesizeResponse(
                waveform=chunk.tobytes(), sample_rate=sr, duration_s=len(chunk) / sr
            )

    def GetStats(self, request, context):
        stats = self.batcher.stats() if self.batcher is not None else {"batching": "off"}
        return pb.StatsResponse(json=json.dumps(stats))

    def Health(self, request, context):
        return pb.HealthResponse(status="ok")


def make_server(tts, ref_audio: str, ref_text: str, port: int = 50051,
                host: str = "0.0.0.0", max_batch: int = 4,
                queue_delay_ms: float = 4.0, max_workers: int = 16):
    """Returns (grpc.Server, bound_port)."""
    import grpc

    batcher = None
    if max_batch > 1:
        from f5_tts_tpu_torch.infer.batcher import BatchedEngine, DynamicBatcher

        batcher = DynamicBatcher(tts.engine, max_batch=max_batch,
                                 queue_delay_ms=queue_delay_ms)
        tts.engine = BatchedEngine(batcher)
    service = TTSService(tts, ref_audio, ref_text, batcher=batcher)
    server = grpc.server(
        futures.ThreadPoolExecutor(max_workers=max_workers),
        options=[("grpc.max_receive_message_length", 64 * 1024 * 1024),
                 ("grpc.max_send_message_length", 64 * 1024 * 1024)],
    )
    add_f5tts_servicer(server, service)
    bound = server.add_insecure_port(f"{host}:{port}")
    return server, bound


def main(argv=None):
    p = argparse.ArgumentParser(prog="f5-tts_grpc-server")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=50051)
    p.add_argument("--model", default="F5TTS_v1_Base")
    p.add_argument("--ckpt_file", default="")
    p.add_argument("--vocab_file", default="")
    p.add_argument("--vocoder_local_path", default=None)
    p.add_argument("--ref_audio", required=True)
    p.add_argument("--ref_text", default="")
    p.add_argument("--nfe_step", type=int, default=16)
    p.add_argument("--init_random", action="store_true")
    p.add_argument("--max_batch", type=int, default=4)
    p.add_argument("--queue_delay_ms", type=float, default=4.0)
    p.add_argument("--max_workers", type=int, default=16)
    p.add_argument("--artifacts", default=None,
                   help="AOT artifact dir (f5-tts_build-engine output)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from f5_tts_tpu_torch.infer.api import F5TTS

    tts = F5TTS(model=args.model, ckpt_file=args.ckpt_file, vocab_file=args.vocab_file,
                vocoder_local_path=args.vocoder_local_path, nfe_step=args.nfe_step,
                init_random=args.init_random, artifacts=args.artifacts,
                artifacts_fallback=True, device=args.device)
    server, bound = make_server(
        tts, args.ref_audio, args.ref_text, port=args.port, host=args.host,
        max_batch=args.max_batch, queue_delay_ms=args.queue_delay_ms,
        max_workers=args.max_workers,
    )
    server.start()
    print(f"gRPC TTS on {args.host}:{bound} (max_batch={args.max_batch})", flush=True)
    server.wait_for_termination()


if __name__ == "__main__":
    main()
