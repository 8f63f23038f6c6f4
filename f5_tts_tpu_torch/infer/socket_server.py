"""TCP streaming TTS server (reference src/f5_tts/infer/socket_server.py).

JAX counterpart: ``f5_tts_tpu/infer/socket_server.py``.  Protocol preserved:
the client sends utf-8 text, the server streams raw float32 PCM frames and
ends the stream with b"END".  The first text package is chunked smaller for
time to first byte (reference :138-143).  Generation runs through the
engine's CUDA graphs, one per (bucket, batch) key, captured at first use;
with ``--max_batch`` > 1 concurrent connections' chunks merge in a
``DynamicBatcher``.  AOT artifacts are not ported yet (no ``--artifacts``).

    python -m f5_tts_tpu_torch.infer.socket_server --init_random \
        --ref_audio examples/assets/basic_ref_en.wav --ref_text "..."
"""

from __future__ import annotations

import argparse
import queue
import socket
import struct
import threading
import traceback

import numpy as np

from f5_tts_tpu_torch.audio.preprocess import preprocess_ref_audio_text
from f5_tts_tpu_torch.infer import pipeline as P
from f5_tts_tpu_torch.text.chunk import chunk_text


class AudioFileWriterThread(threading.Thread):
    """Optional async wav dump of the streamed audio (reference :32-69)."""

    def __init__(self, output_file: str, sample_rate: int):
        super().__init__(daemon=True)
        self.output_file = output_file
        self.sample_rate = sample_rate
        self.queue: queue.Queue = queue.Queue()
        self.stop_event = threading.Event()
        self.frames: list[np.ndarray] = []

    def run(self):
        while not self.stop_event.is_set() or not self.queue.empty():
            try:
                self.frames.append(self.queue.get(timeout=0.1))
            except queue.Empty:
                continue
        if self.frames and self.output_file:
            from f5_tts_tpu_torch.audio.io import save_wav

            save_wav(self.output_file, np.concatenate(self.frames), self.sample_rate)

    def add_frames(self, frames: np.ndarray):
        self.queue.put(frames)

    def stop(self):
        self.stop_event.set()


class TTSStreamingProcessor:
    def __init__(self, tts, ref_audio: str, ref_text: str, chunk_size: int = 2048):
        self.tts = tts  # F5TTS instance
        self.chunk_size = chunk_size
        (wav, sr), text = preprocess_ref_audio_text(ref_audio, ref_text)
        self.ref = (wav, sr)
        self.ref_text = text
        self.sample_rate = tts.target_sample_rate
        self._warmup()

    def _warmup(self):
        list(self.generate_stream("Warming up the model."))

    def generate_stream(self, text: str):
        """Yields float32 np chunks."""
        # shrink the first package for TTFB (reference socket_server.py:139-142
        # re-chunks the head at max/2 then max/4; hard_max additionally splits
        # at word boundaries so one long clause can't hold the first chunk at
        # a big duration bucket — the dominant TTFB term is first-chunk compute)
        max_chars = 135
        batches = chunk_text(text, max_chars=max_chars)
        if batches:
            head = chunk_text(batches[0], max_chars=max_chars // 4, hard_max=True)
            batches = head + batches[1:]
        gen = P.infer_batch_process(
            self.tts.engine, self.ref, self.ref_text, batches, self.tts.vocab,
            tokenizer=self.tts.tokenizer, opts=P.PipelineOptions(),
            streaming=True, chunk_size=self.chunk_size,
        )
        for chunk, _sr in gen:
            yield np.asarray(chunk, dtype=np.float32)


def handle_client(conn: socket.socket, processor: TTSStreamingProcessor):
    try:
        with conn:
            while True:
                data = conn.recv(8192)
                if not data:
                    break
                text = data.decode("utf-8").strip()
                if not text:
                    continue
                try:
                    for chunk in processor.generate_stream(text):
                        conn.sendall(struct.pack(f"{len(chunk)}f", *chunk.tolist()))
                    conn.sendall(b"END")
                except Exception:
                    traceback.print_exc()
                    conn.sendall(b"END")
    except Exception:
        traceback.print_exc()


def listen(host: str, port: int) -> socket.socket:
    """A listening TCP socket (port 0: any free port, read it back with
    ``getsockname()``)."""
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind((host, port))
    s.listen(5)
    return s


def serve_socket(s: socket.socket, processor: TTSStreamingProcessor):
    """Accept clients on ``s``, one thread each, until ``s`` is shut down
    (``s.shutdown(socket.SHUT_RDWR)``, which wakes a blocked accept)."""
    while True:
        try:
            conn, _ = s.accept()
        except OSError:  # the socket was shut down: stop serving
            return
        threading.Thread(target=handle_client, args=(conn, processor), daemon=True).start()


def start_server(host: str, port: int, processor: TTSStreamingProcessor):
    s = listen(host, port)
    print(f"listening on {host}:{port}")
    serve_socket(s, processor)


def main(argv=None):
    p = argparse.ArgumentParser(prog="f5-tts_socket-server")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=9998)
    p.add_argument("--model", default="F5TTS_v1_Base")
    p.add_argument("--ckpt_file", default="")
    p.add_argument("--vocab_file", default="")
    p.add_argument("--vocoder_local_path", default=None)
    p.add_argument("--ref_audio", required=True)
    p.add_argument("--ref_text", default="")
    p.add_argument("--device", default=None)
    p.add_argument("--init_random", action="store_true")
    p.add_argument("--max_batch", type=int, default=4,
                   help="online dynamic-batching max batch (1 disables)")
    p.add_argument("--queue_delay_ms", type=float, default=4.0)
    args = p.parse_args(argv)

    from f5_tts_tpu_torch.infer.api import F5TTS

    tts = F5TTS(model=args.model, ckpt_file=args.ckpt_file, vocab_file=args.vocab_file,
                vocoder_local_path=args.vocoder_local_path, device=args.device,
                init_random=args.init_random)
    if args.max_batch > 1:
        # concurrent connections' chunks merge into shared device batches
        from f5_tts_tpu_torch.infer.batcher import wrap_engine

        tts.engine = wrap_engine(tts.engine, max_batch=args.max_batch,
                                 queue_delay_ms=args.queue_delay_ms)
    processor = TTSStreamingProcessor(tts, args.ref_audio, args.ref_text)
    start_server(args.host, args.port, processor)


if __name__ == "__main__":
    main()
