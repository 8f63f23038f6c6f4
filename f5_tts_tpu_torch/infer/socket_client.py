"""Socket streaming client (reference src/f5_tts/infer/socket_client.py):
receives float32 PCM until b"END"; plays via pyaudio if available, else
saves a wav.

JAX counterpart: ``f5_tts_tpu/infer/socket_client.py``, copied.

    python -m f5_tts_tpu_torch.infer.socket_client --text "Hello there."
"""

from __future__ import annotations

import argparse
import socket

import numpy as np


def listen_to_f5tts(text: str, server_ip="localhost", server_port=9998) -> np.ndarray:
    client = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    client.connect((server_ip, server_port))
    client.sendall(text.encode("utf-8"))
    buf = bytearray()
    chunks = []
    try:
        while True:
            data = client.recv(8192)
            if not data:
                break
            buf.extend(data)
            if buf.endswith(b"END"):
                payload = bytes(buf[:-3])
                if payload:
                    chunks.append(np.frombuffer(payload, dtype=np.float32))
                break
            # drain full float32 frames, keep remainder
            usable = len(buf) - (len(buf) % 4)
            if usable:
                chunks.append(np.frombuffer(bytes(buf[:usable]), dtype=np.float32))
                del buf[:usable]
    finally:
        client.close()
    return np.concatenate(chunks) if chunks else np.zeros(0, np.float32)


def main(argv=None):
    p = argparse.ArgumentParser(prog="f5-tts_socket-client")
    p.add_argument("--host", default="localhost")
    p.add_argument("--port", type=int, default=9998)
    p.add_argument("--text", required=True)
    p.add_argument("--output", default="socket_client_out.wav")
    args = p.parse_args(argv)
    wav = listen_to_f5tts(args.text, args.host, args.port)
    try:
        import pyaudio

        pa = pyaudio.PyAudio()
        stream = pa.open(format=pyaudio.paFloat32, channels=1, rate=24_000, output=True)
        stream.write(wav.tobytes())
        stream.stop_stream()
        stream.close()
        pa.terminate()
    except ImportError:
        from f5_tts_tpu_torch.audio.io import save_wav

        save_wav(args.output, wav, 24_000)
        print(f"saved {args.output} ({len(wav) / 24000:.2f}s)")


if __name__ == "__main__":
    main()
