"""Alias of the reference socket server."""

from f5_tts_tpu_torch.infer.socket_server import (  # noqa: F401
    TTSStreamingProcessor,
    main,
    start_server,
)

if __name__ == "__main__":
    main()
