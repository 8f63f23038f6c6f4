"""Where the port's entry points run: the card unless the caller names the CPU."""

from __future__ import annotations

import torch


def resolve_device(device: str | None, who: str = "F5TTS") -> torch.device:
    """``None`` means the card; the CPU only when asked for by name."""
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who} runs on a CUDA device and none is available; "
                           "pass device='cpu' to run on the CPU")
    return dev
