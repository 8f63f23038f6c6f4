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


def card_name_and_power_limit() -> str:
    """The card as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` prints it: the label every time the drivers
    print carries (a card below its 700 W limit runs slower under load)."""
    import subprocess

    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def device_ms(fn, iters: int, reps: int = 5) -> float:
    """Device time per call of ``fn`` on the card: ``iters`` calls captured
    in one CUDA graph, replayed ``reps`` times between two events.  A loop
    of eager calls timed by events measures the host's launch rate instead
    wherever a call's kernels take less than its Python wrapper (tens of
    microseconds); the graph replays the launches with no host work between
    them.  ``fn`` must be capturable: no host synchronisation, no allocation
    outside PyTorch's allocator.  The graph is captured on a stream of its
    own, whose kernel workspaces (``ops/workspace.py``) go with it."""
    from f5_tts_tpu_torch.ops.workspace import release

    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up on the capture stream, as torch.cuda.graphs asks
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    release(side)
    return start.elapsed_time(end) / (reps * iters)
