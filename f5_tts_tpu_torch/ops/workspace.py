"""Device workspaces of the hand-written kernels: one set per CUDA stream.

Kernels G and I take scratch memory from their wrappers: G's quantized
rows, row scales and split partial sums, and the int32 words both use to
signal across blocks (the grid barrier's word, G's per-tile arrival
counters), which a launch leaves as it found them.  A workspace is a byte
buffer per (device, stream, name), so launches on two streams never share
one, and launches on one stream use it one after another.

A CUDA graph replays into the buffers it captured.  Inside a capture a
workspace is never allocated (its memory would come from the graph's pool,
its zeroing would be recorded into the graph): launch the kernel once on
the capture stream first.  A buffer a capture has used is never freed
under the graph: a later call that needs a larger one raises, until
``release`` says that nothing captured on that stream replays again.
Inside ``scope(token)`` the buffers belong to the token as well: the
serving engine captures each of its graphs in a scope of its own, so no
two graphs share a buffer (a graph of a small bucket never holds back a
larger one) even where PyTorch's stream pool hands them one stream.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

_MIN_BYTES = 1 << 20
_BUFS: dict = {}  # (device, raw stream, name, scope) -> [uint8 tensor, a graph captured it]
_SCOPE = contextvars.ContextVar("workspace_scope", default=None)


@contextlib.contextmanager
def scope(token):
    """Workspaces asked for inside belong to ``token`` (hashable) too."""
    reset = _SCOPE.set(token)
    try:
        yield
    finally:
        _SCOPE.reset(reset)


def release_scopes(tokens) -> None:
    """Drop the workspaces of ``tokens``: call once no graph captured in
    those scopes replays again."""
    tokens = set(tokens)
    for key in [key for key in _BUFS if key[3] in tokens]:
        del _BUFS[key]


def workspace(device: torch.device, name: str, nbytes: int, zero: bool = False) -> torch.Tensor:
    """At least ``nbytes`` of uint8 on ``device`` for PyTorch's current
    stream there, named ``name``; ``zero``: zeroed when allocated (the
    kernels that take such a buffer leave it zero)."""
    key = (device, torch.cuda.current_stream(device).cuda_stream, name, _SCOPE.get())
    entry = _BUFS.get(key)
    capturing = torch.cuda.is_current_stream_capturing()
    if entry is None or entry[0].numel() < nbytes:
        if capturing:
            raise RuntimeError(f"workspace {name!r} is allocated outside a CUDA graph capture: "
                               "launch the kernel once on the capture stream first")
        if entry is not None and entry[1]:
            raise RuntimeError(f"workspace {name!r} ({entry[0].numel()} bytes) is held by a "
                               f"CUDA graph captured on this stream; a call needing {nbytes} "
                               "bytes would free it under the graph (release the stream once "
                               "its graphs are gone, or make the call on another stream)")
        size = max(nbytes, _MIN_BYTES, 0 if entry is None else 2 * entry[0].numel())
        buf = (torch.zeros if zero else torch.empty)(size, dtype=torch.uint8, device=device)
        entry = _BUFS[key] = [buf, False]
    if capturing:
        entry[1] = True
    return entry[0]


def release(stream: torch.cuda.Stream) -> None:
    """Drop ``stream``'s workspaces (those asked for outside any
    ``scope``): call once no CUDA graph captured on it replays again (launches still pending on it are safe: the allocator
    reuses the memory in the stream's order)."""
    for key in [key for key in _BUFS if key[1] == stream.cuda_stream
                and key[0] == stream.device and key[3] is None]:
        del _BUFS[key]
