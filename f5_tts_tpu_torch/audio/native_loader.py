"""ctypes bindings for the native C++ audio loader (native/audioio.cpp +
native/mp3dec.cpp + native/flacdec.cpp).

Batch wav/mp3/flac decode + resample off the GIL; CustomDataset and the prep
scripts use it when available, falling back to the scipy path transparently
(the fallback is WAV-only — mp3/flac require the native build).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import warnings

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                           "native")
_SRCS = [os.path.join(_NATIVE_DIR, name)
         for name in ("audioio.cpp", "mp3dec.cpp", "flacdec.cpp")]
_DEPS = _SRCS + [os.path.join(_NATIVE_DIR, name)
                 for name in ("decoders.h", "mp3_tables.inc")]
_CACHE_DIR = os.path.join(os.path.expanduser("~"), ".cache", "f5_tts_tpu_torch")

_lib = None
_failed = False


def _ensure() -> bool:
    global _lib, _failed
    if _lib is not None:
        return True
    if _failed or not all(os.path.isfile(p) for p in _DEPS):
        return False
    so_path = os.path.join(_CACHE_DIR, "libaudioio.so")
    src_mtime = max(os.path.getmtime(p) for p in _DEPS)
    if not (os.path.isfile(so_path) and os.path.getmtime(so_path) >= src_mtime):
        os.makedirs(_CACHE_DIR, exist_ok=True)
        try:
            subprocess.run(
                ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
                 *_SRCS, "-o", so_path],
                check=True, capture_output=True,
            )
        except (subprocess.CalledProcessError, FileNotFoundError) as e:
            warnings.warn(f"native audioio build failed ({e}); using scipy loader")
            _failed = True
            return False
    lib = ctypes.CDLL(so_path)
    lib.wav_read_mono.restype = ctypes.c_long
    lib.wav_read_mono.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                                  ctypes.c_long, ctypes.POINTER(ctypes.c_int)]
    lib.resample_poly_c.restype = ctypes.c_long
    lib.resample_poly_c.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_long,
                                    ctypes.c_int, ctypes.c_int,
                                    ctypes.POINTER(ctypes.c_float), ctypes.c_long]
    lib.load_batch_mono.restype = ctypes.c_int
    lib.load_batch_mono.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                                    ctypes.c_int, ctypes.POINTER(ctypes.c_float),
                                    ctypes.c_long, ctypes.POINTER(ctypes.c_long), ctypes.c_int]
    _lib = lib
    return True


def native_available() -> bool:
    return _ensure()


def load_wav_mono(path: str) -> tuple[np.ndarray, int] | None:
    """Native single-file load (wav/mp3/flac by content sniffing); None if
    the native library is unavailable or the file can't be decoded (caller
    falls back)."""
    if not _ensure():
        return None
    sr = ctypes.c_int(0)
    n = _lib.wav_read_mono(path.encode(), None, 0, ctypes.byref(sr))
    if n < 0:
        return None
    buf = np.empty(n, np.float32)
    got = _lib.wav_read_mono(path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                             n, ctypes.byref(sr))
    if got < 0:
        return None
    return buf[:got], int(sr.value)


def load_batch(paths: list[str], target_sr: int, max_seconds: float = 35.0,
               n_threads: int = 8) -> tuple[np.ndarray, np.ndarray]:
    """Threaded batch decode+resample.  Returns (wavs [n, stride], lens [n];
    lens[i] == -1 marks an unreadable file)."""
    if not _ensure():
        raise RuntimeError("native audio loader unavailable")
    n = len(paths)
    stride = int(max_seconds * target_sr)
    out = np.zeros((n, stride), np.float32)
    lens = np.zeros(n, np.int64)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    _lib.load_batch_mono(arr, n, target_sr,
                         out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                         stride, lens.ctypes.data_as(ctypes.POINTER(ctypes.c_long)), n_threads)
    return out, lens
