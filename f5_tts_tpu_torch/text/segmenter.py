"""Native (C++) word segmenter bindings — the rjieba replacement.

Loads native/segmenter.cpp via ctypes (built on demand with g++, cached under
~/.cache/f5_tts_tpu_torch).  Dictionary: jieba's dict.txt from the installed jieba
package, or $F5_TTS_TPU_JIEBA_DICT.  Falls back to python jieba (HMM=False, the
rjieba-equivalent mode) when the native build or dict is unavailable.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import warnings

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                    "native", "segmenter.cpp")
_CACHE_DIR = os.path.join(os.path.expanduser("~"), ".cache", "f5_tts_tpu_torch")

_lib = None
_handle = None
_failed = False


def _find_dict() -> str | None:
    path = os.environ.get("F5_TTS_TPU_JIEBA_DICT")
    if path and os.path.isfile(path):
        return path
    try:
        import jieba

        cand = os.path.join(os.path.dirname(jieba.__file__), "dict.txt")
        if os.path.isfile(cand):
            return cand
    except ImportError:
        pass
    return None


def _build_lib() -> str | None:
    so_path = os.path.join(_CACHE_DIR, "libsegmenter.so")
    if os.path.isfile(so_path) and os.path.getmtime(so_path) >= os.path.getmtime(_SRC):
        return so_path
    os.makedirs(_CACHE_DIR, exist_ok=True)
    try:
        subprocess.run(
            ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", _SRC, "-o", so_path],
            check=True, capture_output=True,
        )
        return so_path
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        warnings.warn(f"native segmenter build failed ({e}); falling back to python jieba")
        return None


def _ensure() -> bool:
    global _lib, _handle, _failed
    if _handle is not None:
        return True
    if _failed:
        return False
    dict_path = _find_dict()
    if dict_path is None or not os.path.isfile(_SRC):
        _failed = True
        return False
    so = _build_lib()
    if so is None:
        _failed = True
        return False
    lib = ctypes.CDLL(so)
    lib.seg_create.restype = ctypes.c_void_p
    lib.seg_create.argtypes = [ctypes.c_char_p]
    lib.seg_cut.restype = ctypes.c_void_p  # manual free; keep as raw pointer
    lib.seg_cut.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.seg_free_result.argtypes = [ctypes.c_void_p]
    lib.seg_destroy.argtypes = [ctypes.c_void_p]
    handle = lib.seg_create(dict_path.encode())
    if not handle:
        _failed = True
        return False
    _lib, _handle = lib, handle
    return True


def native_available() -> bool:
    return _ensure()


def cut(text: str) -> list[str]:
    """Segment ``text``; identical token stream to jieba.cut(HMM=False)."""
    if _ensure():
        ptr = _lib.seg_cut(_handle, text.encode("utf-8"))
        try:
            raw = ctypes.string_at(ptr)
        finally:
            _lib.seg_free_result(ptr)
        if not raw:
            return []
        return raw.decode("utf-8").split("\x1e")
    try:
        import jieba

        return list(jieba.cut(text, HMM=False))
    except ImportError:
        return [text]
