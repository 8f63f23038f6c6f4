"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``.  All
sources build at once (one ``nvcc`` process each, started together) on the
first launch of any kernel, into ``_build/<hash of the sources and flags>/``
inside the package; a later process with the same sources reuses the
libraries.  Nothing is built when the module is imported.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas=-v", "-lineinfo")


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels cannot be built")


class KernelLibrary:
    """The compiled ``csrc/`` sources: builds them once, hands out libraries."""

    def __init__(self, csrc_dir: str = CSRC_DIR, build_dir: str = BUILD_DIR):
        self.csrc_dir = csrc_dir
        self.build_dir = build_dir
        self.build_seconds: float | None = None  # wall time of the last build, None if reused
        self.build_log = ""  # nvcc / ptxas output of the last build
        self._libs: dict[str, ctypes.CDLL] = {}
        self._lock = threading.Lock()

    def sources(self) -> list[str]:
        return sorted(f for f in os.listdir(self.csrc_dir) if f.endswith(".cu"))

    def digest(self) -> str:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for name in sorted(os.listdir(self.csrc_dir)):
            if name.endswith((".cu", ".cuh")):
                h.update(name.encode())
                with open(os.path.join(self.csrc_dir, name), "rb") as f:
                    h.update(f.read())
        return h.hexdigest()[:16]

    def _out_dir(self) -> str:
        return os.path.join(self.build_dir, self.digest())

    def build(self) -> str:
        """Compile every source that has no library yet; returns the output dir."""
        out_dir = self._out_dir()
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(self.build_dir, ".lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)  # another process may be building
            todo = [s for s in self.sources()
                    if not os.path.isfile(os.path.join(out_dir, _lib_name(s)))]
            if not todo:
                return out_dir
            nvcc = find_nvcc()
            t0 = time.perf_counter()
            procs = []
            for src in todo:
                tmp = os.path.join(out_dir, f".{_lib_name(src)}.{os.getpid()}")
                cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(self.csrc_dir, src)]
                procs.append((src, tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
            logs, failed = [], []
            for src, tmp, proc in procs:
                out, _ = proc.communicate()
                logs.append(f"== {src}\n{out}")
                if proc.returncode != 0:
                    failed.append(src)
                else:
                    os.replace(tmp, os.path.join(out_dir, _lib_name(src)))
            self.build_log = "\n".join(logs)
            self.build_seconds = time.perf_counter() - t0
            if failed:
                raise RuntimeError(f"nvcc failed for {failed}:\n{self.build_log}")
            return out_dir

    def lib(self, source: str) -> ctypes.CDLL:
        with self._lock:
            if source not in self._libs:
                path = os.path.join(self.build(), _lib_name(source))
                self._libs[source] = ctypes.CDLL(path)
            return self._libs[source]


def _lib_name(source: str) -> str:
    return "lib" + os.path.splitext(source)[0] + ".so"


LIBRARY = KernelLibrary()


class CudaKernel:
    """One C entry point of a ``csrc/`` library, with its launch counter.

    ``launches`` counts successful launches and nothing else; the C function
    returns ``cudaGetLastError()`` after its launch, and a non-zero code
    raises here.
    """

    def __init__(self, name: str, source: str, argtypes: list):
        self.name = name  # the C entry point's symbol
        self.source = source
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def _load(self):
        if self._fn is None:
            lib = LIBRARY.lib(self.source)
            fn = getattr(lib, self.name)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err = lib.cuda_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._err = err
            self._fn = fn
        return self._fn

    def launch(self, *args) -> None:
        code = self._load()(*args)
        if code != 0:
            raise RuntimeError(f"{self.name}: CUDA error {code}: "
                               f"{self._err(code).decode(errors='replace')}")
        self.launches += 1
