"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``.  All
sources build at once (one ``nvcc`` process each, started together) on the
first launch of any kernel, into ``_build/<hash of the sources and flags>/``
inside the package (or the directory ``F5TTS_KERNEL_BUILD_DIR`` names); a
later process with the same sources reuses the libraries.  Nothing is built
when the module is imported.

``KernelLibrary.use_prebuilt`` loads the libraries from another directory
instead, as an AOT bundle carries them (``runtime/aot.py`` ``kernels/``):
it checks that the directory holds a library of every source built from
sources with this package's digest, raises if not, and from then on never
starts ``nvcc``.
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
BUILD_DIR = os.environ.get("F5TTS_KERNEL_BUILD_DIR") or os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas=-v", "-lineinfo")


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc`` where ``CUDA_HOME`` is set (and only there),
    else ``nvcc`` on the ``PATH`` or under ``/usr/local/cuda``."""
    home = os.environ.get("CUDA_HOME")
    cands = ((os.path.join(home, "bin", "nvcc"),) if home else
             (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"))
    for cand in cands:
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
        self.prebuilt: str | None = None  # set by use_prebuilt: load from here, never build
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

    def use_prebuilt(self, root: str) -> str:
        """Load the libraries from ``<root>/<digest>/`` from now on, with no
        ``nvcc``: raises if that directory lacks the library of a source
        (a bundle built from other sources has another digest).  Returns
        the directory."""
        digest = self.digest()
        path = os.path.join(root, digest)
        found = sorted(os.listdir(root)) if os.path.isdir(root) else []
        missing = [s for s in self.sources() if not os.path.isfile(os.path.join(path, _lib_name(s)))]
        if missing:
            raise RuntimeError(f"prebuilt kernels in {root} do not match these sources (digest "
                               f"{digest}; found {found}): no library for {missing}")
        self.prebuilt = path
        return path

    def build(self) -> str:
        """Compile every source that has no library yet; returns the output
        dir (the prebuilt one, untouched, after ``use_prebuilt``)."""
        if self.prebuilt is not None:
            return self.prebuilt
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


def no_meta(who: str, x) -> None:
    """Raise for a plain meta tensor: a kernel's dispatcher op has a CPU
    and a CUDA implementation only.  Its fake implementation serves
    tracing (``torch.export``), whose fake tensors carry their real device;
    a call on the meta device has no implementation, as on any other."""
    if x.device.type == "meta":
        raise ValueError(f"{who}: no implementation for device {x.device}")


def _lib_name(source: str) -> str:
    return "lib" + os.path.splitext(source)[0] + ".so"


LIBRARY = KernelLibrary()
KERNELS: list = []  # every CudaKernel made, in order


def launch_counts() -> list[int]:
    """Every kernel's ``launches``, in ``KERNELS`` order."""
    return [k.launches for k in KERNELS]


def launches_since(before: list[int]) -> dict[str, int]:
    """Each kernel's launches since ``before`` (``launch_counts()``), by its
    C entry point, for the kernels that launched."""
    return {k.name: k.launches - b for k, b in zip(KERNELS, before) if k.launches != b}


def add_launches(counts: list[int]) -> None:
    """Add ``counts`` (in ``KERNELS`` order, as ``launch_counts``) to the
    kernels' ``launches``: the launches of one CUDA graph replay."""
    for k, c in zip(KERNELS, counts):
        k.launches += c


class CudaKernel:
    """One C entry point of a ``csrc/`` library, with its launch counter.

    ``launches`` counts successful launches and nothing else; the C function
    returns ``cudaGetLastError()`` after its launch, and a non-zero code
    raises here.  A CUDA graph replays launches without calling ``launch``:
    whoever replays one adds its launches back (``add_launches``).
    """

    def __init__(self, name: str, source: str, argtypes: list):
        self.name = name  # the C entry point's symbol
        self.source = source
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None
        KERNELS.append(self)

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
