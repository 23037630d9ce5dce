"""Build the CUDA sources in ``csrc/`` with nvcc and load them with ctypes.

Each source compiles on first use into a shared library with a plain C
interface (no PyTorch headers, so nvcc takes seconds), under
``kernels/.build/``, which git ignores.  The file name carries a hash of the
source and the nvcc flags, so an edited source builds anew and an unchanged
one is loaded as it is.  ``build_all`` starts one nvcc per source, all at
once; ``CudaKernel`` loads its library on its first launch.

Every C entry point launches on the stream it is given, allocates nothing,
and returns ``cudaGetLastError()``; a non-zero return raises here.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from collections import Counter
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / ".build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc failed, or no nvcc was found."""


class KernelLaunchError(RuntimeError):
    """A C entry point returned a CUDA error code."""


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cands = [shutil.which("nvcc")]
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise KernelBuildError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")


def _lib_path(source: str) -> Path:
    src = (CSRC / source).read_bytes()
    digest = hashlib.sha256(src + repr(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}-{digest}.so"


def _start(source: str) -> tuple[Path, subprocess.Popen | None, Path]:
    out = _lib_path(source)
    if out.exists():
        return out, None, out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, proc, tmp


def _finish(source: str, out: Path, proc: subprocess.Popen | None,
            tmp: Path) -> Path:
    if proc is not None:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise KernelBuildError(f"nvcc failed on {source}:\n{log}")
        os.replace(tmp, out)   # atomic: a concurrent builder sees all or none
    return out


def build_all(sources: tuple[str, ...] | None = None) -> dict[str, Path]:
    """Compile every source (default: all of ``csrc/*.cu``) that has no
    library yet, one nvcc each, all started together; returns the paths."""
    if sources is None:
        sources = tuple(sorted(p.name for p in CSRC.glob("*.cu")))
    started = [(s, *_start(s)) for s in sources]
    return {s: _finish(s, out, proc, tmp) for s, out, proc, tmp in started}


def load(source: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if need be."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build_all((source,))[source]))
            _libs[source] = lib
        return lib


class CudaKernel:
    """One C entry point of one source, with a count of its launches.

    ``argtypes`` lists the ctypes types of the arguments before the stream,
    which ``launch`` appends: PyTorch's current stream on the tensors'
    device.  ``launches`` rises by one for every call that launched (a plain
    int that callers may reset), and ``paths`` counts those calls by the
    path the caller names, where it names one.
    """

    def __init__(self, name: str, source: str, symbol: str, argtypes):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes) + [ctypes.c_void_p]
        self.launches = 0
        self.paths: Counter[str] = Counter()
        self._fn = None

    def _entry(self):
        if self._fn is None:
            fn = getattr(load(self.source), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def reset_counts(self) -> None:
        self.launches = 0
        self.paths.clear()

    def launch(self, device, *args, path: str | None = None) -> None:
        import torch
        fn = self._entry()
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise KernelLaunchError(
                f"{self.name} ({self.source}:{self.symbol}) returned CUDA "
                f"error {err}")
        self.launches += 1
        if path is not None:
            self.paths[path] += 1
