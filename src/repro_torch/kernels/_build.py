"""Build the CUDA sources in ``csrc/`` with nvcc and load them with ctypes.

Each source compiles on first use into a shared library with a plain C
interface (no PyTorch headers, so nvcc takes seconds), under
``kernels/.build/``, which git ignores.  The file name carries a hash of the
source and the nvcc flags, so an edited source builds anew and an unchanged
one is loaded as it is.  ``build_all`` starts one nvcc per source, all at
once, and records each one's wall seconds (``BUILD_SECONDS``); nvcc's output,
with ptxas's register and spill report of every kernel instance
(``-Xptxas -v``), is kept beside the library and read by ``ptxas_report``.
``CudaKernel`` loads its library on its first launch.

    python -m repro_torch.kernels._build [CSRC_DIR]

builds every source of ``CSRC_DIR`` (default: this package's ``csrc/``) one
at a time into a fresh temporary directory and prints one JSON line per
source: its build seconds and each instance's registers and spill bytes.

Every C entry point launches on the stream it is given, allocates nothing,
and returns ``cudaGetLastError()``; a non-zero return raises here.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from collections import Counter
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / ".build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# source → wall seconds of its nvcc in the last build_all that compiled it
BUILD_SECONDS: dict[str, float] = {}


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


def _lib_path(source: str, csrc: Path = CSRC,
              build_dir: Path = BUILD_DIR) -> Path:
    src = (csrc / source).read_bytes()
    digest = hashlib.sha256(src + repr(NVCC_FLAGS).encode()).hexdigest()[:16]
    return build_dir / f"{Path(source).stem}-{digest}.so"


class _Build:
    """One nvcc run, its output to a log file (never a pipe: ptxas's report
    can outgrow one), timed by a thread that waits on it."""

    def __init__(self, source: str, csrc: Path, out: Path):
        self.source, self.out = source, out
        self.tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        self.log = self.tmp.with_suffix(".log")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(self.tmp),
               str(csrc / source)]
        t0 = time.perf_counter()
        with open(self.log, "w") as f:
            self.proc = subprocess.Popen(cmd, stdout=f,
                                         stderr=subprocess.STDOUT)
        self.seconds = 0.0

        def wait():
            self.proc.wait()
            self.seconds = time.perf_counter() - t0

        self.waiter = threading.Thread(target=wait, daemon=True)
        self.waiter.start()

    def finish(self) -> float:
        self.waiter.join()
        if self.proc.returncode != 0:
            self.tmp.unlink(missing_ok=True)
            raise KernelBuildError(f"nvcc failed on {self.source}:\n"
                                   f"{self.log.read_text()}")
        # atomic: a concurrent builder sees all or none
        os.replace(self.log, self.out.with_suffix(".log"))
        os.replace(self.tmp, self.out)
        return self.seconds


def build_all(sources: tuple[str, ...] | None = None, *, csrc: Path = CSRC,
              build_dir: Path = BUILD_DIR) -> dict[str, Path]:
    """Compile every source (default: all of ``csrc/*.cu``) that has no
    library yet, one nvcc each, all started together; returns the paths
    and records each compiled source's seconds in ``BUILD_SECONDS``."""
    if sources is None:
        sources = tuple(sorted(p.name for p in csrc.glob("*.cu")))
    build_dir.mkdir(parents=True, exist_ok=True)
    outs = {s: _lib_path(s, csrc, build_dir) for s in sources}
    builds = [_Build(s, csrc, out) for s, out in outs.items()
              if not out.exists()]
    for b in builds:
        BUILD_SECONDS[b.source] = b.finish()
    return outs


_PTXAS_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PTXAS_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")


def _demangle(names: list[str]) -> list[str]:
    tool = shutil.which("c++filt")
    if tool is None or not names:
        return names
    out = subprocess.run([tool], input="\n".join(names), text=True,
                         capture_output=True).stdout.splitlines()
    return out if len(out) == len(names) else names


def ptxas_report(log: Path) -> list[dict]:
    """Each kernel instance in an nvcc log written with ``-Xptxas -v``: its
    (demangled) name, registers, stack frame and spill bytes."""
    rows, cur = [], None
    for line in log.read_text().splitlines():
        m = _PTXAS_ENTRY.search(line)
        if m:
            cur = {"function": m.group(1), "registers": None,
                   "stack": 0, "spill_stores": 0, "spill_loads": 0}
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = _PTXAS_SPILL.search(line)
        if m:
            cur["stack"], cur["spill_stores"], cur["spill_loads"] = map(
                int, m.groups())
        m = _PTXAS_REGS.search(line)
        if m:
            cur["registers"] = int(m.group(1))
    for row, name in zip(rows, _demangle([r["function"] for r in rows])):
        row["function"] = name
    return rows


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


def main(argv: list[str]) -> int:
    csrc = Path(argv[0]).resolve() if argv else CSRC
    sources = sorted(p.name for p in csrc.glob("*.cu"))
    with tempfile.TemporaryDirectory(prefix="kernel-build-") as d:
        for source in sources:
            BUILD_SECONDS.pop(source, None)
            out = build_all((source,), csrc=csrc, build_dir=Path(d))[source]
            rows = ptxas_report(out.with_suffix(".log"))
            print(json.dumps({
                "build": source, "csrc": str(csrc),
                "seconds": BUILD_SECONDS[source], "instances": len(rows),
                "spilling": [r for r in rows
                             if r["spill_stores"] or r["spill_loads"]],
                "registers": {r["function"]: r["registers"] for r in rows}}),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
