"""Build the port's CUDA kernels with ``nvcc`` and bind them with ``ctypes``.

Each kernel package keeps its sources under ``csrc/``. At first use the
source is compiled for Hopper (``sm_90a``) into a shared library with a
plain C interface, under ``build/kernels/`` at the root of the checkout
(listed in ``.gitignore``), named by a hash of the source and flags so an
edited source never loads a stale library. Nothing is compiled or loaded
when a module is imported: the CPU tests import every module on a host
that has no ``nvcc``.

Each C entry point launches on the stream it is given, allocates nothing,
and returns ``cudaGetLastError()``; :meth:`CudaLibrary.launch` raises if
that is not 0 and counts the launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Any

import torch

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin): the port's CUDA kernels "
            "are built at first use on a machine with the CUDA toolkit")
    return str(path)


class CudaLibrary:
    """One ``csrc/*.cu`` source, its built library, and per-entry-point
    launch counts (plain integers: a run reads them to show which kernels
    its path went through)."""

    def __init__(self, name: str, source: Path,
                 signatures: dict[str, list[Any]]):
        self.name = name
        self.source = Path(source)
        self.signatures = signatures
        self.launches: dict[str, int] = {sym: 0 for sym in signatures}
        self.ptxas_log = ""
        self._lib: ctypes.CDLL | None = None
        self._lock = threading.Lock()

    def target(self) -> Path:
        digest = hashlib.sha256(
            self.source.read_bytes() + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        return BUILD_DIR / f"lib{self.name}-{digest}.so"

    def start_build(self) -> "subprocess.Popen | None":
        """Start ``nvcc`` for this source unless its library exists;
        returns the running process (``finish_build`` waits on it)."""
        out = self.target()
        if out.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        return subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def finish_build(self, proc: "subprocess.Popen | None") -> None:
        if proc is None:
            return
        log, _ = proc.communicate()
        self.ptxas_log = log
        tmp = Path(proc.args[proc.args.index("-o") + 1])
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.source}:\n{log}")
        os.replace(tmp, self.target())

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                self.finish_build(self.start_build())
                lib = ctypes.CDLL(str(self.target()))
                for sym, argtypes in self.signatures.items():
                    fn = getattr(lib, sym)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                self._lib = lib
            return self._lib

    def launch(self, sym: str, *args: Any) -> None:
        """Call entry point ``sym`` on the current stream of the current
        device; raise on a non-zero ``cudaGetLastError()``."""
        fn = getattr(self.load(), sym)
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*args, stream)
        if err != 0:
            raise RuntimeError(
                f"{self.name}.{sym} launch failed: CUDA error {err}")
        self.launches[sym] += 1


def build_all(libraries: list[CudaLibrary]) -> None:
    """Build every library at once: one ``nvcc`` per source, all started
    together, then load each."""
    procs = [lib.start_build() for lib in libraries]
    for lib, proc in zip(libraries, procs):
        lib.finish_build(proc)
    for lib in libraries:
        lib.load()


P = ctypes.c_void_p
I = ctypes.c_int
