"""Build the port's CUDA kernels with ``nvcc`` and bind them with ``ctypes``.

Each kernel package keeps its sources under ``csrc/``. At first use the
source is compiled for Hopper (``sm_90a``) into a shared library with a
plain C interface, under ``build/kernels/`` at the root of the checkout
(listed in ``.gitignore``), named by a hash of the source and flags so an
edited source never loads a stale library. Nothing is compiled or loaded
when a module is imported: the CPU tests import every module on a host
that has no ``nvcc``.

Each C entry point launches on the stream it is given, allocates nothing,
and returns ``cudaGetLastError()``; :meth:`CudaLibrary.launch` passes the
current stream of the tensors' device, raises if the result is not 0 and
counts the launch. Its host cost matters for the small launches (the
classifier head's matmul takes microseconds on the card), so it reads the
raw stream handle and switches device only when the tensors are not on the
current one.
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

from repro_torch.dist.sharding import is_dtensor

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
        self._fns: dict[str, Any] = {}
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
                fns = {}
                for sym, argtypes in self.signatures.items():
                    fn = getattr(lib, sym)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                    fns[sym] = fn
                self._lib = lib
                self._fns = fns  # whole, so launch never sees it half made
            return self._lib

    def launch(self, sym: str, *args: Any, device: torch.device) -> None:
        """Call entry point ``sym`` on the current stream of ``device`` (a
        CUDA device), made the current device for the call; raise on a
        non-zero ``cudaGetLastError()``."""
        if not self._fns:
            self.load()
        fn = self._fns[sym]
        cur = torch._C._cuda_getDevice()
        idx = cur if device.index is None else device.index
        if idx == cur:
            err = fn(*args, torch._C._cuda_getCurrentRawStream(idx))
        else:
            with torch.cuda.device(idx):
                err = fn(*args, torch._C._cuda_getCurrentRawStream(idx))
        if err != 0:
            raise RuntimeError(
                f"{self.name}.{sym} launch failed: CUDA error {err}")
        self.launches[sym] += 1


def refuse_grad(what: str, *tensors: "torch.Tensor | None") -> None:
    """Raise ``NotImplementedError`` where autograd would need a gradient
    through a kernel: grad mode is on and an input requires grad. A kernel
    writes into fresh buffers through ``ctypes``, so its outputs carry no
    ``grad_fn`` and a backward through them would run and return wrong
    gradients with no error. ``ssd_full`` differentiates its kernels through
    an ``autograd.Function``; the other kernels have no backward (nor do
    the reference's Pallas kernels)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{what} has no backward: run it under torch.no_grad(), or take "
            f"the plain version for a gradient")


def refuse_dtensor(what: str, *tensors: "torch.Tensor | None") -> None:
    """Raise ``TypeError`` for a ``DTensor`` argument: a kernel reads raw
    device pointers through ``ctypes``, and a ``DTensor`` is a wrapper
    whose pointer is not its shard's, so a sharded tree that reached a
    launch would give a wrong result with no error."""
    if any(is_dtensor(t) for t in tensors):
        raise TypeError(
            f"{what} takes plain tensors, not DTensors: pass each rank's "
            f"shard (DTensor.to_local()) or the gathered tensor")


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
L = ctypes.c_longlong
