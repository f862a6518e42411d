"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled on first use
with ``nvcc`` for ``sm_90a`` into a shared library under ``build/kernels/`` at
the repository root (listed in ``.gitignore``) and loaded with ``ctypes``. The
library's file name carries a hash of its source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source is rebuilt. ``build_all``
starts one ``nvcc`` per source at once.

No ``--use_fast_math``: the kernels rely on IEEE division and square root, and
``--fmad=false`` keeps the compiler from contracting a multiply and an add
into one FMA, so sums round where the plain PyTorch versions round.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("fps", "sa_prep", "sa_prep_bwd", "sa_pair_pool", "sa_pair_pool_bwd", "sa_mask")
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library exists; returns (proc, target)."""
    target = _target(name)
    if target.exists():
        return None, target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return (proc, tmp), target


def _finish(name: str, started, target: Path) -> str:
    if started is None:
        return ""
    proc, tmp = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, target)
    return log


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every listed kernel source in parallel; returns nvcc's logs."""
    names = list(names)
    with _lock:
        started = {n: _start(n) for n in names}
        return {n: _finish(n, *started[n]) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            started, target = _start(name)
            _finish(name, started, target)
            lib = _libs[name] = ctypes.CDLL(str(target))
        return lib


def c_function(source: str, symbol: str, argtypes, restype=ctypes.c_int):
    """A helper function of a kernel library with its C signature declared."""
    fn = getattr(load(source), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = restype
    return fn


def ptr(t) -> ctypes.c_void_p:
    """A tensor's device address as a ctypes pointer (None -> NULL)."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


class Kernel:
    """One launch function of a kernel library, with its launch count.

    ``launches`` counts the launches this process made through ``__call__``;
    a run sets it to 0 before the work it wants to account for.
    """

    def __init__(self, source: str, symbol: str, argtypes, replaces: str):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes) + [ctypes.c_void_p]  # + the stream
        self.replaces = replaces
        self.launches = 0
        self._fn = None

    def __call__(self, *args) -> None:
        import torch

        if self._fn is None:
            fn = getattr(load(self.source), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        status = self._fn(*args, stream)
        if status != 0:
            raise RuntimeError(
                f"CUDA kernel {self.symbol} failed to launch: cudaError_t {status}"
            )
        self.launches += 1


KERNELS: Dict[str, Kernel] = {}


def register(kernel: Kernel) -> Kernel:
    KERNELS[kernel.symbol] = kernel
    return kernel


def require_cuda(*tensors) -> None:
    """Raise unless every tensor lies on a CUDA device and is contiguous."""
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"expected a CUDA tensor, got one on {t.device}")
        if not t.is_contiguous():
            raise ValueError("expected a contiguous tensor")
