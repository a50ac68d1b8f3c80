"""Build and bind the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file compiles on its own with ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, loaded with ``ctypes``
(no PyTorch headers, so a build takes seconds, not minutes).  Libraries land
in ``build/kernels/`` at the root of the checkout (listed in ``.gitignore``),
named by a hash of the sources and flags: a library is rebuilt only when a
source changes.  ``build_all`` starts one ``nvcc`` per source, all at once.

Nothing builds at import: the CPU tests import every module of the port, on
machines without ``nvcc``.  A kernel's library is built (or found) at its
first launch, or ahead of time by ``build_all``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time
from typing import Dict, List, Sequence

import torch

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cands = [shutil.which("nvcc")]
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit")


def _lib_path(source: str) -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / source]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"{pathlib.Path(source).stem}-{h.hexdigest()[:16]}.so"


def _start(source: str):
    """Start ``nvcc`` for one source unless its library exists; returns
    (final path, tmp path, process or None)."""
    out = _lib_path(source)
    if out.exists():
        return out, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def build_all(sources: Sequence[str]) -> Dict[str, dict]:
    """Build every source in parallel (one ``nvcc`` each); returns per
    source ``{"path", "seconds", "log"}``.  Raises if any build fails."""
    t0 = time.perf_counter()
    started = [(s, *_start(s)) for s in sources]
    report, errors = {}, []
    for source, out, tmp, proc in started:
        log = ""
        if proc is not None:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                os.unlink(tmp)
                errors.append(f"{source}:\n{log}")
                continue
            os.replace(tmp, out)
        report[source] = {"path": str(out), "log": log,
                          "seconds": time.perf_counter() - t0}
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return report


def load(source: str) -> ctypes.CDLL:
    lib = _LIBS.get(source)
    if lib is None:
        path = pathlib.Path(build_all([source])[source]["path"])
        lib = _LIBS[source] = ctypes.CDLL(str(path))
    return lib


class CudaKernel:
    """One C entry point of one ``.cu`` source, with its launch count.

    ``launches`` grows by one each time the wrapper launches the kernel
    (and nowhere else), so a run can show which kernels its path went
    through."""

    def __init__(self, source: str, symbol: str, argtypes: List):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def bind(self) -> None:
        """Build (or find) the library and bind the entry point, ahead of
        the first launch if called early."""
        if self._fn is None:
            fn = getattr(load(self.source), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn

    def __call__(self, *args) -> None:
        self.bind()
        err = self._fn(*args)
        if err != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {err} at launch")
        self.launches += 1


DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def check_operands(*ts: torch.Tensor) -> None:
    """The operand rules every kernel wrapper shares: CUDA tensors on one
    device, one supported dtype, unit innermost stride."""
    dev, dt = ts[0].device, ts[0].dtype
    if dev.type != "cuda":
        raise ValueError(f"kernel operands must be CUDA tensors, got {dev}")
    if dt not in DTYPES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {dt}")
    for t in ts:
        if t.device != dev or t.dtype != dt:
            raise ValueError("kernel operands must share device and dtype")
        if t.stride(-1) != 1:
            raise ValueError("kernel operands need a unit innermost stride")


def check_16_bytes(rule: str, **ts: torch.Tensor) -> None:
    """16-byte aligned base addresses and strides (a size-1 dimension's
    stride is never used), as ``rule`` (TMA, cp.async) needs.  Raises."""
    for name, t in ts.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {rule} needs a 16-byte aligned base "
                             f"address, got {t.data_ptr():#x}")
        size, stride, e = t.shape, t.stride(), t.element_size()
        for i in range(len(stride) - 1):
            if (stride[i] * e) % 16 and size[i] > 1:
                raise ValueError(f"{name}: {rule} needs 16-byte aligned "
                                 f"strides, got {stride}")
