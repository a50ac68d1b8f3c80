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
from typing import Dict, List, Optional, Sequence

import torch

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
# -split-compile=0: each nvcc optimises its kernels on every core (the
# hd-256 instances made decode_attention.cu the build's critical path:
# 112.5 s alone, 55.5 s split, on the H100 machine's 8 cores)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-split-compile=0")

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
    through.  The paged kernels also count their launches by the pool's
    storage (``by_pool``: "fp", "int8" or "fp8")."""

    def __init__(self, source: str, symbol: str, argtypes: List):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self.by_pool: Dict[str, int] = {}
        self._fn = None

    def bind(self) -> None:
        """Build (or find) the library and bind the entry point, ahead of
        the first launch if called early."""
        if self._fn is None:
            fn = getattr(load(self.source), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn

    def __call__(self, *args, pool: Optional[str] = None) -> None:
        self.bind()
        err = self._fn(*args)
        if err != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {err} at launch")
        self.launches += 1
        if pool is not None:
            self.by_pool[pool] = self.by_pool.get(pool, 0) + 1

    def reset(self) -> None:
        self.launches = 0
        self.by_pool = {}


DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the 8-bit page pools the paged kernels read with their scales: the C
#: code of each element type (an fp pool passes its q's ``DTYPES`` code)
#: and its ``kv_dtype`` name
POOL_DTYPES = {torch.int8: 2, torch.float8_e4m3fn: 3}
POOL_NAMES = {torch.int8: "int8", torch.float8_e4m3fn: "fp8"}


#: the largest head dim the attention kernels take (their CUDA-core
#: routes; the tensor-core routes take 64 and 128, dense decode's and
#: prefix-append's also 256).  The JAX kernels take any; no config of
#: either package goes past 256 (gemma3-1b's).
MAX_HEAD_DIM = 256


def check_head_dim(hd: int) -> None:
    """The head dims every attention kernel's wrapper takes: hd <=
    ``MAX_HEAD_DIM`` with hd % 4 == 0 (16-byte rows of f32 or bf16 for the
    vectorised loads, a multiple of 4 for the float4 dot products).
    Raises."""
    if not 0 < hd <= MAX_HEAD_DIM or hd % 4:
        raise ValueError(f"head dim {hd} unsupported (hd <= {MAX_HEAD_DIM}, "
                         f"hd % 4 == 0)")


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


def check_pools(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                k_scale: Optional[torch.Tensor],
                v_scale: Optional[torch.Tensor]) -> int:
    """The pool rules of the paged kernels: fp pools of q's dtype and no
    scales, or int8/float8_e4m3fn pools under an f32 or bf16 q with both
    scales, f32 and shaped as the pools less their head dim, on the
    operands' device (any strides).  Returns the pool's C code (q's
    ``DTYPES`` code for an fp pool, else ``POOL_DTYPES``'s).  Raises."""
    if k_pool.dtype not in POOL_DTYPES:
        check_operands(q, k_pool, v_pool)
        if k_scale is not None or v_scale is not None:
            raise ValueError("an fp pool takes no scales")
        return DTYPES[q.dtype]
    check_operands(q)
    if v_pool.dtype != k_pool.dtype:
        raise ValueError("k and v pools must share their dtype")
    for t in (k_pool, v_pool):
        if t.device != q.device or t.stride(-1) != 1:
            raise ValueError("pools must lie on q's device with a unit "
                             "innermost stride")
    if k_scale is None or v_scale is None:
        raise ValueError(f"a {k_pool.dtype} pool needs k_scale and v_scale")
    for t, pool in ((k_scale, k_pool), (v_scale, v_pool)):
        if (t.dtype != torch.float32 or t.device != q.device
                or t.shape != pool.shape[:-1]):
            raise ValueError(f"scales must be float32 {tuple(pool.shape[:-1])}"
                             f" on q's device, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    return POOL_DTYPES[k_pool.dtype]


def pool_name(pool: torch.Tensor) -> str:
    """The storage a paged launch is counted under: "fp", "int8", "fp8"."""
    return POOL_NAMES.get(pool.dtype, "fp")


def scale_args(k_scale: Optional[torch.Tensor],
               v_scale: Optional[torch.Tensor]) -> list:
    """The scale operands of a paged entry point: the two pointers, then
    k_scale's and v_scale's three strides (page, head, slot); zeros for an
    fp pool."""
    if k_scale is None:
        return [0, 0] + [0] * 6
    return [k_scale.data_ptr(), v_scale.data_ptr(), *k_scale.stride(),
            *v_scale.stride()]
