"""Eq. (2) region scoring: the wrapper around ``csrc/region_score.cu``.

K(x^r) = sum_i sum_j cos(V_i(x^r), E_j(T)), one block per (region, batch
row).  Rows normalise as the plain version does, ``x / (||x|| + 1e-6)``, in
float32 (the Pallas kernel's ``x·rsqrt(||x||² + 1e-12)`` differs by ~1e-6
relative on unit-scale rows).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import DTYPES, CudaKernel, check_operands

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
KERNEL = CudaKernel("region_score.cu", "region_score_fwd",
                    [_P] * 3 + [_I] * 5 + [_L] * 5 + [_I, _P])
MAX_DIM = 28 * 1024   # two f32 rows of D must fit one block's shared memory


def region_score_cuda(v: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """v: (B, R, Nv, D); e: (B, Ne, D) → (B, R) float32, on the card."""
    check_operands(v, e)
    if v.dim() != 4 or e.dim() != 3:
        raise ValueError(f"bad shapes v{tuple(v.shape)} e{tuple(e.shape)}")
    b, r, nv, d = v.shape
    if e.shape[0] != b or e.shape[2] != d:
        raise ValueError("e must be (B, Ne, D) matching v")
    if min(b, r, nv, e.shape[1], d) < 1 or d > MAX_DIM or b > 65535:
        raise ValueError(f"unsupported shapes v{tuple(v.shape)} "
                         f"e{tuple(e.shape)}")
    out = torch.empty((b, r), dtype=torch.float32, device=v.device)
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream().cuda_stream
        KERNEL(v.data_ptr(), e.data_ptr(), out.data_ptr(),
               b, r, nv, e.shape[1], d,
               *v.stride()[:3], *e.stride()[:2], DTYPES[v.dtype], stream)
    return out
