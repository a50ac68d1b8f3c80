"""Eq. (2) region scoring: the wrapper around ``csrc/region_score.cu``.

K(x^r) = sum_i sum_j cos(V_i(x^r), E_j(T)), one warp per (batch row,
region), computed as sum_i (v_i · ē) / (||v_i|| + 1e-6) with ē = sum_j e_j /
(||e_j|| + 1e-6) once per block: rows normalise as the plain version does,
``x / (||x|| + 1e-6)``, in float32 (the Pallas kernel's ``x·rsqrt(||x||² +
1e-12)`` differs by ~1e-6 relative on unit-scale rows).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import DTYPES, CudaKernel, check_operands

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
KERNEL = CudaKernel("region_score.cu", "region_score_fwd",
                    [_P] * 3 + [_I] * 5 + [_L] * 5 + [_I, _P])
# ē (D floats) and the Ne norms of E's rows share one block's 227 KB
MAX_SMEM_FLOATS = 227 * 1024 // 4


def region_score_cuda(v: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """v: (B, R, Nv, D); e: (B, Ne, D) → (B, R) float32, on the card."""
    check_operands(v, e)
    if v.dim() != 4 or e.dim() != 3:
        raise ValueError(f"bad shapes v{tuple(v.shape)} e{tuple(e.shape)}")
    b, r, nv, d = v.shape
    ne = e.shape[1]
    if e.shape[0] != b or e.shape[2] != d:
        raise ValueError("e must be (B, Ne, D) matching v")
    if min(b, r, nv, ne, d) < 1:
        raise ValueError(f"empty shapes v{tuple(v.shape)} e{tuple(e.shape)}")
    if d + ne > MAX_SMEM_FLOATS:
        raise ValueError(f"D + Ne = {d + ne} must fit one block's shared "
                         f"memory: at most {MAX_SMEM_FLOATS} floats")
    # a size-1 dimension's stride is never used: 0 keeps it out of the
    # kernel's 16-byte alignment rule
    sv = [s if n > 1 else 0 for n, s in zip(v.shape[:3], v.stride()[:3])]
    se = [s if n > 1 else 0 for n, s in zip(e.shape[:2], e.stride()[:2])]
    out = torch.empty((b, r), dtype=torch.float32, device=v.device)
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream().cuda_stream
        KERNEL(v.data_ptr(), e.data_ptr(), out.data_ptr(),
               b, r, nv, ne, d, *sv, *se, DTYPES[v.dtype], stream)
    return out
