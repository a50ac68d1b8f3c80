"""Flash-attention forward: the wrapper around ``csrc/flash_attention.cu``.

Causal GQA attention with an online softmax, optional sliding window and
logit softcap, KV read at head ``h // group``.  Layout (B, H, S, hd) as the
Pallas kernel's; any strides with a unit innermost one, so ``ops`` hands
the model's (B, S, H, hd) tensors over as transposed views without a copy.
Sq need not be a multiple of any tile: the kernel masks its ragged edge.
The kernel does no head-dim padding in memory: it takes hd <= 128 with
hd % 4 == 0 and zero-fills its shared-memory tiles up to 32, 64 or 128.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.build import DTYPES, CudaKernel, check_operands

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
KERNEL = CudaKernel("flash_attention.cu", "flash_attention_fwd",
                    [_P] * 4 + [_I] * 6 + [_L] * 12
                    + [_I, _I, _F, _F, _I, _P])


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         softcap: Optional[float] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, H, Sq, hd); k, v: (B, KH, Skv, hd) → (B, H, Sq, hd), on the
    card.  The result is a (B, H, Sq, hd) view of a (B, Sq, H, hd) buffer."""
    check_operands(q, k, v)
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    b, h, sq, hd = q.shape
    kh, skv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != hd or kh < 1 or h % kh:
        raise ValueError("k/v must be (B, KH, Skv, hd) with H % KH == 0")
    if hd > 128 or hd % 4:
        raise ValueError(f"head dim {hd} unsupported (hd <= 128, hd % 4 == 0)")
    if not 1 <= sq <= skv:
        raise ValueError(f"kernel takes 1 <= Sq <= Skv, got {sq} > {skv}")
    scale = scale if scale is not None else hd ** -0.5
    o = torch.empty((b, sq, h, hd), dtype=q.dtype,
                    device=q.device).transpose(1, 2)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        KERNEL(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
               b, h, kh, sq, skv, hd,
               *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               *o.stride()[:3],
               int(causal), int(window), float(softcap or 0.0), float(scale),
               DTYPES[q.dtype], stream)
    return o
