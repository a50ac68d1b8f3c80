"""Chunked gated linear-attention scan: the wrapper around ``csrc/ssm_scan.cu``.

S_t = exp(g_t)·S_{t-1} + k_t v_tᵀ, o_t = S_tᵀ q_t, in chunks of ``chunk``
tokens from an initial (dk, dv) f32 state; the exponent is masked before
``exp`` (as ``ref.ssm_scan``).  Layout (B, H, S, d) as the Pallas kernel's,
any strides with a unit innermost one, so ``ops`` hands the model's
(B, S, H, d) tensors over as transposed views without a copy.  The kernel
tiles dv by 32 columns and masks the ragged last tile (xLSTM's dv = dk + 1
= 385) element by element: no padding copy.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import DTYPES, CudaKernel, check_operands
from repro_torch.kernels.ref import chunk_for

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
KERNEL = CudaKernel("ssm_scan.cu", "ssm_scan_fwd",
                    [_P] * 7 + [_I] * 6 + [_L] * 15 + [_I, _P])
MAX_CHUNK = 64
MAX_DK = 1024      # the (dk, 32) f32 state slice must fit shared memory


def ssm_scan_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  log_g: torch.Tensor, state: torch.Tensor, *,
                  chunk: int = 64):
    """q, k: (B, H, S, dk); v: (B, H, S, dv), one dtype; log_g: (B, H, S);
    state: (B, H, dk, dv) → (o (B, H, S, dv) in q's dtype, final state
    (B, H, dk, dv) f32), on the card.  ``o`` is a (B, H, S, dv) view of a
    (B, S, H, dv) buffer."""
    check_operands(q, k, v)
    if q.dim() != 4 or k.shape != q.shape or v.dim() != 4 \
            or v.shape[:3] != q.shape[:3]:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    b, h, s, dk = q.shape
    dv = v.shape[-1]
    if tuple(log_g.shape) != (b, h, s) or tuple(state.shape) != (b, h, dk,
                                                                 dv):
        raise ValueError(f"bad shapes log_g{tuple(log_g.shape)} "
                         f"state{tuple(state.shape)}")
    if log_g.device != q.device or state.device != q.device:
        raise ValueError("log_g and state must lie on q's device")
    chunk = chunk_for(s, chunk)
    if chunk > MAX_CHUNK or dk > MAX_DK or b > 65535 or h > 65535:
        raise ValueError(f"unsupported scan: chunk {chunk} (<= {MAX_CHUNK}),"
                         f" dk {dk} (<= {MAX_DK})")
    g = log_g.float()
    s0 = state.float().contiguous()
    o = torch.empty((b, s, h, dv), dtype=q.dtype,
                    device=q.device).transpose(1, 2)
    sf = torch.empty((b, h, dk, dv), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        KERNEL(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
               s0.data_ptr(), o.data_ptr(), sf.data_ptr(),
               b, h, s, dk, dv, chunk,
               *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               *g.stride(), *o.stride()[:3], DTYPES[q.dtype], stream)
    return o, sf
