"""Flash-attention forward: the wrapper around its two CUDA kernels.

Causal GQA attention with an online softmax, optional sliding window and
logit softcap, KV read at head ``h // group``.  Layout (B, H, S, hd) as the
Pallas kernel's; any strides with a unit innermost one, so ``ops`` hands
the model's (B, S, H, hd) tensors over as transposed views without a copy.
Sq need not be a multiple of any tile: the kernels mask their ragged edge.

Two routes, chosen by ``route`` from the dtype and head dim alone:

* ``"wgmma"``: bfloat16 at hd 64 or 128 (the models' prefill) goes to
  ``csrc/flash_attention_wgmma.cu``, QK^T and PV on the tensor cores with
  K/V tiles loaded by TMA.  TMA needs 16-byte aligned bases and strides;
  operands that break the rule raise here, they never take the other
  route.  p is rounded to bf16 before PV.
* ``"cuda_cores"``: float32 (whose card-vs-CPU decisions must not flip on
  TF32 rounding) and every other head dim (hd <= 256, hd % 4 == 0: the
  proxies' 12 and 16, gemma3-1b's 256) go to ``csrc/flash_attention.cu``,
  f32 math on the CUDA cores.  bf16 at hd 256 takes this route by its
  shape: a launch there is counted as a CUDA-core launch, and a failure
  raises.

The backward (training) is one more kernel,
``csrc/flash_attention_bwd.cu`` (CUDA cores, f32 math, three launches: row
statistics, dK/dV by key tile with the GQA sum as a loop, dQ by query
tile), taken for float32 and bfloat16 at every head dim the forward
takes.  ``FlashAttentionFn`` ties the two together for autograd: its
forward is the dispatch above, its backward this kernel on the card and
``ref.flash_attention_bwd`` on the CPU.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import (DTYPES, CudaKernel, check_16_bytes,
                                      check_head_dim, check_operands)

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
KERNEL = CudaKernel("flash_attention.cu", "flash_attention_fwd",
                    [_P] * 4 + [_I] * 6 + [_L] * 12
                    + [_I, _I, _F, _F, _I, _P])
WGMMA_KERNEL = CudaKernel("flash_attention_wgmma.cu",
                          "flash_attention_wgmma_fwd",
                          [_P] * 4 + [_I] * 6 + [_L] * 12
                          + [_I, _I, _F, _F, _P])
BWD_KERNEL = CudaKernel("flash_attention_bwd.cu", "flash_attention_bwd",
                        [_P] * 10 + [_I] * 6
                        + [ctypes.POINTER(ctypes.c_longlong)]
                        + [_I, _I, _F, _F, _I, _P])
WGMMA_HEAD_DIMS = (64, 128)


def route(dtype: torch.dtype, hd: int) -> str:
    """The kernel a (dtype, head dim) takes: ``"wgmma"`` for bfloat16 at hd
    64 or 128, ``"cuda_cores"`` for float32 and other head dims; any other
    dtype raises."""
    if dtype not in DTYPES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {dtype}")
    if dtype == torch.bfloat16 and hd in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "cuda_cores"


def check_tma(**ts: torch.Tensor) -> None:
    """TMA's rules for the wgmma route: 16-byte aligned base addresses and
    strides (a size-1 dimension's stride is never used).  Raises."""
    check_16_bytes("TMA", **ts)


def _launch_args(q, k, v, causal, window, softcap, scale):
    """Checks what both kernels take; returns the output (a (B, H, Sq, hd)
    view of a (B, Sq, H, hd) buffer) and the entry point's arguments."""
    check_operands(q, k, v)
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    b, h, sq, hd = q.shape
    kh, skv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != hd or kh < 1 or h % kh:
        raise ValueError("k/v must be (B, KH, Skv, hd) with H % KH == 0")
    check_head_dim(hd)
    if not 1 <= sq <= skv:
        raise ValueError(f"kernel takes 1 <= Sq <= Skv, got {sq} > {skv}")
    scale = scale if scale is not None else hd ** -0.5
    o = torch.empty((b, sq, h, hd), dtype=q.dtype,
                    device=q.device).transpose(1, 2)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            b, h, kh, sq, skv, hd,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *o.stride()[:3],
            int(causal), int(window), float(softcap or 0.0), float(scale))
    return o, args


def launch_wgmma(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool = True, window: int = 0,
                 softcap: Optional[float] = None,
                 scale: Optional[float] = None) -> torch.Tensor:
    """The tensor-core kernel: bfloat16 at hd 64 or 128, operands that keep
    TMA's 16-byte rule; raises on anything else."""
    if route(q.dtype, q.shape[-1]) != "wgmma":
        raise ValueError(f"the wgmma kernel takes bfloat16 at hd "
                         f"{WGMMA_HEAD_DIMS}, got {q.dtype} hd {q.shape[-1]}")
    o, args = _launch_args(q, k, v, causal, window, softcap, scale)
    check_tma(q=q, k=k, v=v)
    with torch.cuda.device(q.device):
        WGMMA_KERNEL(*args, torch.cuda.current_stream().cuda_stream)
    return o


def launch_cuda_cores(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0,
                      softcap: Optional[float] = None,
                      scale: Optional[float] = None) -> torch.Tensor:
    """The CUDA-core kernel, on any input it takes (float32 or bfloat16,
    hd <= 256, hd % 4 == 0)."""
    o, args = _launch_args(q, k, v, causal, window, softcap, scale)
    with torch.cuda.device(q.device):
        KERNEL(*args, DTYPES[q.dtype],
               torch.cuda.current_stream().cuda_stream)
    return o


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         softcap: Optional[float] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, H, Sq, hd); k, v: (B, KH, Skv, hd) → (B, H, Sq, hd), on the
    card, through the kernel ``route`` names.  The result is a (B, H, Sq,
    hd) view of a (B, Sq, H, hd) buffer."""
    launch = (launch_wgmma if route(q.dtype, q.shape[-1]) == "wgmma"
              else launch_cuda_cores)
    return launch(q, k, v, causal=causal, window=window, softcap=softcap,
                  scale=scale)


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor, *, causal: bool = True,
                             window: int = 0,
                             softcap: Optional[float] = None,
                             scale: Optional[float] = None):
    """The backward kernel: q, o, do (B, H, Sq, hd); k, v (B, KH, Skv, hd)
    → (dq (B, H, Sq, hd), dk, dv (B, KH, Skv, hd)), views of (B, S, heads,
    hd) buffers, in the inputs' dtype (float32 or bfloat16, hd <= 256,
    hd % 4 == 0, 1 <= Sq <= Skv).  Raises on anything else."""
    check_operands(q, k, v, o, do)
    if q.dim() != 4 or k.shape != v.shape or o.shape != q.shape \
            or do.shape != q.shape:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} o{tuple(o.shape)} "
                         f"do{tuple(do.shape)}")
    b, h, sq, hd = q.shape
    kh, skv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != hd or kh < 1 or h % kh:
        raise ValueError("k/v must be (B, KH, Skv, hd) with H % KH == 0")
    check_head_dim(hd)
    if not 1 <= sq <= skv:
        raise ValueError(f"kernel takes 1 <= Sq <= Skv, got {sq} > {skv}")
    scale = scale if scale is not None else hd ** -0.5
    dev, dt = q.device, q.dtype
    dq = torch.empty((b, sq, h, hd), dtype=dt, device=dev).transpose(1, 2)
    dk = torch.empty((b, skv, kh, hd), dtype=dt, device=dev).transpose(1, 2)
    dv = torch.empty((b, skv, kh, hd), dtype=dt, device=dev).transpose(1, 2)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
    ts = (q, k, v, o, do, dq, dk, dv)
    strides = (ctypes.c_longlong * 24)(*[x for t in ts
                                         for x in t.stride()[:3]])
    with torch.cuda.device(dev):
        BWD_KERNEL(*[t.data_ptr() for t in ts], lse.data_ptr(),
                   delta.data_ptr(), b, h, kh, sq, skv, hd, strides,
                   int(causal), int(window), float(softcap or 0.0),
                   float(scale), DTYPES[dt],
                   torch.cuda.current_stream().cuda_stream)
    return dq, dk, dv


def flash_attention_model_layout(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, **kw) -> torch.Tensor:
    """The forward in the model layout, q (B, Sq, H, hd), k, v (B, Skv, KH,
    hd) → (B, Sq, H, hd): ``flash_attention_cuda`` on the card, the plain
    version on the CPU.  The caller has refused mixed devices."""
    if q.device.type == "cuda":
        return flash_attention_cuda(q.transpose(1, 2), k.transpose(1, 2),
                                    v.transpose(1, 2), **kw).transpose(1, 2)
    return ref.flash_attention(q, k, v, **kw)


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention under autograd, in the model layout: q (B, Sq, H,
    hd), k, v (B, Skv, KH, hd) → (B, Sq, H, hd), as ``ops.flash_attention``.
    On the card the forward is ``flash_attention_cuda`` (its route by dtype
    and head dim) and the backward ``flash_attention_bwd_cuda``; on the CPU
    both are the plain versions.  It saves q, k, v and the output; the
    backward recomputes p blockwise, as the JAX package's
    ``ref.flash_structured`` VJP does."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale):
        kw = {"causal": causal, "window": window, "softcap": softcap,
              "scale": scale}
        o = flash_attention_model_layout(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, o)
        ctx.kw = kw
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        if do.stride(-1) != 1:
            do = do.contiguous()
        if q.device.type == "cuda":
            dq, dk, dv = flash_attention_bwd_cuda(
                *(t.transpose(1, 2) for t in (q, k, v, o, do)), **ctx.kw)
            dq, dk, dv = (t.transpose(1, 2) for t in (dq, dk, dv))
        else:
            dq, dk, dv = ref.flash_attention_bwd(q, k, v, o, do, **ctx.kw)
        return dq, dk, dv, None, None, None, None
