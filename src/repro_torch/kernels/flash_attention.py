"""Flash-attention forward: the wrapper around its two CUDA kernels.

Causal GQA attention with an online softmax, optional sliding window and
logit softcap, KV read at head ``h // group``.  Layout (B, H, S, hd) as the
Pallas kernel's; any strides with a unit innermost one, so ``ops`` hands
the model's (B, S, H, hd) tensors over as transposed views without a copy.
Sq need not be a multiple of any tile: the kernels mask their ragged edge.

Two routes, chosen by ``route`` from the dtype and head dim alone:

* ``"wgmma"``: bfloat16 at hd 64, 128 or 256 (the models' prefill,
  gemma3-1b's 256 included) goes to ``csrc/flash_attention_wgmma.cu``,
  QK^T and PV on the tensor cores with K/V tiles loaded by TMA.  TMA needs
  16-byte aligned bases and strides; operands that break the rule raise
  here, they never take the other route.  p is rounded to bf16 before PV.
* ``"cuda_cores"``: float32 (whose card-vs-CPU decisions must not flip on
  TF32 rounding) and every other head dim (hd <= 256, hd % 4 == 0: the
  proxies' 12 and 16) go to ``csrc/flash_attention.cu``, f32 math on the
  CUDA cores.

The backward (training) has two routes too, chosen by ``bwd_route`` from
the dtype and head dim alone (``BWD_WGMMA_HEAD_DIMS``, the forward's
tensor-core head dims):

* ``"wgmma"``: bfloat16 at hd 64, 128 or 256 (the 2B's, the 7B's and
  gemma3-1b's training) goes to ``csrc/flash_attention_bwd_wgmma.cu`` (a
  delta pre-pass, dK/dV by key tile with the group's heads split over
  ``bwd_splits`` blocks and their f32 partials summed in a fixed order, dQ
  by query tile; wgmma + TMA; at hd 256 two consumer warpgroups a block
  split the gradient's columns and hand P and dS over in shared memory).
  It reads the logsumexp ``lse`` that the wgmma forward writes when asked
  (``launch_wgmma(..., with_lse=True)``), the JAX package's residual.  It
  rounds p and dS to bf16 before the products that take them.  TMA's
  16-byte rule holds for q, k, v, o and do, or it raises.
* ``"cuda_cores"``: float32 and every other head dim go to
  ``csrc/flash_attention_bwd.cu`` (f32 math, three launches: row
  statistics, dK/dV by key tile, dQ by query tile).

Both are deterministic (no atomics; the GQA sum is a loop).
``FlashAttentionFn`` ties forward and backward together for autograd: on
the card the forward saves lse where the backward's route is wgmma (and
so is the forward's) and the backward takes its route's kernel; on the
CPU both are the plain versions.
"""
from __future__ import annotations

import ctypes
import functools
import heapq
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
                          [_P] * 5 + [_I] * 6 + [_L] * 12
                          + [_I, _I, _F, _F, _P])
BWD_KERNEL = CudaKernel("flash_attention_bwd.cu", "flash_attention_bwd",
                        [_P] * 10 + [_I] * 6
                        + [ctypes.POINTER(ctypes.c_longlong)]
                        + [_I, _I, _F, _F, _I, _P])
BWD_WGMMA_KERNEL = CudaKernel("flash_attention_bwd_wgmma.cu",
                              "flash_attention_bwd_wgmma",
                              [_P] * 11 + [_I] * 7
                              + [ctypes.POINTER(ctypes.c_longlong)]
                              + [_I, _I, _F, _F, _P])
WGMMA_HEAD_DIMS = (64, 128, 256)
#: the head dims of the tensor-core backward (the forward's)
BWD_WGMMA_HEAD_DIMS = (64, 128, 256)
#: rows of every tile of the tensor-core kernels
TILE = 64


def route(dtype: torch.dtype, hd: int) -> str:
    """The kernel a (dtype, head dim) takes: ``"wgmma"`` for bfloat16 at hd
    64, 128 or 256, ``"cuda_cores"`` for float32 and other head dims; any
    other dtype raises."""
    if dtype not in DTYPES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {dtype}")
    if dtype == torch.bfloat16 and hd in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "cuda_cores"


def bwd_route(dtype: torch.dtype, hd: int) -> str:
    """The backward kernel a (dtype, head dim) takes: ``"wgmma"`` for
    bfloat16 at hd 64, 128 or 256, ``"cuda_cores"`` for float32 and other
    head dims; any other dtype raises.  Where it names ``"wgmma"`` the
    forward's route does too, so that forward has saved the lse the wgmma
    backward reads."""
    if route(dtype, hd) == "wgmma" and hd in BWD_WGMMA_HEAD_DIMS:
        return "wgmma"
    return "cuda_cores"


def lse_rows(sq: int) -> int:
    """The row length of the wgmma forward's lse and the backward's delta,
    (B, H, lse_rows(Sq)) float32: Sq rounded up to whole tiles, so each
    tile's 64 values are one 16-byte aligned copy."""
    return -(-sq // TILE) * TILE


#: the dK/dV pass's cost model (``bwd_splits``), measured on an H100
#: (NVIDIA H100 80GB HBM3, 700 W) by ``chip_smoke.py``'s ``bwd_tail`` (the
#: unsplit pass over its heaviest block's pairs): a (query tile, head)
#: pair of a 64-key block takes ~2.1 µs at hd 128 (one consumer
#: warpgroup, 242 registers a thread, one block a SM; hd 64 scaled from
#: it) and ~3.46 µs at hd 256 (two warpgroups, 199 registers; gemma3-1b,
#: B 4 x S 1025, 0.2355 ms over 68 pairs); partials move at the memory's
#: 3.35 TB/s
PAIR_US_HD128 = 2.1
PAIR_US_HD256 = 3.46
BYTES_PER_US = 3.35e6


def _tile_pairs(sq: int, skv: int, causal: bool, window: int):
    """The query tiles that see each 64-key tile's keys, in key-tile
    order."""
    off, out = skv - sq, []
    for k0 in range(0, skv, TILE):
        kmax = min(k0 + TILE, skv) - 1
        i_begin = max(0, k0 - off) if causal else 0
        i_end = min(sq, kmax + window - off) if window > 0 else sq
        out.append((-(-i_end // TILE) - i_begin // TILE)
                   if i_end > i_begin else 0)
    return out


def bwd_pairs(b: int, kh: int, group: int, sq: int, skv: int, causal: bool,
              window: int):
    """The dK/dV pass's unsplit work in (query tile, head) pairs: (the
    heaviest block's, all blocks'), a block per (64-key tile, KV head,
    batch row) walking its group's heads over the query tiles that see
    its keys."""
    n_t = _tile_pairs(sq, skv, causal, window)
    return max(n_t) * group, sum(n_t) * group * b * kh


def bwd_makespan(b: int, kh: int, group: int, sq: int, skv: int,
                 causal: bool, window: int, d: int, sms: int) -> float:
    """The dK/dV pass's length in pairs with the group split over ``d``
    blocks: its blocks, one a SM, handed out in launch order (the split
    and KV head fastest, the key tile slowest) to whichever SM is free
    first.  The first key tiles are the heaviest under the causal mask,
    so the order is close to longest first; a windowed pass's equal middle
    tiles fill whole waves, and a split that leaves a last wave short of
    a full one gains nothing."""
    free = [0.0] * sms
    for n_t in _tile_pairs(sq, skv, causal, window):
        for _ in range(b * kh * d):
            heapq.heapreplace(free, free[0] + n_t * group / d)
    return max(free)


@functools.lru_cache(maxsize=256)
def bwd_splits(b: int, kh: int, group: int, hd: int, sq: int, skv: int,
               causal: bool, window: int, sms: int) -> int:
    """How many blocks share a KV head's group of heads in the wgmma
    backward's dK/dV pass.  Its grid is one block per (64-key tile, KV
    head, batch row, split) and each block walks its heads' query tiles,
    so under the causal mask the first key tile does Sq/64 times the last
    one's work; the pass lasts ``bwd_makespan`` pairs.  Splitting over d
    blocks costs f32 partials written, read and summed (2d + 1/2 f32
    tiles of dK and dV).  Returns the divisor d of ``group`` with the
    least modelled time (1: no partials)."""
    pair_us = PAIR_US_HD256 if hd > 128 else PAIR_US_HD128 * hd / 128
    tile_bytes = b * kh * skv * hd * 4 * 2
    best, best_us = 1, None
    for d in range(1, group + 1):
        if group % d:
            continue
        us = bwd_makespan(b, kh, group, sq, skv, causal, window, d,
                          sms) * pair_us
        if d > 1:
            us += (2 * d + 0.5) * tile_bytes / BYTES_PER_US
        if best_us is None or us < best_us:
            best, best_us = d, us
    return best


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
                 scale: Optional[float] = None, with_lse: bool = False):
    """The tensor-core kernel: bfloat16 at hd 64, 128 or 256, operands that
    keep TMA's 16-byte rule; raises on anything else.  Returns o, or with
    ``with_lse`` (o, lse): lse each row's logsumexp of its scaled (capped)
    logits over its visible keys, (B, H, Sq) float32, a view of a (B, H,
    lse_rows(Sq)) buffer (the wgmma backward's residual)."""
    if route(q.dtype, q.shape[-1]) != "wgmma":
        raise ValueError(f"the wgmma kernel takes bfloat16 at hd "
                         f"{WGMMA_HEAD_DIMS}, got {q.dtype} hd {q.shape[-1]}")
    o, args = _launch_args(q, k, v, causal, window, softcap, scale)
    check_tma(q=q, k=k, v=v)
    b, h, sq = q.shape[:3]
    lse = (torch.empty((b, h, lse_rows(sq)), dtype=torch.float32,
                       device=q.device) if with_lse else None)
    with torch.cuda.device(q.device):
        WGMMA_KERNEL(*args[:4], 0 if lse is None else lse.data_ptr(),
                     *args[4:], torch.cuda.current_stream().cuda_stream)
    return (o, lse[..., :sq]) if with_lse else o


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


def _bwd_args(q, k, v, o, do, scale):
    """Checks what both backward kernels take; returns (dq, dk, dv) (views
    of (B, S, heads, hd) buffers), the strides array and the scale."""
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
    dev, dt = q.device, q.dtype
    dq = torch.empty((b, sq, h, hd), dtype=dt, device=dev).transpose(1, 2)
    dk = torch.empty((b, skv, kh, hd), dtype=dt, device=dev).transpose(1, 2)
    dv = torch.empty((b, skv, kh, hd), dtype=dt, device=dev).transpose(1, 2)
    ts = (q, k, v, o, do, dq, dk, dv)
    strides = (ctypes.c_longlong * 24)(*[x for t in ts
                                         for x in t.stride()[:3]])
    scale = scale if scale is not None else hd ** -0.5
    return (dq, dk, dv), [t.data_ptr() for t in ts], strides, scale


def launch_bwd_cuda_cores(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          o: torch.Tensor, do: torch.Tensor, *,
                          causal: bool = True, window: int = 0,
                          softcap: Optional[float] = None,
                          scale: Optional[float] = None):
    """The CUDA-core backward on any input it takes (float32 or bfloat16,
    hd <= 256, hd % 4 == 0, 1 <= Sq <= Skv); it recomputes each row's
    statistics.  Returns (dq, dk, dv)."""
    grads, ptrs, strides, scale = _bwd_args(q, k, v, o, do, scale)
    b, h, sq, hd = q.shape
    kh, skv = k.shape[1], k.shape[2]
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        BWD_KERNEL(*ptrs, lse.data_ptr(), delta.data_ptr(), b, h, kh, sq,
                   skv, hd, strides, int(causal), int(window),
                   float(softcap or 0.0), float(scale), DTYPES[q.dtype],
                   torch.cuda.current_stream().cuda_stream)
    return grads


def check_lse(lse: torch.Tensor, q: torch.Tensor) -> None:
    """The wgmma backward's lse: float32 (B, H, Sq) on q's device, a view
    of a contiguous (B, H, lse_rows(Sq)) buffer at a 16-byte aligned base,
    as ``launch_wgmma(..., with_lse=True)`` returns it.  Raises."""
    b, h, sq = q.shape[:3]
    r = lse_rows(sq)
    if (lse.dtype != torch.float32 or lse.device != q.device
            or tuple(lse.shape) != (b, h, sq)
            or lse.stride() != (h * r, r, 1) or lse.data_ptr() % 16
            or lse.untyped_storage().nbytes()
            < 4 * (lse.storage_offset() + b * h * r)):
        raise ValueError(f"lse must be the wgmma forward's float32 (B, H, "
                         f"Sq) = {(b, h, sq)} view of a (B, H, {r}) buffer, "
                         f"got {lse.dtype} {tuple(lse.shape)} strides "
                         f"{lse.stride()} on {lse.device}")


def launch_bwd_wgmma(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor, *,
                     causal: bool = True, window: int = 0,
                     softcap: Optional[float] = None,
                     scale: Optional[float] = None):
    """The tensor-core backward: bfloat16 at hd 64, 128 or 256, q, k, v,
    o and do keeping TMA's 16-byte rule, ``lse`` the wgmma forward's; raises on
    anything else.  Returns (dq, dk, dv)."""
    if bwd_route(q.dtype, q.shape[-1]) != "wgmma":
        raise ValueError(f"the wgmma backward takes bfloat16 at hd "
                         f"{BWD_WGMMA_HEAD_DIMS}, got {q.dtype} hd "
                         f"{q.shape[-1]}")
    grads, ptrs, strides, scale = _bwd_args(q, k, v, o, do, scale)
    check_tma(q=q, k=k, v=v, o=o, do=do)
    check_lse(lse, q)
    b, h, sq, hd = q.shape
    kh, skv = k.shape[1], k.shape[2]
    dev = q.device
    delta = torch.empty((b, h, lse_rows(sq)), dtype=torch.float32,
                        device=dev)
    splits = bwd_splits(b, kh, h // kh, hd, sq, skv, causal, window,
                        torch.cuda.get_device_properties(dev)
                        .multi_processor_count)
    part = (torch.empty(2 * splits * b * kh * skv * hd, dtype=torch.float32,
                        device=dev) if splits > 1 else None)
    with torch.cuda.device(dev):
        BWD_WGMMA_KERNEL(*ptrs, lse.data_ptr(), delta.data_ptr(),
                         0 if part is None else part.data_ptr(), splits, b,
                         h, kh, sq, skv, hd, strides, int(causal),
                         int(window), float(softcap or 0.0), float(scale),
                         torch.cuda.current_stream().cuda_stream)
    return grads


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor, *,
                             lse: Optional[torch.Tensor] = None,
                             causal: bool = True, window: int = 0,
                             softcap: Optional[float] = None,
                             scale: Optional[float] = None):
    """The backward on the card: q, o, do (B, H, Sq, hd); k, v (B, KH, Skv,
    hd) → (dq (B, H, Sq, hd), dk, dv (B, KH, Skv, hd)), views of (B, S,
    heads, hd) buffers in the inputs' dtype, through the kernel
    ``bwd_route`` names.  The wgmma route needs ``lse``, the wgmma
    forward's residual; the CUDA-core route takes none.  Raises on what
    the route's kernel does not take."""
    if bwd_route(q.dtype, q.shape[-1]) == "wgmma":
        if lse is None:
            raise ValueError("the wgmma backward reads the forward's lse "
                             "(launch_wgmma(..., with_lse=True))")
        return launch_bwd_wgmma(q, k, v, o, do, lse, causal=causal,
                                window=window, softcap=softcap, scale=scale)
    if lse is not None:
        raise ValueError("the CUDA-core backward takes no lse")
    return launch_bwd_cuda_cores(q, k, v, o, do, causal=causal,
                                 window=window, softcap=softcap, scale=scale)


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
    and head dim) and the backward ``flash_attention_bwd_cuda`` (its
    route by ``bwd_route``); on the CPU both are the plain versions.  It
    saves q, k, v and the output, and where the backward's route is wgmma
    also lse: the JAX package's residual (q, k, v, out, lse) of
    ``ref.flash_structured``, whose VJP recomputes p blockwise from it; the
    CUDA-core backward (f32 and the other head dims) recomputes lse
    itself."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale):
        kw = {"causal": causal, "window": window, "softcap": softcap,
              "scale": scale}
        if (q.device.type == "cuda"
                and bwd_route(q.dtype, q.shape[-1]) == "wgmma"):
            o, lse = launch_wgmma(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), with_lse=True, **kw)
            o = o.transpose(1, 2)
            ctx.save_for_backward(q, k, v, o, lse)
        else:
            o = flash_attention_model_layout(q, k, v, **kw)
            ctx.save_for_backward(q, k, v, o)
        ctx.kw = kw
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, *lse = ctx.saved_tensors
        if do.stride(-1) != 1:
            do = do.contiguous()
        if q.device.type == "cuda":
            do = do.transpose(1, 2)
            if lse:
                try:
                    check_tma(do=do)
                except ValueError:          # TMA's 16-byte rule
                    do = do.contiguous()
            dq, dk, dv = flash_attention_bwd_cuda(
                *(t.transpose(1, 2) for t in (q, k, v, o)), do,
                lse=lse[0] if lse else None, **ctx.kw)
            dq, dk, dv = (t.transpose(1, 2) for t in (dq, dk, dv))
        else:
            dq, dk, dv = ref.flash_attention_bwd(q, k, v, o, do, **ctx.kw)
        return dq, dk, dv, None, None, None, None
