"""Flash-decoding over a dense cache: the wrapper around
``csrc/decode_attention.cu``.

One block per (KV split, KV head, batch row); the group's ``q_len·group``
token-major query rows share every K/V tile, and a second small kernel
combines the splits.  Per-row ``cache_len`` (B,) (a scalar broadcasts);
rows with ``cache_len == 0`` output zeros.  ``q_len > 1`` scores a chunk
causally within the chunk (chunk token ``t`` sees columns
``< cache_len - (q_len - 1 - t)``), the dense verify / prefill-append form.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Union

import torch

from repro_torch.kernels.build import DTYPES, CudaKernel, check_operands

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
KERNEL = CudaKernel("decode_attention.cu", "decode_attention_fwd",
                    [_P] * 7 + [_I] * 6 + [_L] * 12
                    + [_I, _I, _I, _F, _F, _I, _P])
KV_TILE = 64          # keys per shared-memory tile; splits are multiples
MAX_ROWS = 32         # q_len·group rows one block holds
BLOCKS_PER_SM = 2     # split-K target: about this many blocks per SM


def device_lengths(cache_len: Union[int, torch.Tensor], b: int,
                   device: torch.device) -> torch.Tensor:
    """cache_len as the kernel reads it: a contiguous (B,) int32 tensor on
    ``device``.  A Python int is filled on the device (no host copy)."""
    if isinstance(cache_len, int):
        return torch.full((b,), cache_len, dtype=torch.int32, device=device)
    if cache_len.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"cache_len must be integer, got {cache_len.dtype}")
    if cache_len.device != device:
        raise ValueError("cache_len must lie on the operands' device")
    return cache_len.to(torch.int32).broadcast_to((b,)).contiguous()


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def split_plan(b: int, kh: int, s: int, sm_count: int):
    """(splits, split_len): enough KV splits of whole tiles that B·KH·splits
    blocks fill about ``BLOCKS_PER_SM`` blocks per SM.  The last split may
    be shorter; the kernel clips every split at S."""
    n_tiles = math.ceil(s / KV_TILE)
    want = math.ceil(BLOCKS_PER_SM * sm_count / max(b * kh, 1))
    per = math.ceil(n_tiles / min(max(want, 1), n_tiles))
    return math.ceil(n_tiles / per), per * KV_TILE


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          cache_len: Union[int, torch.Tensor], *,
                          window: int = 0, softcap: Optional[float] = None,
                          scale: Optional[float] = None,
                          q_len: int = 1) -> torch.Tensor:
    """q: (B, KH, q_len·group, hd) token-major rows; k, v: (B, KH, S, hd);
    cache_len: int or () / (B,) int tensor of valid slots INCLUDING the
    chunk → (B, KH, q_len·group, hd), on the card."""
    check_operands(q, k, v)
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    b, kh, rows, hd = q.shape
    s = k.shape[2]
    if k.shape[:2] != (b, kh) or k.shape[3] != hd:
        raise ValueError("k/v must be (B, KH, S, hd) matching q")
    if rows % q_len or not 1 <= rows <= MAX_ROWS:
        raise ValueError(f"rows {rows} must be q_len·group <= {MAX_ROWS}")
    if hd > 128 or hd % 4:
        raise ValueError(f"head dim {hd} unsupported (hd <= 128, hd % 4 == 0)")
    if s < 1:
        raise ValueError("empty cache")
    lens = device_lengths(cache_len, b, q.device)
    scale = scale if scale is not None else hd ** -0.5
    splits, split_len = split_plan(b, kh, s, _sm_count(q.device.index))
    o = torch.empty((b, kh, rows, hd), dtype=q.dtype, device=q.device)
    part_acc = torch.empty((b, kh, splits, rows, hd), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((b, kh, splits, rows, 2), dtype=torch.float32,
                          device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        KERNEL(q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
               o.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
               b, kh, rows, q_len, s, hd,
               *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               *o.stride()[:3],
               splits, split_len, int(window), float(softcap or 0.0),
               float(scale), DTYPES[q.dtype], stream)
    return o
