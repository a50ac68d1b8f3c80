"""Prefix-append attention through a block table over paged KV pools: the
wrapper around ``paged_prefill_attention_fwd`` in
``csrc/paged_prefill_attention.cu``.

The chunked-prefill scoring op: a ``q_len``-token chunk per batch row whose
K/V the caller has just written into the pools; chunk token ``t`` of row
``b`` sees the logical columns ``< cache_len[b] - (q_len - 1) + t``, where
key ``s`` lives at ``pool[block_table[b, s // page], kh, s % page, :]``.
One block per (query sub-block of ``q_blk`` chunk tokens, KV head, batch
row), each walking only the key tiles its own tokens can see, so chunks of
any length run (the verify kernel holds at most 64 query rows).  ``q_blk``
is a tile knob: ``q_blk·group <= 64``, and the last sub-block may be short.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Union

import torch

from repro_torch.kernels.build import DTYPES, CudaKernel
from repro_torch.kernels.decode_attention import device_lengths
from repro_torch.kernels.paged_decode_attention import check_paged

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
KERNEL = CudaKernel("paged_prefill_attention.cu",
                    "paged_prefill_attention_fwd",
                    [_P] * 6 + [_I] * 8 + [_L] * 13
                    + [_I, _F, _F, _I, _P])
MAX_ROWS = 64         # q_blk·group query rows one block holds (8 warps)
Q_BLK = 8             # chunk tokens per sub-block, where group allows


def default_q_blk(group: int) -> int:
    """``Q_BLK`` tokens per sub-block, fewer where ``Q_BLK·group`` rows
    would not fit one block (8 × 6 = 48 rows on the 2B, 8 × 7 = 56 on the
    7B)."""
    return max(1, min(Q_BLK, MAX_ROWS // group))


def paged_prefill_attention_cuda(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor,
                                 block_table: torch.Tensor,
                                 cache_len: Union[int, torch.Tensor], *,
                                 window: int = 0,
                                 softcap: Optional[float] = None,
                                 scale: Optional[float] = None,
                                 q_len: int = 1,
                                 q_blk: Optional[int] = None
                                 ) -> torch.Tensor:
    """q: (B, KH, q_len·group, hd) token-major rows; k_pool, v_pool:
    (n_pages, KH, page, hd), any strides with a unit innermost one (the
    model's (n_pages, page, KH, hd) pools pass as ``transpose(1, 2)``
    views); block_table: (B, P) int32; cache_len: int or () / (B,) int
    tensor of valid slots INCLUDING the chunk → (B, KH, q_len·group, hd),
    on the card."""
    b, kh, rows, hd, page, n_blocks = check_paged(q, k_pool, v_pool,
                                                  block_table)
    if q_len < 1 or rows < q_len or rows % q_len:
        raise ValueError(f"rows {rows} must be q_len·group with q_len "
                         f"{q_len}")
    group = rows // q_len
    q_blk = default_q_blk(group) if q_blk is None else q_blk
    if q_blk < 1 or q_blk * group > MAX_ROWS:
        raise ValueError(f"q_blk {q_blk} must give 1..{MAX_ROWS} rows per "
                         f"block at group {group}")
    lens = device_lengths(cache_len, b, q.device)
    scale = scale if scale is not None else hd ** -0.5
    o = torch.empty((b, kh, rows, hd), dtype=q.dtype, device=q.device)
    ks, vs = k_pool.stride(), v_pool.stride()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        KERNEL(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
               block_table.data_ptr(), lens.data_ptr(), o.data_ptr(),
               b, kh, q_len, group, q_blk, n_blocks, page, hd,
               *q.stride()[:3], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
               block_table.stride(0), *o.stride()[:3],
               int(window), float(softcap or 0.0), float(scale),
               DTYPES[q.dtype], stream)
    return o
