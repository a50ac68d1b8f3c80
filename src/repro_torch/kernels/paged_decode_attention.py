"""Flash-decoding through a block table over a paged KV pool: the wrapper
around the paged entry points of ``csrc/decode_attention_mma.cu`` and
``csrc/decode_attention.cu``.

The paged form of ``decode_attention``'s kernels, sharing their bodies,
with its own route rule (``route``: bf16 at hd 64, 128 and 256 on the
tensor cores; at 256, gemma3-1b's, the kernel stages Q in shared memory
and runs one block an SM): key ``s`` of batch
row ``b`` lives at ``pool[block_table[b, s // page], kh, s % page, :]``.
One entry serves the slot path's decode (``q_len`` 1) and the speculative
verifier (``q_len`` = γ+1, causal within the chunk), at any
``q_len·group``: rows past one block's 64 go to further row tiles.  The
split plan follows the table width, which is fixed for an engine, never
the lengths; keys at or past a row's ``cache_len`` are never read.

The pools may be int8 or fp8 (e4m3) with per-(page, slot, head) f32 scales
in kernel layout (n_pages, KH, page), the model's (n_pages, page, KH)
scales passed as ``transpose(1, 2)`` views.  Both kernels read the 8-bit
pages and the scales themselves, each key's scale through the same block
table entry as its page: the CUDA-core kernel dequantizes in f32 as it
loads a tile (the JAX kernels' dequant route); the tensor-core kernel
converts each stored element exactly to bf16 and applies the key scales to
the columns of S and the value scales to p before PV.  The route still
follows q's dtype and head dim alone.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Union

import torch

from repro_torch.kernels.build import (DTYPES, CudaKernel, check_16_bytes,
                                       check_head_dim, check_pools,
                                       pool_name, scale_args)
from repro_torch.kernels.decode_attention import (MMA_HEAD_DIMS,
                                                  MMA_MAX_ROWS, MMA_PAGED,
                                                  _sm_count,
                                                  card_cluster_plan,
                                                  device_lengths, mma_route,
                                                  row_tile, split_plan)

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
KERNEL = CudaKernel("decode_attention.cu", "paged_decode_attention_fwd",
                    [_P] * 10 + [_I] * 8 + [_L] * 19
                    + [_I, _I, _I, _F, _F, _I, _I, _P])
MMA_KERNEL = CudaKernel("decode_attention_mma.cu",
                        "paged_decode_attention_mma_fwd",
                        [_P] * 8 + [_I] * 8 + [_L] * 19
                        + [_I, _I, _I, _F, _F, _I, _P])
MAX_ROWS = 64         # query rows of one CUDA-core row tile (8 warps)


def route(dtype: torch.dtype, hd: int) -> str:
    """Paged decode's route: ``"mma"`` for bfloat16 at hd 64, 128 or 256,
    ``"cuda_cores"`` for float32 and other head dims."""
    return mma_route(dtype, hd, MMA_PAGED)


def check_paged(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                block_table: torch.Tensor,
                k_scale: Optional[torch.Tensor] = None,
                v_scale: Optional[torch.Tensor] = None):
    """The operand rules the paged kernels share: q (B, KH, rows, hd),
    pools (n_pages, KH, page, hd) matching q, of q's dtype, or int8 /
    float8_e4m3fn with both (n_pages, KH, page) f32 scales
    (``build.check_pools``), hd <= 256 with hd % 4 == 0, a non-empty
    (B, P) int32 block table with unit column stride on the operands'
    device.  Returns (B, KH, rows, hd, page, P, the pool's C code)."""
    pool = check_pools(q, k_pool, v_pool, k_scale, v_scale)
    if q.dim() != 4 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"bad shapes q{tuple(q.shape)} "
                         f"k_pool{tuple(k_pool.shape)} "
                         f"v_pool{tuple(v_pool.shape)}")
    b, kh, rows, hd = q.shape
    if k_pool.shape[1] != kh or k_pool.shape[3] != hd:
        raise ValueError("pools must be (n_pages, KH, page, hd) matching q")
    check_head_dim(hd)
    if (block_table.dim() != 2 or block_table.shape[0] != b
            or block_table.dtype != torch.int32
            or block_table.device != q.device
            or block_table.stride(1) != 1):
        raise ValueError("block_table must be a (B, P) int32 tensor with "
                         "unit column stride on the operands' device")
    if block_table.shape[1] < 1:
        raise ValueError("empty block table")
    return b, kh, rows, hd, k_pool.shape[2], block_table.shape[1], pool


def _group(q, q_len):
    rows = q.shape[2]
    if q_len < 1 or rows < 1 or rows % q_len:
        raise ValueError(f"rows {rows} must be q_len·group with q_len "
                         f"{q_len}")
    return rows // q_len


def launch_cuda_cores(q: torch.Tensor, k_pool: torch.Tensor,
                      v_pool: torch.Tensor, block_table: torch.Tensor,
                      cache_len: Union[int, torch.Tensor], *,
                      window: int = 0, softcap: Optional[float] = None,
                      scale: Optional[float] = None, q_len: int = 1,
                      k_scale: Optional[torch.Tensor] = None,
                      v_scale: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """The CUDA-core kernel, on any input it takes (float32 or bfloat16
    q, fp or 8-bit pools, hd <= 256, hd % 4 == 0)."""
    b, kh, rows, hd, page, n_blocks, pool = check_paged(
        q, k_pool, v_pool, block_table, k_scale, v_scale)
    group = _group(q, q_len)
    lens = device_lengths(cache_len, b, q.device)
    scale = scale if scale is not None else hd ** -0.5
    splits, split_len = split_plan(b, kh, n_blocks * page,
                                   _sm_count(q.device.index))
    o = torch.empty((b, kh, rows, hd), dtype=q.dtype, device=q.device)
    part_acc = torch.empty((b, kh, splits, rows, hd), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((b, kh, splits, rows, 2), dtype=torch.float32,
                          device=q.device)
    ks, vs = k_pool.stride(), v_pool.stride()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        sc = scale_args(k_scale, v_scale)
        KERNEL(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), *sc[:2],
               block_table.data_ptr(), lens.data_ptr(), o.data_ptr(),
               part_acc.data_ptr(), part_ml.data_ptr(),
               b, kh, rows, row_tile(rows, group, MAX_ROWS), q_len, n_blocks,
               page, hd, *q.stride()[:3], ks[0], ks[1], ks[2], vs[0], vs[1],
               vs[2], *sc[2:], block_table.stride(0), *o.stride()[:3],
               splits, split_len, int(window), float(softcap or 0.0),
               float(scale), DTYPES[q.dtype], pool, stream,
               pool=pool_name(k_pool))
    return o


def launch_mma(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
               block_table: torch.Tensor,
               cache_len: Union[int, torch.Tensor], *, window: int = 0,
               softcap: Optional[float] = None,
               scale: Optional[float] = None, q_len: int = 1,
               k_scale: Optional[torch.Tensor] = None,
               v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The tensor-core kernel: bfloat16 q at hd 64, 128 or 256 over bf16
    or 8-bit pools, operands that keep cp.async's 16-byte rule; raises on
    anything else."""
    if route(q.dtype, q.shape[-1]) != "mma":
        raise ValueError(f"the mma kernel takes bfloat16 at hd "
                         f"{MMA_HEAD_DIMS[MMA_PAGED]}, got {q.dtype} hd "
                         f"{q.shape[-1]}")
    b, kh, rows, hd, page, n_blocks, pool = check_paged(
        q, k_pool, v_pool, block_table, k_scale, v_scale)
    check_16_bytes("cp.async", q=q, k_pool=k_pool, v_pool=v_pool)
    tile = row_tile(rows, _group(q, q_len), MMA_MAX_ROWS)
    lens = device_lengths(cache_len, b, q.device)
    scale = scale if scale is not None else hd ** -0.5
    splits, split_len = card_cluster_plan(b * kh * math.ceil(rows / tile),
                                          n_blocks * page, q.device.index,
                                          MMA_PAGED, hd, tile, pool)
    o = torch.empty((b, kh, rows, hd), dtype=q.dtype, device=q.device)
    ks, vs = k_pool.stride(), v_pool.stride()
    sc = scale_args(k_scale, v_scale)
    with torch.cuda.device(q.device):
        MMA_KERNEL(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                   *sc[:2], block_table.data_ptr(), lens.data_ptr(),
                   o.data_ptr(), b, kh, rows, tile, q_len, n_blocks, page, hd,
                   *q.stride()[:3], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
                   *sc[2:], block_table.stride(0), *o.stride()[:3], splits,
                   split_len, int(window), float(softcap or 0.0),
                   float(scale), pool, torch.cuda.current_stream().cuda_stream,
                   pool=pool_name(k_pool))
    return o


def paged_decode_attention_cuda(q: torch.Tensor, k_pool: torch.Tensor,
                                v_pool: torch.Tensor,
                                block_table: torch.Tensor,
                                cache_len: Union[int, torch.Tensor], *,
                                window: int = 0,
                                softcap: Optional[float] = None,
                                scale: Optional[float] = None,
                                q_len: int = 1,
                                k_scale: Optional[torch.Tensor] = None,
                                v_scale: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """q: (B, KH, q_len·group, hd) token-major rows; k_pool, v_pool:
    (n_pages, KH, page, hd), any strides with a unit innermost one (the
    model's (n_pages, page, KH, hd) pools pass as ``transpose(1, 2)``
    views); ``k_scale``/``v_scale`` (n_pages, KH, page) f32 for int8/fp8
    pools, any strides; block_table: (B, P) int32; cache_len: int or () /
    (B,) int tensor of valid slots INCLUDING the chunk → (B, KH,
    q_len·group, hd), on the card, through the kernel ``route`` names."""
    launch = (launch_mma if route(q.dtype, q.shape[-1]) == "mma"
              else launch_cuda_cores)
    return launch(q, k_pool, v_pool, block_table, cache_len, window=window,
                  softcap=softcap, scale=scale, q_len=q_len, k_scale=k_scale,
                  v_scale=v_scale)
