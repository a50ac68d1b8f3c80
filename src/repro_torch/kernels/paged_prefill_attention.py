"""Prefix-append attention through a block table over paged KV pools: the
wrapper around ``paged_prefill_attention_mma_fwd`` in
``csrc/decode_attention_mma.cu`` and ``paged_prefill_attention_fwd`` in
``csrc/paged_prefill_attention.cu``.

The chunked-prefill scoring op: a ``q_len``-token chunk per batch row whose
K/V the caller has just written into the pools; chunk token ``t`` of row
``b`` sees the logical columns ``< cache_len[b] - (q_len - 1) + t``, where
key ``s`` lives at ``pool[block_table[b, s // page], kh, s % page, :]``.

Two routes, chosen by ``route`` from the dtype and head dim:

* ``"mma"``: bfloat16 at hd 64, 128 or 256 (the models' chunked slot path,
  gemma3-1b's 256 included) runs the tensor-core decode body in its
  prefix-append mode: row tiles of up to 64 query rows (whole chunk
  tokens), each walking only the keys its rows see, split over a
  thread-block cluster and merged in distributed shared memory.  p is
  rounded to bf16 before PV.  cp.async needs 16-byte aligned bases and
  strides; operands that break the rule raise here.
* ``"cuda_cores"``: float32 and every other head dim (the proxies' 12 and
  16) run the CUDA-core kernel: one block per (query sub-block of
  ``q_blk`` chunk tokens, KV head, batch row), f32 math, no split-K.
  ``q_blk`` is its tile knob: ``q_blk·group <= 64``, and the last
  sub-block may be short.

The engine's fused step calls the op at a flat shape: q_len 1, one batch
row per scheduled token, a streaming scene's chunk as consecutive rows on
copies of one table row.  ``tile_plan`` (built on the host from the step's
slot and position of each flat row) groups each run of one slot at
consecutive positions into shared row tiles, so the tensor-core route
reads the scene's prefix once per (run, KV head, row tile), not once per
token.  The plan is a hint: it changes which rows share a tile, never a
row's result, and the plain version and the CUDA-core route ignore it.
Rows in no tile of the plan (the engine's padding rows, whose outputs it
drops) are not written.  Its length is fixed per engine (``plan_tiles``),
so the launch shape never follows the step's mix; empty entries exit.

The pools may be int8 or fp8 (e4m3) with per-(page, slot, head) f32
scales, read by both kernels as ``paged_decode_attention``'s are (the
CUDA-core one dequantizes in f32 as it loads, the tensor-core one converts
the stored bytes exactly to bf16 and scales the columns of S and p).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.kernels.build import (DTYPES, CudaKernel, check_16_bytes,
                                       pool_name, scale_args)
from repro_torch.kernels.decode_attention import (MMA_HEAD_DIMS,
                                                  MMA_MAX_ROWS, MMA_PREFILL,
                                                  card_cluster_plan,
                                                  device_lengths, mma_route,
                                                  row_tile)
from repro_torch.kernels.paged_decode_attention import _group, check_paged

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
KERNEL = CudaKernel("paged_prefill_attention.cu",
                    "paged_prefill_attention_fwd",
                    [_P] * 8 + [_I] * 8 + [_L] * 19
                    + [_I, _F, _F, _I, _I, _P])
MMA_KERNEL = CudaKernel("decode_attention_mma.cu",
                        "paged_prefill_attention_mma_fwd",
                        [_P] * 9 + [_I] * 8 + [_L] * 19
                        + [_I, _L, _I, _I, _F, _F, _I, _P])
MAX_ROWS = 64         # q_blk·group query rows one CUDA-core block holds
Q_BLK = 8             # chunk tokens per CUDA-core sub-block, where it fits


def route(dtype: torch.dtype, hd: int) -> str:
    """Prefix-append's route: ``"mma"`` for bfloat16 at hd 64, 128 or 256,
    ``"cuda_cores"`` for float32 and other head dims."""
    return mma_route(dtype, hd, MMA_PREFILL)


def default_q_blk(group: int) -> int:
    """``Q_BLK`` tokens per sub-block, fewer where ``Q_BLK·group`` rows
    would not fit one block (8 × 6 = 48 rows on the 2B, 8 × 7 = 56 on the
    7B)."""
    return max(1, min(Q_BLK, MAX_ROWS // group))


# ---------------------------------------------------------------------------
# the tile plan of the engine's flat shape
# ---------------------------------------------------------------------------

def tokens_per_tile(group: int) -> int:
    """Flat rows (one token each) one tensor-core row tile holds: 10 at
    group 6, 9 at group 7."""
    return max(1, MMA_MAX_ROWS // group)


def plan_tiles(token_budget: int, slots: int, group: int) -> int:
    """The plan's fixed length for an engine: each slot schedules at most
    one run of consecutive positions a step (a decode row, a prompt row or
    its scene's chunk), so the runs of ``token_budget`` rows cut into tiles
    of ``tokens_per_tile`` need at most ``slots + token_budget // tpt``
    tiles, and never more than one per row."""
    return min(token_budget, slots + token_budget // tokens_per_tile(group))


def tile_plan(srow: np.ndarray, pos: np.ndarray, n_slots: int, group: int,
              n_tiles: int) -> np.ndarray:
    """The row tiles of one flat step: row ``j`` is one token of slot
    ``srow[j]`` at cache position ``pos[j]``, rows with ``srow >= n_slots``
    are padding.  A run is a stretch of consecutive rows of one slot at
    consecutive positions; each run is cut into tiles of at most
    ``tokens_per_tile(group)`` rows.  Returns a (2, n_tiles) int32 array:
    row 0 the first flat row of each tile, row 1 its row count, tiles in
    flat order, then empty (0, 0) entries.  Raises if the step needs more
    than ``n_tiles``."""
    srow = np.asarray(srow)
    pos = np.asarray(pos)
    plan = np.zeros((2, n_tiles), np.int32)
    sched = srow < n_slots
    idx = np.flatnonzero(sched)
    if idx.size == 0:
        return plan
    cont = np.zeros(srow.shape, bool)
    cont[1:] = sched[:-1] & (srow[1:] == srow[:-1]) & (pos[1:] == pos[:-1] + 1)
    # each scheduled row's run start, then its offset in the run
    run0 = np.maximum.accumulate(np.where(cont[idx], 0, idx))
    first = (idx - run0) % tokens_per_tile(group) == 0
    tile_of = np.cumsum(first) - 1
    n = int(tile_of[-1]) + 1
    if n > n_tiles:
        raise ValueError(f"the step needs {n} row tiles, the plan holds "
                         f"{n_tiles}")
    plan[0, :n] = idx[first]
    plan[1, :n] = np.bincount(tile_of)
    return plan


def _check_plan(plan: torch.Tensor, device: torch.device) -> None:
    if (plan.dim() != 2 or plan.shape[0] != 2 or plan.shape[1] < 1
            or plan.dtype != torch.int32 or plan.device != device
            or plan.stride(1) != 1):
        raise ValueError("a tile plan must be a (2, n) int32 tensor with "
                         "unit column stride on the operands' device")


# ---------------------------------------------------------------------------
# the two launchers
# ---------------------------------------------------------------------------

def launch_cuda_cores(q: torch.Tensor, k_pool: torch.Tensor,
                      v_pool: torch.Tensor, block_table: torch.Tensor,
                      cache_len: Union[int, torch.Tensor], *,
                      window: int = 0, softcap: Optional[float] = None,
                      scale: Optional[float] = None, q_len: int = 1,
                      q_blk: Optional[int] = None,
                      k_scale: Optional[torch.Tensor] = None,
                      v_scale: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """The CUDA-core kernel, on any input it takes (float32 or bfloat16
    q, fp or 8-bit pools, hd <= 256, hd % 4 == 0)."""
    b, kh, rows, hd, page, n_blocks, pool = check_paged(
        q, k_pool, v_pool, block_table, k_scale, v_scale)
    group = _group(q, q_len)
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
        sc = scale_args(k_scale, v_scale)
        KERNEL(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), *sc[:2],
               block_table.data_ptr(), lens.data_ptr(), o.data_ptr(),
               b, kh, q_len, group, q_blk, n_blocks, page, hd,
               *q.stride()[:3], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
               *sc[2:], block_table.stride(0), *o.stride()[:3],
               int(window), float(softcap or 0.0), float(scale),
               DTYPES[q.dtype], pool, stream, pool=pool_name(k_pool))
    return o


@functools.lru_cache(maxsize=None)
def _mma_geometry(b: int, kh: int, rows: int, hd: int, page: int,
                  n_blocks: int, q_len: int, n_plan: int,
                  device_index: int, pool: int) -> Tuple[int, int, int]:
    """(tile rows, plan entries, key splits) of a tensor-core launch, once
    per geometry (an engine's calls share one): with a plan of ``n_plan``
    entries each entry is a row tile of up to ``tokens_per_tile`` tokens,
    without one (``n_plan`` 0) each batch row's rows go in ``row_tile``s; a
    group past one tile's 64 rows cannot share tiles, and there the plan
    is not used (0 entries)."""
    group = rows // q_len
    if n_plan and group <= MMA_MAX_ROWS:
        tile, clusters = tokens_per_tile(group) * group, kh * n_plan
    else:
        n_plan = 0
        tile = row_tile(rows, group, MMA_MAX_ROWS)
        clusters = b * kh * math.ceil(rows / tile)
    splits, _ = card_cluster_plan(clusters, n_blocks * page, device_index,
                                  MMA_PREFILL, hd, tile, pool)
    return tile, n_plan, splits


def launch_mma(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
               block_table: torch.Tensor,
               cache_len: Union[int, torch.Tensor], *, window: int = 0,
               softcap: Optional[float] = None,
               scale: Optional[float] = None, q_len: int = 1,
               plan: Optional[torch.Tensor] = None,
               k_scale: Optional[torch.Tensor] = None,
               v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The tensor-core kernel: bfloat16 q at hd 64, 128 or 256 over bf16 or
    8-bit pools, operands that keep cp.async's 16-byte rule; raises on
    anything else.  With ``plan`` (a (2, n) int32 ``tile_plan`` on the
    device, q_len 1) its entries are the row tiles (``_mma_geometry``)."""
    if route(q.dtype, q.shape[-1]) != "mma":
        raise ValueError(f"the mma kernel takes bfloat16 at hd "
                         f"{MMA_HEAD_DIMS[MMA_PREFILL]}, got {q.dtype} hd "
                         f"{q.shape[-1]}")
    b, kh, rows, hd, page, n_blocks, pool = check_paged(
        q, k_pool, v_pool, block_table, k_scale, v_scale)
    check_16_bytes("cp.async", q=q, k_pool=k_pool, v_pool=v_pool)
    _group(q, q_len)
    if plan is not None:
        if q_len != 1:
            raise ValueError(f"a tile plan takes q_len 1 rows, got q_len "
                             f"{q_len}")
        _check_plan(plan, q.device)
    tile, n_plan, splits = _mma_geometry(
        b, kh, rows, hd, page, n_blocks, q_len,
        0 if plan is None else plan.shape[1], q.device.index, pool)
    lens = device_lengths(cache_len, b, q.device)
    scale = scale if scale is not None else hd ** -0.5
    o = torch.empty((b, kh, rows, hd), dtype=q.dtype, device=q.device)
    ks, vs = k_pool.stride(), v_pool.stride()
    sc = scale_args(k_scale, v_scale)
    with torch.cuda.device(q.device):
        MMA_KERNEL(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                   *sc[:2], block_table.data_ptr(), lens.data_ptr(),
                   plan.data_ptr() if n_plan else 0, o.data_ptr(),
                   b, kh, rows, tile, q_len, n_blocks, page, hd,
                   *q.stride()[:3], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
                   *sc[2:], block_table.stride(0), kh * rows * hd, rows * hd,
                   hd, n_plan, plan.stride(0) if n_plan else 0, splits,
                   int(window), float(softcap or 0.0), float(scale), pool,
                   torch.cuda.current_stream().cuda_stream,
                   pool=pool_name(k_pool))
    return o


def paged_prefill_attention_cuda(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor,
                                 block_table: torch.Tensor,
                                 cache_len: Union[int, torch.Tensor], *,
                                 window: int = 0,
                                 softcap: Optional[float] = None,
                                 scale: Optional[float] = None,
                                 q_len: int = 1,
                                 q_blk: Optional[int] = None,
                                 plan: Optional[torch.Tensor] = None,
                                 k_scale: Optional[torch.Tensor] = None,
                                 v_scale: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """q: (B, KH, q_len·group, hd) token-major rows; k_pool, v_pool:
    (n_pages, KH, page, hd), any strides with a unit innermost one (the
    model's (n_pages, page, KH, hd) pools pass as ``transpose(1, 2)``
    views); ``k_scale``/``v_scale`` (n_pages, KH, page) f32 for int8/fp8
    pools; block_table: (B, P) int32; cache_len: int or () / (B,) int
    tensor of valid slots INCLUDING the chunk → (B, KH, q_len·group, hd),
    on the card, through the kernel ``route`` names.  ``q_blk`` is the
    CUDA-core kernel's sub-block, ``plan`` the tensor-core kernel's row
    tiles; each route ignores the other's."""
    sc = {"k_scale": k_scale, "v_scale": v_scale}
    if route(q.dtype, q.shape[-1]) == "mma":
        return launch_mma(q, k_pool, v_pool, block_table, cache_len,
                          window=window, softcap=softcap, scale=scale,
                          q_len=q_len, plan=plan, **sc)
    return launch_cuda_cores(q, k_pool, v_pool, block_table, cache_len,
                             window=window, softcap=softcap, scale=scale,
                             q_len=q_len, q_blk=q_blk, **sc)
