"""Flash-decoding over a dense cache: the wrapper around its two CUDA
kernels.

The group's ``q_len·group`` token-major query rows of one (batch row, KV
head) share every K/V tile; per-row ``cache_len`` (B,) (a scalar
broadcasts); rows with ``cache_len == 0`` output zeros.  ``q_len > 1``
scores a chunk causally within the chunk (chunk token ``t`` sees columns
``< cache_len - (q_len - 1 - t)``), the dense verify / prefill-append form.
Any row count: rows past one block's capacity go to further row tiles on
the grid (``row_tile``, whole chunk tokens a tile), each row keeping its
index in the chunk for the mask.

Two routes, chosen by ``route`` from the dtype and head dim alone:

* ``"mma"``: bfloat16 at hd 64, 128 or 256 (the models' decode, gemma3-1b's
  256 included) goes to ``csrc/decode_attention_mma.cu``: one launch, the
  key splits of a (batch row, KV head, row tile) one thread-block cluster
  merging through distributed shared memory, K/V through a cp.async ring,
  QK^T and PV on ``mma.sync``.  cp.async needs 16-byte aligned bases and
  strides; operands that break the rule raise here, they never take the
  other route.  p is rounded to bf16 before PV.
* ``"cuda_cores"``: float32 and every other head dim (hd <= 256,
  hd % 4 == 0: the proxies' 12 and 16) go to ``csrc/decode_attention.cu``:
  split-K blocks, f32 math on the CUDA cores, and a combine kernel.

Each mode of the tensor-core kernel names its head dims
(``MMA_HEAD_DIMS``; all three take 64, 128 and 256), so each wrapper has
its own rule: this one, the paged decode's and prefix-append's, each
through ``mma_route``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, List, Optional, Tuple, Union

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import (DTYPES, CudaKernel, check_16_bytes,
                                       check_head_dim, check_operands)

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
KERNEL = CudaKernel("decode_attention.cu", "decode_attention_fwd",
                    [_P] * 7 + [_I] * 7 + [_L] * 12
                    + [_I, _I, _I, _F, _F, _I, _P])
MMA_KERNEL = CudaKernel("decode_attention_mma.cu", "decode_attention_mma_fwd",
                        [_P] * 5 + [_I] * 7 + [_L] * 12
                        + [_I, _I, _I, _F, _F, _P])
KV_TILE = 64          # keys per shared-memory tile; splits are multiples
MAX_ROWS = 32         # query rows of one CUDA-core row tile
MMA_MAX_ROWS = 64     # query rows of one tensor-core row tile (4 x 16)
BLOCKS_PER_SM = 2     # CUDA-core split-K target: about this many blocks an SM
MAX_CLUSTER = 16      # key splits per cluster on the tensor-core route
#: the tensor-core kernel's modes (its ``MODE`` template argument)
MMA_DENSE, MMA_PAGED, MMA_PREFILL = 0, 1, 2
#: the head dims each mode has instances for (the C entry points refuse the
#: rest): since the paged mode's hd-256 instances, the same for all three
MMA_HEAD_DIMS = {MMA_DENSE: (64, 128, 256), MMA_PAGED: (64, 128, 256),
                 MMA_PREFILL: (64, 128, 256)}


def mma_route(dtype: torch.dtype, hd: int, mode: int) -> str:
    """The kernel a (dtype, head dim) takes in the tensor-core kernel's
    ``mode``: ``"mma"`` for bfloat16 at the mode's ``MMA_HEAD_DIMS``,
    ``"cuda_cores"`` for float32 and other head dims; any other dtype
    raises."""
    if dtype not in DTYPES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {dtype}")
    if dtype == torch.bfloat16 and hd in MMA_HEAD_DIMS[mode]:
        return "mma"
    return "cuda_cores"


def route(dtype: torch.dtype, hd: int) -> str:
    """Dense decode's route: ``"mma"`` for bfloat16 at hd 64, 128 or 256,
    ``"cuda_cores"`` for float32 and other head dims."""
    return mma_route(dtype, hd, MMA_DENSE)


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
    if (cache_len.dtype == torch.int32 and cache_len.shape == (b,)
            and cache_len.is_contiguous()):
        return cache_len               # as the engine passes it: no view
    return cache_len.to(torch.int32).broadcast_to((b,)).contiguous()


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def row_tile(rows: int, group: int, max_rows: int) -> int:
    """Query rows per row tile: as many whole chunk tokens (``group`` rows
    each) as ``max_rows`` holds, ``max_rows`` when one token's group is
    larger, never more than ``rows``.  The kernels mask each row by its
    index in the whole chunk, so any tile size gives the same result."""
    per = (max_rows // group) * group if group <= max_rows else max_rows
    return min(per, rows)


def row_tiles(rows: int, group: int, max_rows: int) -> List[Tuple[int, int]]:
    """The (first, end) query rows of each row tile, in grid order."""
    t = row_tile(rows, group, max_rows)
    return [(r0, min(r0 + t, rows)) for r0 in range(0, rows, t)]


def split_plan(b: int, kh: int, s: int, sm_count: int):
    """(splits, split_len) of the CUDA-core kernel: enough KV splits of
    whole tiles that B·KH·splits blocks fill about ``BLOCKS_PER_SM`` blocks
    per SM.  The last split may be shorter; the kernel clips every split at
    S."""
    n_tiles = math.ceil(s / KV_TILE)
    want = math.ceil(BLOCKS_PER_SM * sm_count / max(b * kh, 1))
    per = math.ceil(n_tiles / min(max(want, 1), n_tiles))
    return math.ceil(n_tiles / per), per * KV_TILE


def cluster_plan(clusters: int, s: int,
                 fits: Callable[[int], int]) -> Tuple[int, int]:
    """(splits, split_len) of the tensor-core kernel: one cluster per
    (batch row, KV head, row tile), ``splits`` blocks in it (at most
    ``MAX_CLUSTER`` and the cache's 64-key tiles), each over ``split_len``
    keys (whole tiles): the most splits whose ``clusters`` all fit on the
    card at once (``fits(n)``: how many clusters of n blocks it holds), so
    no cluster waits for a second wave, which costs more than the splits
    save; one if none fit.  No split is empty of cache slots (the last may
    be shorter); the kernel clips every split at S and at each row's
    length, and prefix-append's splits share each row tile's own keys."""
    n_tiles = math.ceil(s / KV_TILE)
    want = max((n for n in range(1, min(MAX_CLUSTER, n_tiles) + 1)
                if clusters <= fits(n)), default=1)
    per = math.ceil(n_tiles / want)
    return math.ceil(n_tiles / per), per * KV_TILE


@functools.lru_cache(maxsize=None)
def max_clusters(device_index: int, mode: int, hd: int, tile_rows: int,
                 splits: int, pool: int = DTYPES[torch.bfloat16]) -> int:
    """How many clusters of ``splits`` blocks of the tensor-core kernel in
    ``mode`` (``MMA_DENSE`` / ``MMA_PAGED`` / ``MMA_PREFILL``) at ``hd``,
    row tiles of ``tile_rows`` and KV storage ``pool`` (bf16's code, or
    ``build.POOL_DTYPES``' for the paged modes' 8-bit pools) the card
    holds at once (``cudaOccupancyMaxActiveClusters``)."""
    fn = build.load(MMA_KERNEL.source).decode_attention_mma_max_clusters
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    n = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = fn(mode, hd, tile_rows, splits, pool, ctypes.byref(n))
    if err:
        raise RuntimeError(f"decode_attention_mma_max_clusters: CUDA error "
                           f"{err}")
    return n.value


@functools.lru_cache(maxsize=None)
def card_cluster_plan(clusters: int, s: int, device_index: int, mode: int,
                      hd: int, tile_rows: int,
                      pool: int = DTYPES[torch.bfloat16]) -> Tuple[int, int]:
    """``cluster_plan`` on the card's own occupancy for the kernel instance
    a launch runs, computed once per launch geometry."""
    return cluster_plan(clusters, s, functools.partial(
        max_clusters, device_index, mode, hd, tile_rows, pool=pool))


def _operands(q, k, v, q_len):
    check_operands(q, k, v)
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    b, kh, rows, hd = q.shape
    if k.shape[:2] != (b, kh) or k.shape[3] != hd:
        raise ValueError("k/v must be (B, KH, S, hd) matching q")
    if q_len < 1 or rows < 1 or rows % q_len:
        raise ValueError(f"rows {rows} must be q_len·group with q_len "
                         f"{q_len}")
    check_head_dim(hd)
    if k.shape[2] < 1:
        raise ValueError("empty cache")
    return b, kh, rows, hd, k.shape[2]


def launch_cuda_cores(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      cache_len: Union[int, torch.Tensor], *,
                      window: int = 0, softcap: Optional[float] = None,
                      scale: Optional[float] = None,
                      q_len: int = 1) -> torch.Tensor:
    """The CUDA-core kernel, on any input it takes (float32 or bfloat16,
    hd <= 256, hd % 4 == 0)."""
    b, kh, rows, hd, s = _operands(q, k, v, q_len)
    lens = device_lengths(cache_len, b, q.device)
    scale = scale if scale is not None else hd ** -0.5
    tile = row_tile(rows, rows // q_len, MAX_ROWS)
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
               b, kh, rows, tile, q_len, s, hd,
               *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               *o.stride()[:3],
               splits, split_len, int(window), float(softcap or 0.0),
               float(scale), DTYPES[q.dtype], stream)
    return o


def launch_mma(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               cache_len: Union[int, torch.Tensor], *, window: int = 0,
               softcap: Optional[float] = None,
               scale: Optional[float] = None,
               q_len: int = 1) -> torch.Tensor:
    """The tensor-core kernel: bfloat16 at hd 64, 128 or 256, operands that
    keep cp.async's 16-byte rule; raises on anything else."""
    if route(q.dtype, q.shape[-1]) != "mma":
        raise ValueError(f"the mma kernel takes bfloat16 at hd "
                         f"{MMA_HEAD_DIMS[MMA_DENSE]}, got {q.dtype} hd "
                         f"{q.shape[-1]}")
    b, kh, rows, hd, s = _operands(q, k, v, q_len)
    check_16_bytes("cp.async", q=q, k=k, v=v)
    lens = device_lengths(cache_len, b, q.device)
    scale = scale if scale is not None else hd ** -0.5
    tile = row_tile(rows, rows // q_len, MMA_MAX_ROWS)
    splits, split_len = card_cluster_plan(b * kh * math.ceil(rows / tile), s,
                                          q.device.index, MMA_DENSE, hd, tile)
    o = torch.empty((b, kh, rows, hd), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        MMA_KERNEL(q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
                   o.data_ptr(), b, kh, rows, tile, q_len, s, hd,
                   *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                   *o.stride()[:3], splits, split_len, int(window),
                   float(softcap or 0.0), float(scale),
                   torch.cuda.current_stream().cuda_stream)
    return o


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          cache_len: Union[int, torch.Tensor], *,
                          window: int = 0, softcap: Optional[float] = None,
                          scale: Optional[float] = None,
                          q_len: int = 1) -> torch.Tensor:
    """q: (B, KH, q_len·group, hd) token-major rows; k, v: (B, KH, S, hd);
    cache_len: int or () / (B,) int tensor of valid slots INCLUDING the
    chunk → (B, KH, q_len·group, hd), on the card, through the kernel
    ``route`` names."""
    launch = (launch_mma if route(q.dtype, q.shape[-1]) == "mma"
              else launch_cuda_cores)
    return launch(q, k, v, cache_len, window=window, softcap=softcap,
                  scale=scale, q_len=q_len)
