"""Dispatch between the CUDA kernels and their plain versions.

The choice follows the tensors' device and nothing else: CPU tensors take
the plain version in ``ref.py``; CUDA tensors take the hand-written kernel,
which raises on what it does not take.  There is no knob a CUDA caller
could reach to get the plain version, and no fallback on failure.

This module owns what surrounds the kernels, as ``repro.kernels.ops`` does:
the layout changes (the models use (B, S, H, hd); the kernels want
(B, H, S, hd), and the (n_pages, page, KH, hd) page pools become
(n_pages, KH, page, hd), passed as strided views, no copy, as do an 8-bit
pool's (n_pages, page, KH) scales, (n_pages, KH, page)), the windowed
band-slice gather before dense decode, and the recurrent scans' zero
states.  It pads no head dim: the kernels take
hd <= 256 with hd % 4 == 0 as they are (``build.check_head_dim``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import paged_decode_attention as PDA
from repro_torch.kernels import paged_prefill_attention as PPA
from repro_torch.kernels import ref
from repro_torch.kernels import region_score as RS
from repro_torch.kernels import slstm_scan as SL
from repro_torch.kernels import ssm_scan as SS

KERNELS = {"flash_attention": FA.KERNEL,
           "flash_attention_wgmma": FA.WGMMA_KERNEL,
           "flash_attention_bwd": FA.BWD_KERNEL,
           "flash_attention_bwd_wgmma": FA.BWD_WGMMA_KERNEL,
           "decode_attention": DA.KERNEL,
           "decode_attention_mma": DA.MMA_KERNEL, "region_score": RS.KERNEL,
           "paged_decode_attention": PDA.KERNEL,
           "paged_decode_attention_mma": PDA.MMA_KERNEL,
           "paged_prefill_attention": PPA.KERNEL,
           "paged_prefill_attention_mma": PPA.MMA_KERNEL,
           "ssm_scan": SS.KERNEL, "ssm_scan_mma": SS.MMA_KERNEL,
           "slstm_scan": SL.KERNEL,
           "slstm_scan_cluster": SL.CLUSTER_KERNEL}
#: the kernels with two routes: {name: (the second route's key, its route,
#: the first route's)}
ROUTES = {
    "flash_attention": ("flash_attention_wgmma", "wgmma", "cuda_cores"),
    "flash_attention_bwd": ("flash_attention_bwd_wgmma", "wgmma",
                            "cuda_cores"),
    "decode_attention": ("decode_attention_mma", "mma", "cuda_cores"),
    "paged_decode_attention": ("paged_decode_attention_mma", "mma",
                               "cuda_cores"),
    "paged_prefill_attention": ("paged_prefill_attention_mma", "mma",
                                "cuda_cores"),
    "ssm_scan": ("ssm_scan_mma", "mma", "cuda_cores"),
    "slstm_scan": ("slstm_scan_cluster", "cluster", "per_row")}


#: the paged kernels, which also count their launches on 8-bit pools by
#: storage: ``launch_counts()["paged_decode_attention[int8]"]`` and so on
PAGED = ("paged_decode_attention", "paged_decode_attention_mma",
         "paged_prefill_attention", "paged_prefill_attention_mma")
QUANT_POOLS = ("int8", "fp8")
for _name in PAGED[::2]:
    for _pool in QUANT_POOLS:
        ROUTES[f"{_name}[{_pool}]"] = (f"{_name}_mma[{_pool}]", "mma",
                                       "cuda_cores")


def launch_counts() -> Dict[str, int]:
    """Launches per kernel since the last reset.  A kernel with two routes
    (``ROUTES``) counts every launch of either under its own name, and the
    second route alone under that route's key (``launches_by_route``
    splits them).  ``"<paged kernel>[int8]"`` / ``"[fp8]"`` count the
    paged kernels' launches on 8-bit pools the same way (both routes under
    the first route's name)."""
    counts = {name: k.launches for name, k in KERNELS.items()}
    for name in PAGED:
        for pool in QUANT_POOLS:
            counts[f"{name}[{pool}]"] = KERNELS[name].by_pool.get(pool, 0)
    for name, (key, _, _) in ROUTES.items():
        counts[name] += counts[key]
    return counts


def launches_by_route(counts: Dict[str, int], name: str) -> Dict[str, int]:
    """Launches of ``name`` in ``launch_counts()``'s result by route:
    {"wgmma" or "mma": n, "cuda_cores": n}, or for the sLSTM {"cluster": n,
    "per_row": n}."""
    key, second, first = ROUTES[name]
    return {second: counts[key], first: counts[name] - counts[key]}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.reset()


#: a kernel's counters: (launches, launches by pool storage)
LaunchState = Dict[str, Tuple[int, Dict[str, int]]]


def launch_state() -> LaunchState:
    """Every kernel's counters as they stand, for ``launch_delta`` and
    ``restore_launches``."""
    return {n: (k.launches, dict(k.by_pool)) for n, k in KERNELS.items()}


def restore_launches(state: LaunchState) -> None:
    for n, (launches, by_pool) in state.items():
        KERNELS[n].launches, KERNELS[n].by_pool = launches, dict(by_pool)


def launch_delta(before: LaunchState, after: LaunchState) -> LaunchState:
    """The launches made between two ``launch_state`` snapshots (kernels
    with none left out)."""
    out = {}
    for n, (launches, by_pool) in after.items():
        b, bp = before[n]
        pools = {p: c - bp.get(p, 0) for p, c in by_pool.items()
                 if c != bp.get(p, 0)}
        if launches != b or pools:
            out[n] = (launches - b, pools)
    return out


def add_launches(delta: LaunchState) -> None:
    """Count ``delta``'s launches as made: a replayed CUDA graph runs its
    kernels without their Python wrappers, so the replay counts for them
    what the wrappers counted while the graph was captured."""
    for n, (launches, by_pool) in delta.items():
        k = KERNELS[n]
        k.launches += launches
        for p, c in by_pool.items():
            k.by_pool[p] = k.by_pool.get(p, 0) + c


def _on_card(*ts: torch.Tensor) -> bool:
    kinds = {t.device.type for t in ts}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"operands on mixed or unsupported devices: {kinds}")


# ---------------------------------------------------------------------------
# region_score
# ---------------------------------------------------------------------------

def region_score(v: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """Eq. (2): v (B, R, Nv, D), e (B, Ne, D) → (B, R) float32."""
    if _on_card(v, e):
        return RS.region_score_cuda(v, e)
    return ref.region_score(v, e)


# ---------------------------------------------------------------------------
# flash attention, (B, S, H, hd) model layout
# ---------------------------------------------------------------------------

def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Skv, K, hd) → (B, Sq, H, hd).  Under
    autograd (grad enabled and an input that requires it) the call goes
    through ``FlashAttentionFn``, whose backward is the backward kernel on
    the card; otherwise it launches the forward alone, as in inference."""
    _on_card(q, k, v)           # refuses mixed devices on either path
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FA.FlashAttentionFn.apply(q, k, v, causal, window, softcap,
                                         scale)
    return FA.flash_attention_model_layout(q, k, v, causal=causal,
                                           window=window, softcap=softcap,
                                           scale=scale)


# ---------------------------------------------------------------------------
# decode attention (one query token per sequence)
# ---------------------------------------------------------------------------

CacheLen = Union[int, torch.Tensor]


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     cache_len: CacheLen, *, window: int = 0,
                     softcap: Optional[float] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, H, hd); k, v: (B, S, K, hd); cache_len: int, () or (B,) int
    (per-row valid-slot counts) → (B, H, hd)."""
    on_card = _on_card(q, k, v)
    b, h, hd = q.shape
    s, kh = k.shape[1], k.shape[2]
    if window > 0 and s > window:
        # band slice around each row's position: windowed decode touches
        # O(window) cache instead of O(S); a (B, window) gather, one band
        # per row (a scalar length gives every row the same band)
        lens = DA.device_lengths(cache_len, b, k.device).long()
        start = torch.clamp(lens - window, 0, s - window)
        rows = start[:, None] + torch.arange(window, device=k.device)
        bi = torch.arange(b, device=k.device)[:, None]
        k, v = k[bi, rows], v[bi, rows]
        cache_len = lens - start
    if not on_card:
        return ref.decode_attention(q, k, v, cache_len, window=window,
                                    softcap=softcap, scale=scale)
    o = DA.decode_attention_cuda(q.reshape(b, kh, h // kh, hd),
                                 k.transpose(1, 2), v.transpose(1, 2),
                                 cache_len, window=window, softcap=softcap,
                                 scale=scale)
    return o.reshape(b, h, hd)


# ---------------------------------------------------------------------------
# multi-token scoring (dense verify / prefill-append; q_len = T per row)
# ---------------------------------------------------------------------------

def _chunk_to_rows(q: torch.Tensor, kh: int) -> torch.Tensor:
    """(B, T, H, hd) → (B, KH, T·group, hd) token-major rows (row r ↦ chunk
    token r // group)."""
    b, t, h, hd = q.shape
    qg = q.reshape(b, t, kh, h // kh, hd).permute(0, 2, 1, 3, 4)
    return qg.reshape(b, kh, t * (h // kh), hd)


def _rows_to_chunk(o: torch.Tensor, t: int, h: int) -> torch.Tensor:
    b, kh, rows, hd = o.shape
    return (o.reshape(b, kh, t, rows // t, hd).permute(0, 2, 1, 3, 4)
            .reshape(b, t, h, hd))


def multi_decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           cache_len: CacheLen, *, window: int = 0,
                           softcap: Optional[float] = None,
                           scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, T, H, hd), a T-token chunk at logical positions
    ``cache_len - T .. cache_len - 1``, causal within the chunk; k, v:
    (B, S, K, hd); cache_len: int, () or (B,) INCLUDING the chunk
    → (B, T, H, hd)."""
    if not _on_card(q, k, v):
        return ref.multi_decode_attention(q, k, v, cache_len, window=window,
                                          softcap=softcap, scale=scale)
    b, t, h, hd = q.shape
    kh = k.shape[2]
    o = DA.decode_attention_cuda(_chunk_to_rows(q, kh), k.transpose(1, 2),
                                 v.transpose(1, 2), cache_len, window=window,
                                 softcap=softcap, scale=scale, q_len=t)
    return _rows_to_chunk(o, t, h)


# ---------------------------------------------------------------------------
# paged decode attention (page pools, per-row block tables)
# ---------------------------------------------------------------------------

def _scales(k_scale: Optional[torch.Tensor],
            v_scale: Optional[torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The model's (n_pages, page, KH) scales as the kernels' (n_pages, KH,
    page) views (JAX's ``_scale_to_kernel``); both or neither."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale come together")
    if k_scale is None:
        return {}
    return {"k_scale": k_scale.transpose(1, 2),
            "v_scale": v_scale.transpose(1, 2)}


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_table: torch.Tensor,
                           cache_len: CacheLen, *, window: int = 0,
                           softcap: Optional[float] = None,
                           scale: Optional[float] = None,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """q: (B, H, hd); k_pool, v_pool: (n_pages, page, K, hd) pools of q's
    dtype, or int8/fp8 with ``k_scale``/``v_scale`` (n_pages, page, K)
    f32; block_table: (B, P) int32 (physical page per logical block);
    cache_len: int, () or (B,) → (B, H, hd).  Shared prefix pages may
    appear in many rows' tables; the pools are only read."""
    if not _on_card(q, k_pool, v_pool, block_table):
        return ref.paged_decode_attention(q, k_pool, v_pool, block_table,
                                          cache_len, window=window,
                                          softcap=softcap, scale=scale,
                                          k_scale=k_scale, v_scale=v_scale)
    b, h, hd = q.shape
    kh = k_pool.shape[2]
    o = PDA.paged_decode_attention_cuda(
        q.reshape(b, kh, h // kh, hd), k_pool.transpose(1, 2),
        v_pool.transpose(1, 2), block_table, cache_len, window=window,
        softcap=softcap, scale=scale, **_scales(k_scale, v_scale))
    return o.reshape(b, h, hd)


def paged_multi_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor,
                                 block_table: torch.Tensor,
                                 cache_len: CacheLen, *, window: int = 0,
                                 softcap: Optional[float] = None,
                                 scale: Optional[float] = None,
                                 k_scale: Optional[torch.Tensor] = None,
                                 v_scale: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """The speculative verifier's scoring op: q (B, T, H, hd), a T = γ+1
    chunk causal within itself; pools, scales and table as
    ``paged_decode_attention``; cache_len INCLUDING the chunk
    → (B, T, H, hd)."""
    if not _on_card(q, k_pool, v_pool, block_table):
        return ref.paged_multi_decode_attention(
            q, k_pool, v_pool, block_table, cache_len, window=window,
            softcap=softcap, scale=scale, k_scale=k_scale, v_scale=v_scale)
    b, t, h, hd = q.shape
    kh = k_pool.shape[2]
    o = PDA.paged_decode_attention_cuda(
        _chunk_to_rows(q, kh), k_pool.transpose(1, 2),
        v_pool.transpose(1, 2), block_table, cache_len, window=window,
        softcap=softcap, scale=scale, q_len=t, **_scales(k_scale, v_scale))
    return _rows_to_chunk(o, t, h)


# ---------------------------------------------------------------------------
# paged prefix-append attention (chunked prefill; q_len = C per row)
# ---------------------------------------------------------------------------

def paged_prefill_attention(q: torch.Tensor, k_pool: torch.Tensor,
                            v_pool: torch.Tensor, block_table: torch.Tensor,
                            cache_len: CacheLen, *, window: int = 0,
                            softcap: Optional[float] = None,
                            scale: Optional[float] = None,
                            q_blk: Optional[int] = None,
                            plan: Optional[torch.Tensor] = None,
                            k_scale: Optional[torch.Tensor] = None,
                            v_scale: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """The chunked-prefill scoring op: q (B, C, H, hd), a C-token chunk
    whose K/V the caller just wrote at per-row (page, offset); pools,
    scales and table as ``paged_decode_attention``; cache_len INCLUDING
    the chunk
    → (B, C, H, hd).  Chunk token ``t`` sees columns
    ``< cache_len - (C - 1 - t)``.  Card only, and neither changes a
    row's result: ``q_blk`` is the CUDA-core kernel's sub-block of chunk
    tokens, ``plan`` (C 1) the tensor-core kernel's row tiles
    (``paged_prefill_attention.tile_plan``; rows in none are not
    written)."""
    if not _on_card(q, k_pool, v_pool, block_table):
        return ref.paged_prefill_attention(q, k_pool, v_pool, block_table,
                                           cache_len, window=window,
                                           softcap=softcap, scale=scale,
                                           k_scale=k_scale, v_scale=v_scale)
    b, t, h, hd = q.shape
    kh = k_pool.shape[2]
    o = PPA.paged_prefill_attention_cuda(
        _chunk_to_rows(q, kh), k_pool.transpose(1, 2),
        v_pool.transpose(1, 2), block_table, cache_len, window=window,
        softcap=softcap, scale=scale, q_len=t, q_blk=q_blk, plan=plan,
        **_scales(k_scale, v_scale))
    return _rows_to_chunk(o, t, h)


# ---------------------------------------------------------------------------
# chunked gated linear attention (model layout (B, S, H, d))
# ---------------------------------------------------------------------------

def ssm_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             log_g: torch.Tensor, state: Optional[torch.Tensor] = None, *,
             chunk: int = 64):
    """q, k: (B, S, H, dk); v: (B, S, H, dv); log_g: (B, S, H); state
    (B, H, dk, dv) or None (f32 zeros) → (o (B, S, H, dv), final_state
    f32)."""
    if not _on_card(q, k, v, log_g):
        return ref.ssm_scan(q, k, v, log_g, state, chunk=chunk)
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    if state is None:
        state = torch.zeros((b, h, dk, dv), dtype=torch.float32,
                            device=q.device)
    o, sf = SS.ssm_scan_cuda(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), log_g.transpose(1, 2),
                             state, chunk=chunk)
    return o.transpose(1, 2), sf


#: the O(1) per-token update; no kernel, as in the JAX package
ssm_decode_step = ref.ssm_decode_step


# ---------------------------------------------------------------------------
# sLSTM recurrence
# ---------------------------------------------------------------------------

def slstm_scan(gates_x: torch.Tensor, r: torch.Tensor, state=None):
    """gates_x: (B, S, 4d) [z|i|f|o]; r: (H, P, 4P); state: initial
    (h, c, n, m) each (B, H, P), or None (the zero start) → (h (B, S, d),
    final (h, c, n, m))."""
    if not _on_card(gates_x, r):
        return ref.slstm_scan(gates_x, r, state)
    return SL.slstm_scan_cuda(gates_x, r, state)
