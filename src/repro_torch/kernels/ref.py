"""Plain PyTorch versions of the kernels on the port's path.

They mirror ``repro.kernels.ref`` function by function: the same layouts
(the model's (B, S, H, hd), and (n_pages, page, KH, hd) page pools),
float32 compute, and a cast back to the input dtype.  The paged versions
take fp pools only.  ``ops`` takes them for tensors on the CPU; the tests hold them
against the JAX oracles, and ``chip_smoke.py`` holds each CUDA kernel
against them on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def region_score(v: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """Eq. (2): K(x^r) = sum_i sum_j cos(V_i(x^r), E_j(T)).

    v: (B, R, Nv, D) visual tokens per region; e: (B, Ne, D) text tokens.
    Returns (B, R) float32.  Rows normalise as ``x / (||x|| + 1e-6)``."""
    vf, ef = v.float(), e.float()
    vn = vf / (torch.linalg.vector_norm(vf, dim=-1, keepdim=True) + 1e-6)
    en = ef / (torch.linalg.vector_norm(ef, dim=-1, keepdim=True) + 1e-6)
    return torch.einsum("brvd,bed->br", vn, en)


def _attn_mask(s_q: int, s_kv: int, window: int, causal: bool,
               q_offset: int, device) -> torch.Tensor:
    qi = torch.arange(s_q, device=device)[:, None] + q_offset
    kj = torch.arange(s_kv, device=device)[None, :]
    mask = torch.ones((s_q, s_kv), dtype=torch.bool, device=device)
    if causal:
        mask &= kj <= qi
    if window > 0:
        mask &= kj > qi - window
    return mask


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Skv, K, hd) with H % K == 0 → (B, Sq, H, hd).

    Causal alignment is bottom-right (``q_offset = Skv - Sq``), as in the
    JAX oracle."""
    b, sq, h, hd = q.shape
    skv, kh = k.shape[1], k.shape[2]
    group = h // kh
    scale = scale if scale is not None else hd ** -0.5
    qf = q.float().reshape(b, sq, kh, group, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) * scale
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    mask = _attn_mask(sq, skv, window, causal, skv - sq, q.device)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(b, sq, h, hd).to(q.dtype)


def _lengths(cache_len, b: int, device) -> torch.Tensor:
    return torch.as_tensor(cache_len, device=device).to(
        torch.int64).broadcast_to((b,))


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     cache_len, *, window: int = 0,
                     softcap: Optional[float] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, H, hd); k, v: (B, S, K, hd); cache_len: int, () or (B,)
    (valid cache slots incl. the current token) → (B, H, hd).  Masked
    columns contribute an explicit zero, so rows with ``cache_len == 0``
    output zeros."""
    return multi_decode_attention(q[:, None], k, v, cache_len, window=window,
                                  softcap=softcap, scale=scale)[:, 0]


def multi_decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           cache_len, *, window: int = 0,
                           softcap: Optional[float] = None,
                           scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, T, H, hd), a T-token chunk at logical positions
    ``cache_len - T .. cache_len - 1``; k, v: (B, S, KH, hd); cache_len:
    int, () or (B,) INCLUDING the chunk → (B, T, H, hd).  Chunk token ``t``
    attends to columns ``< cache_len - (T - 1 - t)``; rows whose effective
    length is <= 0 output zeros."""
    b, t, h, hd = q.shape
    s, kh = k.shape[1], k.shape[2]
    group = h // kh
    scale = scale if scale is not None else hd ** -0.5
    lens = _lengths(cache_len, b, q.device)
    qf = q.float().reshape(b, t, kh, group, hd)
    scores = torch.einsum("btkgd,bskd->bkgts", qf, k.float()) * scale
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    pos = torch.arange(s, device=q.device)[None, None, :]
    eff = lens[:, None] - (t - 1) + torch.arange(t, device=q.device)[None, :]
    valid = pos < eff[:, :, None]                              # (B, T, S)
    if window > 0:
        valid &= pos > (eff[:, :, None] - 1 - window)
    vmask = valid[:, None, None]                               # (B,1,1,T,S)
    scores = torch.where(vmask, scores, torch.full_like(scores, NEG_INF))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m) * vmask
    p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    o = torch.einsum("bkgts,bskd->btkgd", p, v.float())
    return o.reshape(b, t, h, hd).to(q.dtype)


def gather_pages(pool: torch.Tensor, block_table: torch.Tensor
                 ) -> torch.Tensor:
    """pool: (n_pages, page, ...); block_table: (B, P) int → (B, P·page,
    ...) dense per-row cache (logical position ``s`` of row ``b`` is
    ``pool[block_table[b, s // page], s % page]``)."""
    pages = pool[block_table.long()]                 # (B, P, page, ...)
    b, p, page = pages.shape[:3]
    return pages.reshape((b, p * page) + tuple(pool.shape[2:]))


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_table: torch.Tensor,
                           cache_len, *, window: int = 0,
                           softcap: Optional[float] = None,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Gather every row's pages into a dense (B, P·page, KH, hd) cache, then
    dense ragged decode.  q: (B, H, hd); k_pool, v_pool: (n_pages, page,
    KH, hd) fp pools; block_table: (B, P); cache_len: int, () or (B,)
    → (B, H, hd)."""
    return decode_attention(q, gather_pages(k_pool, block_table),
                            gather_pages(v_pool, block_table), cache_len,
                            window=window, softcap=softcap, scale=scale)


def paged_multi_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor,
                                 block_table: torch.Tensor, cache_len, *,
                                 window: int = 0,
                                 softcap: Optional[float] = None,
                                 scale: Optional[float] = None
                                 ) -> torch.Tensor:
    """The chunk-causal form: q (B, T, H, hd) at logical positions
    ``cache_len - T .. cache_len - 1`` (cache_len INCLUDING the chunk)
    → (B, T, H, hd)."""
    return multi_decode_attention(q, gather_pages(k_pool, block_table),
                                  gather_pages(v_pool, block_table),
                                  cache_len, window=window, softcap=softcap,
                                  scale=scale)


def paged_prefill_attention(q: torch.Tensor, k_pool: torch.Tensor,
                            v_pool: torch.Tensor, block_table: torch.Tensor,
                            cache_len, *, window: int = 0,
                            softcap: Optional[float] = None,
                            scale: Optional[float] = None) -> torch.Tensor:
    """The chunked-prefill prefix-append op: q (B, C, H, hd), a C-token
    chunk at logical positions ``cache_len - C .. cache_len - 1`` whose K/V
    the caller just wrote into the pools, attends causally to its own chunk
    and the committed prefix through the block table.  The same function as
    ``paged_multi_decode_attention``, kept as its own entry point as in the
    JAX package: the kernel beside it tiles the chunk axis.  Ragged engine
    rows (1-token rows, partial chunks, idle rows) differ only in their
    ``cache_len`` → (B, C, H, hd)."""
    return paged_multi_decode_attention(q, k_pool, v_pool, block_table,
                                        cache_len, window=window,
                                        softcap=softcap, scale=scale)
