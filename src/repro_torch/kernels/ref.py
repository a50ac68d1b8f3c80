"""Plain PyTorch versions of the kernels on the port's path.

They mirror ``repro.kernels.ref`` function by function: the same layouts
(the model's (B, S, H, hd), and (n_pages, page, KH, hd) page pools),
float32 compute, and a cast back to the input dtype.  The paged versions
take int8 and fp8 pools with their per-(page, slot, head) scales as the
JAX oracles do: dequantize the whole pool, then gather.  ``ssm_scan``
differs from its JAX oracle on purpose (ROADMAP §3): it masks the decay
exponent before ``exp`` (the oracle's ``exp(cum_i - cum_j)`` overflows for
j > i under strong decay and gives ``inf·0 = NaN``); ``slstm_scan``
follows its oracle, which takes an initial state (the Pallas kernel does
not).  ``ops`` takes them for
tensors on the CPU; the tests hold them against the JAX oracles, and
``chip_smoke.py`` holds each CUDA kernel against them on the card.
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


def dequantize_pool(pool: torch.Tensor, scale: Optional[torch.Tensor]
                    ) -> torch.Tensor:
    """int8/fp8 pool (n_pages, page, KH, hd) × per-slot scales (n_pages,
    page, KH) → f32; a ``None`` scale passes an fp pool through.  The
    defining semantics of the quantized paged kernels, which apply the same
    multiply to each fetched key."""
    if scale is None:
        return pool
    return pool.float() * scale[..., None]


def _paged_kv(k_pool, v_pool, block_table, k_scale, v_scale):
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale come together")
    return (gather_pages(dequantize_pool(k_pool, k_scale), block_table),
            gather_pages(dequantize_pool(v_pool, v_scale), block_table))


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_table: torch.Tensor,
                           cache_len, *, window: int = 0,
                           softcap: Optional[float] = None,
                           scale: Optional[float] = None,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Gather every row's pages into a dense (B, P·page, KH, hd) cache, then
    dense ragged decode.  q: (B, H, hd); k_pool, v_pool: (n_pages, page,
    KH, hd); block_table: (B, P); cache_len: int, () or (B,) → (B, H, hd).
    ``k_scale``/``v_scale`` (n_pages, page, KH) f32: int8/fp8 pools,
    dequantized up front."""
    k, v = _paged_kv(k_pool, v_pool, block_table, k_scale, v_scale)
    return decode_attention(q, k, v, cache_len, window=window,
                            softcap=softcap, scale=scale)


def paged_multi_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor,
                                 block_table: torch.Tensor, cache_len, *,
                                 window: int = 0,
                                 softcap: Optional[float] = None,
                                 scale: Optional[float] = None,
                                 k_scale: Optional[torch.Tensor] = None,
                                 v_scale: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """The chunk-causal form: q (B, T, H, hd) at logical positions
    ``cache_len - T .. cache_len - 1`` (cache_len INCLUDING the chunk)
    → (B, T, H, hd); scales as ``paged_decode_attention``."""
    k, v = _paged_kv(k_pool, v_pool, block_table, k_scale, v_scale)
    return multi_decode_attention(q, k, v, cache_len, window=window,
                                  softcap=softcap, scale=scale)


def paged_prefill_attention(q: torch.Tensor, k_pool: torch.Tensor,
                            v_pool: torch.Tensor, block_table: torch.Tensor,
                            cache_len, *, window: int = 0,
                            softcap: Optional[float] = None,
                            scale: Optional[float] = None,
                            k_scale: Optional[torch.Tensor] = None,
                            v_scale: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
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
                                        softcap=softcap, scale=scale,
                                        k_scale=k_scale, v_scale=v_scale)


# ---------------------------------------------------------------------------
# ssm_scan: chunked gated linear attention (Mamba-2 SSD / mLSTM core)
# ---------------------------------------------------------------------------

def chunk_for(s: int, chunk: int) -> int:
    """The JAX package's rule: ``min(chunk, s)``, which must divide s."""
    chunk = min(chunk, s)
    if chunk < 1 or s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"chunk {chunk}")
    return chunk


def ssm_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             log_g: torch.Tensor, state: Optional[torch.Tensor] = None, *,
             chunk: int = 64):
    """Gated linear attention: S_t = exp(g_t)·S_{t-1} + k_t v_tᵀ,
    o_t = S_tᵀ q_t.

    q, k: (B, S, H, dk); v: (B, S, H, dv); log_g: (B, S, H) per-token log
    decay (<= 0); state: (B, H, dk, dv) initial state (None: zeros).
    Returns (o (B, S, H, dv) in q's dtype, final_state f32).  The chunk form
    of the JAX oracle: in each chunk, decay-masked q·kᵀ and score·v; across
    chunks, a (dk, dv) f32 state.  The pairwise exponent ``cum_i - cum_j`` is
    masked to -inf above the diagonal BEFORE ``exp``, so a chunk whose summed
    decay passes ~88 stays finite."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    chunk = chunk_for(s, chunk)
    f32 = torch.float32
    st = (torch.zeros((b, h, dk, dv), dtype=f32, device=q.device)
          if state is None else state.to(f32))
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=q.device))
    outs = []
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        qi = q[:, sl].to(f32).transpose(1, 2)             # (B, H, C, dk)
        ki = k[:, sl].to(f32).transpose(1, 2)
        vi = v[:, sl].to(f32).transpose(1, 2)             # (B, H, C, dv)
        cum = torch.cumsum(log_g[:, sl].to(f32).transpose(1, 2), dim=-1)
        total = cum[..., -1:]
        o_inter = (qi * torch.exp(cum)[..., None]) @ st
        diff = torch.where(tri, cum[..., :, None] - cum[..., None, :],
                           float("-inf"))
        scores = (qi @ ki.transpose(-1, -2)) * torch.exp(diff)
        o_intra = scores @ vi
        kd = ki * torch.exp(total - cum)[..., None]
        st = torch.exp(total)[..., None] * st + kd.transpose(-1, -2) @ vi
        outs.append((o_inter + o_intra).transpose(1, 2))
    return torch.cat(outs, dim=1).to(q.dtype), st


def ssm_decode_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    log_g: torch.Tensor, state: torch.Tensor):
    """Single-token recurrence. q, k: (B, H, dk); v: (B, H, dv); log_g:
    (B, H); state: (B, H, dk, dv) → (o (B, H, dv) in q's dtype, new state
    f32).  No kernel: an O(1) update per token, as in the JAX package."""
    f32 = torch.float32
    st = torch.exp(log_g.to(f32))[..., None, None] * state.to(f32)
    st = st + k.to(f32)[..., :, None] * v.to(f32)[..., None, :]
    o = torch.einsum("bhd,bhdv->bhv", q.to(f32), st)
    return o.to(q.dtype), st


# ---------------------------------------------------------------------------
# slstm_scan: the stabilised sLSTM recurrence
# ---------------------------------------------------------------------------

def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``-softplus(-x)``, as ``jax.nn.log_sigmoid``: finite for x << 0,
    where ``log(sigmoid(x))`` gives -inf."""
    return -torch.nn.functional.softplus(-x)


def slstm_zero_state(b: int, heads: int, p_dim: int, device):
    """The zero start of the JAX oracle and Pallas kernel: h = c = m = 0,
    n = 1e-6, each (B, H, P) f32."""
    z = torch.zeros((b, heads, p_dim), dtype=torch.float32, device=device)
    return z, z, z + 1e-6, z


def slstm_scan(gates_x: torch.Tensor, r: torch.Tensor, state=None):
    """gates_x: (B, S, 4d) input pre-activations, blocks [z|i|f|o], each
    h-major (H, P); r: (H, P, 4P) block-diagonal recurrent weights (per-head
    output [z|i|f|o]); state: the initial (h, c, n, m), each (B, H, P), or
    None for the zero start.  Returns (h (B, S, d) in gates_x's dtype, final
    (h, c, n, m) each (B, H, P) f32)."""
    b, s, d4 = gates_x.shape
    heads, p_dim = r.shape[0], r.shape[1]
    f32 = torch.float32
    if state is None:
        state = slstm_zero_state(b, heads, p_dim, gates_x.device)
    h, c, n, m = (x.to(f32) for x in state)
    rf = r.to(f32)
    gx = gates_x.to(f32).reshape(b, s, 4, heads, p_dim)
    hs = []
    for t in range(s):
        rec = torch.einsum("bhp,hpq->bhq", h, rf)            # (B, H, 4P)
        g = gx[:, t] + rec.reshape(b, heads, 4, p_dim).transpose(1, 2)
        zt = torch.tanh(g[:, 0])
        ii = g[:, 1]
        log_f = log_sigmoid(g[:, 2])
        ot = torch.sigmoid(g[:, 3])
        m_new = torch.maximum(log_f + m, ii)
        i_p = torch.exp(ii - m_new)
        f_p = torch.exp(log_f + m - m_new)
        c = f_p * c + i_p * zt
        n = f_p * n + i_p
        h = ot * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(h)
    out = torch.stack(hs, dim=1).reshape(b, s, d4 // 4)
    return out.to(gates_x.dtype), (h, c, n, m)
