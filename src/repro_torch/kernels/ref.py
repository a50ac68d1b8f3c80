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
``flash_attention_bwd`` is the plain version of the training backward
(the math of the JAX package's ``ref._fs_bwd``), ``flash_attention_lse``
of the forward's lse residual, ``flash_attention_bwd_abs`` the products
whose 2^-8 share bounds the wgmma backward's bf16 roundings.
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


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        softcap: Optional[float] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Each row's logsumexp of its scaled (capped) logits over its visible
    keys, m + log(max(l, 1e-30)) as the forward defines it: q (B, Sq, H,
    hd), k (B, Skv, KH, hd) → (B, H, Sq) float32.  The plain version of the
    wgmma forward's residual (the JAX package's ``_fs_fwd`` lse)."""
    b, sq, h, hd = q.shape
    lse = _flash_logits(q, k, causal, window, softcap, scale)[3]
    return lse.reshape(b, h, sq)


def _flash_logits(q, k, causal, window, softcap, scale):
    """The forward's logits in float32, in the (B, KH, G, Sq, Skv) score
    layout: (s capped, 1 − tanh² or None, the mask, lse (…, Sq, 1), q as
    (B, Sq, KH, G, hd), k, scale)."""
    b, sq, h, hd = q.shape
    skv, kh = k.shape[1], k.shape[2]
    scale = scale if scale is not None else hd ** -0.5
    qf = q.float().reshape(b, sq, kh, h // kh, hd)
    kf = k.float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, kf) * scale
    dcap = None
    if softcap is not None:
        t = torch.tanh(s / softcap)
        s = softcap * t
        dcap = 1.0 - t * t
    mask = _attn_mask(sq, skv, window, causal, skv - sq, q.device)
    sm = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = sm.amax(dim=-1, keepdim=True)
    lse = m + torch.log(torch.clamp((torch.exp(sm - m) * mask).sum(
        dim=-1, keepdim=True), min=1e-30))
    return s, dcap, mask, lse, qf, kf, scale


def _flash_bwd_parts(q, k, v, o, do, causal, window, softcap, scale):
    """The recompute both backward functions share, in float32: (p, ds,
    qf, kf, dof, scale) in the (B, KH, G, Sq, Skv) score layout."""
    s, dcap, mask, lse, qf, kf, scale = _flash_logits(q, k, causal, window,
                                                      softcap, scale)
    p = torch.where(mask, torch.exp(s - lse), torch.zeros_like(s))
    dof = do.float().reshape(qf.shape)
    delta = (dof * o.float().reshape(qf.shape)).sum(-1)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dof, v.float())
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    if dcap is not None:
        ds = ds * dcap
    return p, ds, qf, kf, dof, scale


def _flash_bwd_products(p, ds, qf, kf, dof, scale):
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, kf) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qf) * scale
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dof)
    return dq.reshape(dq.shape[0], dq.shape[1], -1, dq.shape[-1]), dk, dv


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        softcap: Optional[float] = None,
                        scale: Optional[float] = None):
    """The gradient of ``flash_attention`` at (q, k, v): given its output
    ``o`` and the output's gradient ``do`` (both (B, Sq, H, hd)), returns
    (dq, dk, dv) in the inputs' dtypes, computed in float32.

    The math of ``repro/kernels/ref.py::_fs_bwd`` (the JAX package's flash
    backward, a custom VJP): delta = rowsum(do·o); p recomputed from the
    row's logsumexp over its visible keys; ds = p·(dp − delta), times
    (1 − tanh²) under a softcap; dk and dv summed over each KV head's group.
    A row that sees no key gets p = 0 and so zero gradients, as the
    forward's ``max(l, 1e-30)`` division gives it a constant zero output."""
    dq, dk, dv = _flash_bwd_products(*_flash_bwd_parts(
        q, k, v, o, do, causal, window, softcap, scale))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_abs(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            do: torch.Tensor, *, causal: bool = True,
                            window: int = 0, softcap: Optional[float] = None,
                            scale: Optional[float] = None):
    """The backward's three products over absolute values, float32: A_dq =
    scale·|ds|·|k|, A_dk = scale·Σ_group |ds|ᵀ·|q|, A_dv = Σ_group pᵀ·|do|
    (p >= 0).  Rounding p and ds to bf16 before the products (the wgmma
    backward) moves each gradient by at most 2^-8 times its A."""
    p, ds, qf, kf, dof, scale = _flash_bwd_parts(q, k, v, o, do, causal,
                                                 window, softcap, scale)
    return _flash_bwd_products(p, ds.abs(), qf.abs(), kf.abs(), dof.abs(),
                               scale)


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

def _acc(dtype: torch.dtype) -> torch.dtype:
    """The plain scans' backward computes in f32, or in f64 where it is
    given f64 (a reference for the rounding of the f32 versions)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


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


def ssm_scan_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 log_g: torch.Tensor, state: Optional[torch.Tensor],
                 do: torch.Tensor, dstate_final: Optional[torch.Tensor] = None,
                 *, chunk: int = 64):
    """The backward of ``ssm_scan``: the cotangent ``do`` (B, S, H, dv) of o
    and ``dstate_final`` (B, H, dk, dv) of the final state (None: zero) →
    (dq, dk, dv, dlog_g in their inputs' dtypes, dstate (B, H, dk, dv)
    f32), the gradient of the same expression as the JAX oracle's, written
    out (no autograd).

    The chunk-start states are recomputed from ``state`` in a forward sweep;
    the reverse sweep carries dS, the gradient of the state after the chunk:
      dv_j = Σ_{i>=j} p_ij do_i + exp(T - cum_j)·dSᵀ k_j
      dq_i = exp(cum_i)·S_c do_i + Σ_{j<=i} b_ij k_j
      dk_j = Σ_{i>=j} b_ij q_i + exp(T - cum_j)·dS v_j
      dS  <- exp(T)·dS + Σ_i exp(cum_i) q_i do_iᵀ
    with p_ij = (q_i·k_j)·exp(cum_i - cum_j), b_ij = (do_i·v_j)·exp(cum_i -
    cum_j) for j <= i, the exponent masked before ``exp`` as in the forward.
    The decay's gradient needs no exponent: with c_t = Σ_{s<=t} log_g_s over
    the whole sequence, o depends on c through exp(c_t)·q_t and
    exp(-c_j)·k_j only, so dL/dc_t = q_t·dq_t - k_t·dk_t (the full
    gradients), plus <dS_F, S_F> at the last token from the final state's
    exp(c_T) factor; dlog_g is its reverse cumulative sum."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    chunk = chunk_for(s, chunk)
    f32 = _acc(q.dtype)

    def heads(x):
        return x.to(f32).transpose(1, 2)                  # (B, H, S, d)

    qh, kh, vh, doh = heads(q), heads(k), heads(v), heads(do)
    g = log_g.to(f32).transpose(1, 2)                     # (B, H, S)
    st = (torch.zeros((b, h, dk, dv), dtype=f32, device=q.device)
          if state is None else state.to(f32))
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=q.device))
    spans = [slice(c0, c0 + chunk) for c0 in range(0, s, chunk)]
    starts = []
    for sl in spans:                       # the chunk-start states
        cum = torch.cumsum(g[..., sl], dim=-1)
        total = cum[..., -1:]
        starts.append(st)
        kd = kh[:, :, sl] * torch.exp(total - cum)[..., None]
        st = torch.exp(total)[..., None] * st + kd.transpose(-1, -2) @ vh[
            :, :, sl]
    d_s = (torch.zeros_like(st) if dstate_final is None
           else dstate_final.to(f32))
    dq, dk_, dv_ = (torch.empty_like(x) for x in (qh, kh, vh))
    for sl, s_c in zip(reversed(spans), reversed(starts)):
        qi, ki, vi, doi = qh[:, :, sl], kh[:, :, sl], vh[:, :, sl], doh[
            :, :, sl]
        cum = torch.cumsum(g[..., sl], dim=-1)
        total = cum[..., -1:]
        decay = torch.exp(torch.where(
            tri, cum[..., :, None] - cum[..., None, :], float("-inf")))
        p = (qi @ ki.transpose(-1, -2)) * decay
        bm = (doi @ vi.transpose(-1, -2)) * decay
        ecum = torch.exp(cum)[..., None]
        wdec = torch.exp(total - cum)[..., None]
        dv_[:, :, sl] = p.transpose(-1, -2) @ doi + wdec * (ki @ d_s)
        dq[:, :, sl] = ecum * (doi @ s_c.transpose(-1, -2)) + bm @ ki
        dk_[:, :, sl] = (bm.transpose(-1, -2) @ qi
                         + wdec * (vi @ d_s.transpose(-1, -2)))
        d_s = (torch.exp(total)[..., None] * d_s
               + (qi * ecum).transpose(-1, -2) @ doi)
    dcum = (qh * dq).sum(-1) - (kh * dk_).sum(-1)          # (B, H, S)
    if dstate_final is not None:
        dcum[..., -1] += (dstate_final.to(f32) * st).sum((-1, -2))
    dlog_g = torch.flip(torch.cumsum(torch.flip(dcum, (-1,)), -1), (-1,))
    return (dq.transpose(1, 2).to(q.dtype), dk_.transpose(1, 2).to(k.dtype),
            dv_.transpose(1, 2).to(v.dtype),
            dlog_g.transpose(1, 2).to(log_g.dtype), d_s)


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


def _max_weight(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """d max(x, y) / dx as JAX takes it: 1 where x > y, 0.5 at a tie."""
    return torch.where(x > y, 1.0, torch.where(x == y, 0.5, 0.0))


def slstm_preactivations(gates_x: torch.Tensor, r: torch.Tensor, h0,
                         hs: torch.Tensor) -> torch.Tensor:
    """Every step's gate pre-activations (B, S, 4, H, P) f32 recomputed
    from the saved h sequence ``hs`` (B, S, d) and the initial h0 (B, H,
    P): gates_x + h_{t-1}·R[h], one product over all t."""
    b, s, _ = gates_x.shape
    heads, p_dim = r.shape[0], r.shape[1]
    f32 = _acc(gates_x.dtype)
    h_prev = torch.cat([h0.to(f32).reshape(b, 1, heads, p_dim),
                        hs.to(f32).reshape(b, s, heads, p_dim)[:, :-1]], 1)
    rec = torch.einsum("bshp,hpq->bshq", h_prev, r.to(f32))
    return (gates_x.to(f32).reshape(b, s, 4, heads, p_dim)
            + rec.reshape(b, s, heads, 4, p_dim).transpose(2, 3)), h_prev


def slstm_scan_bwd(gates_x: torch.Tensor, r: torch.Tensor, state,
                   hs: torch.Tensor, dh: torch.Tensor, dfinal=None):
    """The backward of ``slstm_scan``: from the forward's inputs, its h
    sequence ``hs`` (B, S, d), the cotangent ``dh`` (B, S, d) of hs and
    ``dfinal`` (of the final (h, c, n, m), each entry (B, H, P) or None;
    None: all zero) → (dgates_x (B, S, 4d) in gates_x's dtype, dr (H, P,
    4P) f32, dstate: the gradients of the initial (h, c, n, m), each (B, H,
    P) f32).  Written out, the gradient of the same expression as the JAX
    oracle's, m path and clamp included (``jnp.maximum`` gives a tie half
    to each side).

    The forward saves h alone: the pre-activations are recomputed from it
    in one product (``slstm_preactivations``), (c, n, m) by an elementwise
    forward sweep.  The reverse sweep per step, from the carried
    (dc, dn, dm) and dh_t + dg_{t+1}·R[h]ᵀ:
      h = o·c / max(n, 1e-6)        → do, dc, dn
      c = f'·c_p + i'·z, n = f'·n_p + i'  with i' = exp(i - m), f' =
      exp(log f + m_p - m), m = max(log f + m_p, i)
    then the four gates' pre-activation gradients dg_t, the carry to t - 1
    and dR = Σ_t h_{t-1}ᵀ dg_t, one product."""
    b, s, d4 = gates_x.shape
    heads, p_dim = r.shape[0], r.shape[1]
    f32 = _acc(gates_x.dtype)
    if state is None:
        state = slstm_zero_state(b, heads, p_dim, gates_x.device)
    h0, c0, n0, m0 = (x.to(f32).reshape(b, heads, p_dim) for x in state)
    g, h_prev = slstm_preactivations(gates_x, r, h0, hs)
    zt, ii = torch.tanh(g[:, :, 0]), g[:, :, 1]
    log_f, ot = log_sigmoid(g[:, :, 2]), torch.sigmoid(g[:, :, 3])
    c, n, m = c0, n0, m0
    cs, ns, ms = [c0], [n0], [m0]          # the state before each step
    for t in range(s):
        m_new = torch.maximum(log_f[:, t] + m, ii[:, t])
        i_p = torch.exp(ii[:, t] - m_new)
        f_p = torch.exp(log_f[:, t] + m - m_new)
        c = f_p * c + i_p * zt[:, t]
        n = f_p * n + i_p
        m = m_new
        cs.append(c)
        ns.append(n)
        ms.append(m)
    dfinal = dfinal or (None,) * 4
    zero = torch.zeros_like(c0)
    dh_f, dc, dn, dm = (zero if x is None
                        else x.to(f32).reshape(b, heads, p_dim)
                        for x in dfinal)
    dhs = dh.to(f32).reshape(b, s, heads, p_dim)
    rf = r.to(f32)
    dg = torch.empty_like(g)
    d_rec = dh_f
    for t in range(s - 1, -1, -1):
        c_p, n_p, m_p = cs[t], ns[t], ms[t]
        c, n, m = cs[t + 1], ns[t + 1], ms[t + 1]
        dht = dhs[:, t] + d_rec
        nc = torch.clamp(n, min=1e-6)
        d_o = dht * c / nc
        dc = dc + dht * ot[:, t] / nc
        dn = dn - dht * ot[:, t] * c / (nc * nc) * _max_weight(
            n, torch.full_like(n, 1e-6))
        a = log_f[:, t] + m_p
        i_p = torch.exp(ii[:, t] - m)
        f_p = torch.exp(a - m)
        dz = dc * i_p
        d_ip = (dc * zt[:, t] + dn) * i_p
        d_fp = (dc * c_p + dn * n_p) * f_p
        dm = dm - d_ip - d_fp
        w_a = _max_weight(a, ii[:, t])
        da = d_fp + dm * w_a
        dii = d_ip + dm * (1.0 - w_a)
        dg[:, t, 0] = dz * (1.0 - zt[:, t] * zt[:, t])
        dg[:, t, 1] = dii
        dg[:, t, 2] = da * torch.sigmoid(-g[:, t, 2])
        dg[:, t, 3] = d_o * ot[:, t] * (1.0 - ot[:, t])
        d_rec = torch.einsum("bhq,hpq->bhp",
                             dg[:, t].transpose(1, 2).reshape(
                                 b, heads, 4 * p_dim), rf)
        dc, dn, dm = dc * f_p, dn * f_p, da
    dg_h = dg.transpose(2, 3).reshape(b, s, heads, 4 * p_dim)
    dr = torch.einsum("bshp,bshq->hpq", h_prev, dg_h)
    return (dg.reshape(b, s, d4).to(gates_x.dtype), dr,
            (d_rec, dc, dn, dm))
