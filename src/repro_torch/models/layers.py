"""Model building blocks of the port (PyTorch; params are dicts of tensors).

The ported slice of ``repro.models.layers``: RMSNorm, RoPE with
Qwen2-VL's M-RoPE sections, GQA attention backed by the flash, decode and
paged-decode and paged prefix-append kernels (modes ``"train"``, no cache,
differentiable through the flash backward; ``"prefill"``, ``"decode"``,
``"verify"`` and ``"prefill_append"``, over a dense cache or a page pool
through a block table), the SwiGLU MLP, the recurrent mixers: mLSTM and
Mamba-2's SSD (the chunked scan kernel in prefill, the O(1) update in
decode) and sLSTM (the recurrence kernel in both), and Hymba's hybrid
mixer (attention and Mamba side by side on the same input), modes
``"prefill"`` and ``"decode"`` (the scans' ``"train"`` mode waits for
their backward and raises).  Page pools may be int8 or fp8 (e4m3) with
per-(page, slot, head) scales (``kernels/kv_quant.py``).  MoE is not
ported yet and raises.  Attention's output projection and the MLP's down
projection end in the tensor-parallel all-reduce hooks
(``distributed.collectives``), identity outside a serving ``tp_context``.

Unlike the JAX package, which is functional, attention writes the KV cache
in place and the recurrent mixers copy their final states into the cache
they were given; both return the same cache object. Where the JAX scatter
drops a write past the end of a cache (a finished slot whose index ran past
its capacity), the port clamps it onto the row's last slot (dense) or the
last table entry (paged); such rows are inactive, their table rows name the
trash page, and nothing reads what they write. That rule does not cover the
padding tokens of ``"prefill_append"`` (past a row's ``chunk_lens``), whose
rows may map published shared prefix pages: their paged writes go to the
trash page ``TRASH_PAGE``, and dense ones keep the old values.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import collectives
from repro_torch.kernels import kv_quant, ops
from repro_torch.kernels.ref import log_sigmoid

Params = Dict[str, Any]
Index = Union[int, torch.Tensor]
#: the pool page nothing reads (``serving.kv_pool.TRASH_PAGE``): the paged
#: writes of padding tokens land there
TRASH_PAGE = 0


# ---------------------------------------------------------------------------
# Common helpers
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * (1.0 + w.float())).to(x.dtype)


def dense_init(gen: torch.Generator, fan_in: int, shape, dtype,
               device) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return (w * fan_in ** -0.5).to(dtype)


# ---------------------------------------------------------------------------
# Rotary embeddings (RoPE + Qwen2-VL M-RoPE)
# ---------------------------------------------------------------------------

def rope_angles(positions: torch.Tensor, head_dim: int, theta: float,
                mrope_sections: Optional[Tuple[int, int, int]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions: (B, S) or (3, B, S) for M-RoPE → cos, sin of (B, S, hd/2).

    M-RoPE: frequency ``j`` of the half dim takes its angle from position
    stream ``i`` (temporal, height, width) for the ``i``-th section."""
    half = head_dim // 2
    inv_freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                       device=positions.device) / half)
    ang = positions.float()[..., None] * inv_freq
    if positions.dim() == 3:
        assert mrope_sections is not None and sum(mrope_sections) == half
        parts, start = [], 0
        for i, n in enumerate(mrope_sections):
            parts.append(ang[i, ..., start:start + n])
            start += n
        ang = torch.cat(parts, dim=-1)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: (B, S, H, hd); cos/sin: (B, S, hd/2); computed in float32."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    c = cos[:, :, None, :].float()
    s = sin[:, :, None, :].float()
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention mixer
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: ArchConfig, device) -> Params:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.num_heads * hd, cfg.num_kv_heads * hd
    dt = getattr(torch, cfg.dtype)
    p = {
        "wq": dense_init(gen, d, (d, nq), dt, device),
        "wk": dense_init(gen, d, (d, nkv), dt, device),
        "wv": dense_init(gen, d, (d, nkv), dt, device),
        "wo": dense_init(gen, nq, (nq, d), dt, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((hd,), dtype=dt, device=device)
        p["k_norm"] = torch.zeros((hd,), dtype=dt, device=device)
    return p


def init_attn_cache(cfg: ArchConfig, batch: int, max_len: int, dtype,
                    device) -> Params:
    shape = (batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_paged_attn_cache(cfg: ArchConfig, n_pages: int, page_size: int,
                          dtype, device, kv_dtype: Optional[str] = None
                          ) -> Params:
    """Paged KV layout: a pool of fixed-size pages (n_pages, page, KH, hd)
    shared by all sequences; per-row block tables (passed to ``attention``)
    resolve logical positions to (page, offset).

    ``kv_dtype="int8"`` / ``"fp8"`` (e4m3) store the pools quantized, with
    per-(page, slot, head) f32 scales beside them (``k_scale`` /
    ``v_scale``, (n_pages, page, KH)): the write paths quantize each token
    on its own and the paged kernels read the stored bytes and scales, so
    no committed slot is ever requantized."""
    shape = (n_pages, page_size, cfg.num_kv_heads, cfg.resolved_head_dim)
    if kv_dtype is None:
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    try:
        qdtype = kv_quant.KV_DTYPES[kv_dtype]
    except KeyError:
        raise ValueError(
            f"unknown kv_dtype {kv_dtype!r} (None, 'int8' or 'fp8')")
    return {"k": torch.zeros(shape, dtype=qdtype, device=device),
            "v": torch.zeros(shape, dtype=qdtype, device=device),
            "k_scale": torch.zeros(shape[:3], dtype=torch.float32,
                                   device=device),
            "v_scale": torch.zeros(shape[:3], dtype=torch.float32,
                                   device=device)}


def put_pool(leaf: torch.Tensor, index, x: torch.Tensor) -> None:
    """``leaf[index] = x`` for a pool leaf of any storage: an fp8 pool
    takes its bytes through a ``uint8`` view of both sides (the same
    bits), as a scatter into float8 is not offered on every device."""
    if leaf.dtype == kv_quant.FP8_DTYPE:
        leaf.view(torch.uint8)[index] = x.view(torch.uint8)
    else:
        leaf[index] = x


def quantize_leaves(pool: Params, k: torch.Tensor, v: torch.Tensor
                    ) -> Params:
    """Token K/V as the pool stores them: as they are for an fp pool, else
    quantized over the head dim with their scales (``kv_quant``, keyed on
    the pool leaf's dtype)."""
    if "k_scale" not in pool:
        return {"k": k, "v": v}
    # K and V in one pass: each row is quantized on its own, so the bytes
    # are those of two passes, for half the launches
    q, scale = kv_quant.quantize_kv_as(torch.stack((k, v)), pool["k"].dtype)
    return {"k": q[0], "v": q[1], "k_scale": scale[0], "v_scale": scale[1]}


def _paged_kv_write(cache: Params, pages: torch.Tensor, off: torch.Tensor,
                    k: torch.Tensor, v: torch.Tensor) -> None:
    """The ONE paged KV scatter, in place: token K/V land at physical
    ``(pages, off)`` (decode writes one token per row, verify and
    prefill-append a (B, S) chunk); a quantized pool takes each token
    quantized on its own with its scales at the same indices, so the
    committed neighbours keep their bytes.  Several tokens may target the
    same (trash page, offset): the admission step steers every row it does
    not admit there, and prefill-append its padding tokens.  Which write
    wins is then unspecified and harmless, since nothing reads the trash
    page's values; the writes never accumulate."""
    for name, x in quantize_leaves(cache, k, v).items():
        put_pool(cache[name], (pages, off), x)


def _kv_scales(cache: Params) -> Dict[str, torch.Tensor]:
    """The scale operands of the paged ``ops`` calls ({} for fp pools)."""
    if "k_scale" in cache:
        return {"k_scale": cache["k_scale"], "v_scale": cache["v_scale"]}
    return {}


def _table_pages(block_table: torch.Tensor, pos: torch.Tensor,
                 page: int) -> torch.Tensor:
    """Physical page of each logical position: (B, S) positions → (B, S)
    page ids.  Blocks past the table clamp to its last entry (see the
    module note)."""
    blk = torch.clamp(pos // page, max=block_table.shape[1] - 1)
    return torch.gather(block_table, 1, blk.long()).long()


def attention(p: Params, x: torch.Tensor, *, cfg: ArchConfig, window: int,
              cos: torch.Tensor, sin: torch.Tensor,
              cache: Optional[Params] = None,
              cache_index: Optional[Index] = None,
              block_table: Optional[torch.Tensor] = None,
              chunk_lens: Optional[torch.Tensor] = None,
              tile_plan: Optional[torch.Tensor] = None,
              mode: str = "prefill") -> Tuple[torch.Tensor, Params]:
    """``"train"``: causal attention over the whole sequence, no cache (the
    training forward; differentiable).  ``"prefill"``: the same, whose K/V
    fill cache positions [0, S).  ``"decode"``: S == 1 at ``cache_index``
    (an int, or a (B,) tensor of per-row positions), attending to the cache
    up to and including that position.  ``"verify"``: a speculative
    S = γ+1 chunk whose first token sits at ``cache_index``, written at
    positions idx..idx+S-1 and scored causally within the chunk in one
    call.  With ``block_table`` (B, P) the cache is a page pool
    (``init_paged_attn_cache``) and decode/verify write and read through
    the table; shared prefix pages cover positions below the committed
    index, which neither mode writes.  ``"prefill_append"``: a chunk of S
    tokens per row at ``cache_index`` (B,), ragged by ``chunk_lens`` (B,)
    (tokens at ``t >= chunk_lens`` are padding: their writes go nowhere
    that is read, their outputs are garbage the caller drops), written and
    scored causally within the chunk in one call.  ``tile_plan`` (paged
    ``"prefill_append"`` at S 1 only) groups rows into the prefix-append
    kernel's row tiles (``ops.paged_prefill_attention``); it never changes
    a valid row's result."""
    if mode not in ("train", "prefill", "decode", "verify",
                    "prefill_append"):
        raise NotImplementedError(f"attention mode {mode!r} is not ported")
    if cache is None and mode != "train":
        raise ValueError(f"mode {mode!r} needs a cache")
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = (x @ p["wq"]).reshape(b, s, cfg.num_heads, hd)
    k = (x @ p["wk"]).reshape(b, s, cfg.num_kv_heads, hd)
    v = (x @ p["wv"]).reshape(b, s, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    cap = cfg.attn_softcap
    if mode in ("train", "prefill"):
        o = ops.flash_attention(q, k, v, causal=True, window=window,
                                softcap=cap)
        # train writes nothing in place: autograd sees every op, and the
        # flash call's backward is the backward kernel on the card
        if mode == "prefill":
            cache["k"][:, :s] = k
            cache["v"][:, :s] = v
    elif mode == "prefill_append":
        idx = torch.as_tensor(cache_index, device=x.device).broadcast_to(
            (b,))
        pos = idx[:, None] + torch.arange(s, device=x.device)   # (B, S)
        valid = (torch.arange(s, device=x.device)[None] < chunk_lens[:, None]
                 if chunk_lens is not None
                 else torch.ones((b, s), dtype=torch.bool, device=x.device))
        if block_table is not None:
            page = cache["k"].shape[1]
            pages = torch.where(valid, _table_pages(block_table, pos, page),
                                TRASH_PAGE)
            _paged_kv_write(cache, pages, pos % page, k, v)
            o = ops.paged_prefill_attention(
                q, cache["k"], cache["v"], block_table, idx + s,
                window=window, softcap=cap, plan=tile_plan,
                **_kv_scales(cache))
        else:
            # padding tokens and positions past the cache write back the old
            # values: a masked select, no host sync.  Positions wrap modulo
            # the capacity so a row's S slots stay distinct (S <= max_len).
            max_len = cache["k"].shape[1]
            if s > max_len:
                raise ValueError(f"chunk of {s} tokens exceeds the cache")
            rows = torch.arange(b, device=x.device)[:, None]
            posw = pos % max_len
            keep = (valid & (pos < max_len))[..., None, None]
            for name, new in (("k", k), ("v", v)):
                leaf = cache[name]
                leaf[rows, posw] = torch.where(keep, new, leaf[rows, posw])
            o = ops.multi_decode_attention(q, cache["k"], cache["v"],
                                           idx + s, window=window,
                                           softcap=cap)
    elif mode == "verify" or block_table is not None:
        if mode == "decode" and s != 1:
            raise ValueError("decode takes one token per row")
        idx = torch.as_tensor(cache_index, device=x.device).broadcast_to(
            (b,))
        pos = idx[:, None] + torch.arange(s, device=x.device)   # (B, S)
        if block_table is not None:
            page = cache["k"].shape[1]
            _paged_kv_write(cache, _table_pages(block_table, pos, page),
                            pos % page, k, v)
            if mode == "decode":
                o = ops.paged_decode_attention(
                    q[:, 0], cache["k"], cache["v"], block_table, idx + 1,
                    window=window, softcap=cap,
                    **_kv_scales(cache))[:, None]
            else:
                o = ops.paged_multi_decode_attention(
                    q, cache["k"], cache["v"], block_table, idx + s,
                    window=window, softcap=cap, **_kv_scales(cache))
        else:
            rows = torch.arange(b, device=x.device)[:, None]
            posw = torch.clamp(pos, max=cache["k"].shape[1] - 1)
            cache["k"][rows, posw] = k
            cache["v"][rows, posw] = v
            o = ops.multi_decode_attention(q, cache["k"], cache["v"],
                                           idx + s, window=window,
                                           softcap=cap)
    else:
        if s != 1:
            raise ValueError("decode takes one token per row")
        idx = cache_index
        if isinstance(idx, int):
            cache["k"][:, idx] = k[:, 0]
            cache["v"][:, idx] = v[:, 0]
        else:
            rows = torch.arange(b, device=x.device)
            idxw = torch.clamp(idx, max=cache["k"].shape[1] - 1)
            cache["k"][rows, idxw] = k[:, 0]
            cache["v"][rows, idxw] = v[:, 0]
        o = ops.decode_attention(q[:, 0], cache["k"], cache["v"], idx + 1,
                                 window=window, softcap=cap)
        o = o[:, None]
    o = o.reshape(b, s, cfg.num_heads * hd)
    # identity outside a serving tp_context; the sum over the model axis
    # when q/o are head-split
    return collectives.tp_attn_all_reduce(o @ p["wo"]), cache


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, cfg: ArchConfig, device) -> Params:
    d, ff = cfg.d_model, cfg.d_ff
    dt = getattr(torch, cfg.dtype)
    return {"wg": dense_init(gen, d, (d, ff), dt, device),
            "wu": dense_init(gen, d, (d, ff), dt, device),
            "wd": dense_init(gen, ff, (ff, d), dt, device)}


def mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    # identity outside a serving tp_context; the sum over the model axis
    # when the hidden dim is split
    return collectives.tp_mlp_all_reduce(
        (F.silu(x @ p["wg"]) * (x @ p["wu"])) @ p["wd"])


# ---------------------------------------------------------------------------
# Mamba-2-style SSD mixer (selective gated linear attention)
# ---------------------------------------------------------------------------

def _check_recurrent_mode(name: str, mode: str,
                          cache: Optional[Params]) -> None:
    """The recurrent mixers' modes: ``"prefill"`` and ``"decode"`` (state
    from the cache, written back in place) and ``"train"`` (no cache: the
    JAX package's train mode returns none and writes none)."""
    if mode not in ("prefill", "decode", "train"):
        raise NotImplementedError(f"{name} mode {mode!r} is not ported")
    if mode == "train" and cache is not None:
        raise ValueError(f"{name} mode 'train' takes no cache")


def _ssm_state_dim(cfg: ArchConfig) -> int:
    """The state's key width n: ``ssm_state``, at least 16."""
    return max(cfg.ssm_state, 16)


def init_mamba(gen: torch.Generator, cfg: ArchConfig, device) -> Params:
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    h = cfg.resolved_ssm_heads
    n = _ssm_state_dim(cfg)
    dt = getattr(torch, cfg.dtype)
    f32 = torch.float32
    return {
        "w_in": dense_init(gen, d, (d, 2 * d_in), dt, device),
        "w_bc": dense_init(gen, d, (d, 2 * h * n), dt, device),
        "w_dt": dense_init(gen, d, (d, h), dt, device),
        "dt_bias": torch.zeros((h,), dtype=f32, device=device),
        "a_log": torch.zeros((h,), dtype=f32, device=device),
        "w_out": dense_init(gen, d_in, (d_in, d), dt, device),
        "d_skip": torch.zeros((h,), dtype=f32, device=device),
    }


def init_mamba_cache(cfg: ArchConfig, batch: int, device) -> Params:
    """The (B, H, n, P) f32 state: n = max(ssm_state, 16) keys (B and C's
    width), P = ssm_expand · d / H values a head."""
    h = cfg.resolved_ssm_heads
    p_dim = cfg.ssm_expand * cfg.d_model // h
    return {"state": torch.zeros((batch, h, _ssm_state_dim(cfg), p_dim),
                                 dtype=torch.float32, device=device)}


def mamba(p: Params, x: torch.Tensor, *, cfg: ArchConfig,
          cache: Optional[Params] = None, mode: str = "prefill"
          ) -> Tuple[torch.Tensor, Optional[Params]]:
    """``"prefill"``: the chunked scan over the sequence from the cache's
    state (no cache: zeros), q = C and k = B, the two halves of each
    head's 2n columns of ``x @ w_bc`` (strided views, no copy).
    ``"decode"``: S == 1, the O(1) state update.  The final state is copied
    into ``cache["state"]`` in place.  ``"train"``: the scan from zeros
    under autograd (its backward kernel on the card), no cache.  The casts
    follow the JAX package step by step: dt and the log decay in f32, v =
    x_in · dt and the D skip in the compute dtype, and so the gate o ·
    silu(z)."""
    _check_recurrent_mode("mamba", mode, cache)
    b, s, d = x.shape
    h = cfg.resolved_ssm_heads
    n = _ssm_state_dim(cfg)
    d_in = cfg.ssm_expand * d
    p_dim = d_in // h

    xz = x @ p["w_in"]
    x_in, z = xz[..., :d_in], xz[..., d_in:]
    bc = (x @ p["w_bc"]).reshape(b, s, h, 2 * n)
    b_mat, c_mat = bc[..., :n], bc[..., n:]
    dt = F.softplus((x @ p["w_dt"]).float() + p["dt_bias"])      # (B,S,H)
    log_g = -dt * torch.exp(p["a_log"])                          # <= 0
    v = x_in.reshape(b, s, h, p_dim) * dt[..., None].to(x.dtype)

    state = cache["state"] if cache is not None else None
    if mode == "decode":
        if s != 1:
            raise ValueError("decode takes one token per row")
        o, new_state = ops.ssm_decode_step(
            c_mat[:, 0], b_mat[:, 0], v[:, 0], log_g[:, 0], state)
        o = o[:, None]
    else:
        o, new_state = ops.ssm_scan(c_mat, b_mat, v, log_g, state)
    o = o + v * p["d_skip"][:, None].to(x.dtype)                 # D skip
    o = o.reshape(b, s, d_in) * F.silu(z)
    if cache is not None:
        cache["state"].copy_(new_state)
    return o @ p["w_out"], cache


# ---------------------------------------------------------------------------
# Hymba hybrid mixer: attention ‖ mamba, per-branch normalised mean
# ---------------------------------------------------------------------------

def init_hybrid(gen: torch.Generator, cfg: ArchConfig, device) -> Params:
    dt = getattr(torch, cfg.dtype)
    return {
        "attn": init_attention(gen, cfg, device),
        "mamba": init_mamba(gen, cfg, device),
        "norm_a": torch.zeros((cfg.d_model,), dtype=dt, device=device),
        "norm_m": torch.zeros((cfg.d_model,), dtype=dt, device=device),
    }


def init_hybrid_cache(cfg: ArchConfig, batch: int, attn: Params,
                      device) -> Params:
    """The attention branch's cache ``attn`` (dense KV from
    ``init_attn_cache`` or page pools from ``init_paged_attn_cache``)
    beside the Mamba state."""
    return {"attn": attn, "mamba": init_mamba_cache(cfg, batch, device)}


def hybrid(p: Params, x: torch.Tensor, *, cfg: ArchConfig, window: int,
           cos: torch.Tensor, sin: torch.Tensor,
           cache: Optional[Params] = None, mode: str = "prefill",
           **attention_args) -> Tuple[torch.Tensor, Optional[Params]]:
    """Attention (``cache["attn"]``: dense KV or page pools, written in
    place; ``attention_args``: ``cache_index``, ``block_table`` and the
    rest of ``attention``'s) and Mamba (``cache["mamba"]``) on the same
    input, fused as 0.5 · (rms_norm(a, norm_a) + rms_norm(m, norm_m)).
    Modes ``"prefill"``, ``"decode"`` and ``"train"`` (no cache), as
    ``mamba``."""
    _check_recurrent_mode("hybrid", mode, cache)
    a_out, _ = attention(p["attn"], x, cfg=cfg, window=window, cos=cos,
                         sin=sin, cache=None if cache is None
                         else cache["attn"], mode=mode, **attention_args)
    m_out, _ = mamba(p["mamba"], x, cfg=cfg, cache=None if cache is None
                     else cache["mamba"], mode=mode)
    out = 0.5 * (rms_norm(a_out, p["norm_a"], cfg.norm_eps)
                 + rms_norm(m_out, p["norm_m"], cfg.norm_eps))
    return out, cache


# ---------------------------------------------------------------------------
# xLSTM mLSTM mixer (matrix memory with q·n normaliser)
# ---------------------------------------------------------------------------

def init_mlstm(gen: torch.Generator, cfg: ArchConfig, device) -> Params:
    d = cfg.d_model
    d_in = 2 * d
    h = cfg.resolved_ssm_heads
    dt = getattr(torch, cfg.dtype)
    f32 = torch.float32
    return {
        "w_up": dense_init(gen, d, (d, 2 * d_in), dt, device),
        "wq": dense_init(gen, d_in, (d_in, d_in), dt, device),
        "wk": dense_init(gen, d_in, (d_in, d_in), dt, device),
        "wv": dense_init(gen, d_in, (d_in, d_in), dt, device),
        "w_i": dense_init(gen, d_in, (d_in, h), f32, device),
        "w_f": dense_init(gen, d_in, (d_in, h), f32, device),
        "f_bias": torch.full((h,), 3.0, dtype=f32, device=device),
        "w_down": dense_init(gen, d_in, (d_in, d), dt, device),
    }


def init_mlstm_cache(cfg: ArchConfig, batch: int, device) -> Params:
    """The (B, H, dk, dk + 1) f32 state: the value column dk + 1 carries the
    normaliser n."""
    h = cfg.resolved_ssm_heads
    dk = 2 * cfg.d_model // h
    return {"state": torch.zeros((batch, h, dk, dk + 1), dtype=torch.float32,
                                 device=device)}


def mlstm(p: Params, x: torch.Tensor, *, cfg: ArchConfig,
          cache: Optional[Params] = None, mode: str = "prefill"
          ) -> Tuple[torch.Tensor, Optional[Params]]:
    """``"prefill"``: the chunked scan over the sequence from the cache's
    state (zeros from ``init_cache``; no cache: zeros).  ``"decode"``:
    S == 1, the O(1) state update.  The final state is copied into
    ``cache["state"]`` in place.  ``"train"``: the scan from zeros under
    autograd (its backward kernel on the card), no cache.  The casts
    follow the JAX package step by step: ``k · i_gate`` in the compute
    dtype, the gates in f32."""
    _check_recurrent_mode("mlstm", mode, cache)
    b, s, d = x.shape
    h = cfg.resolved_ssm_heads
    d_in = 2 * d
    dk = d_in // h

    up = x @ p["w_up"]
    x_in, z = up[..., :d_in], up[..., d_in:]
    # the scale rounded to the compute dtype first, as JAX promotes a
    # Python float against a bf16 array
    q = (x_in @ p["wq"]).reshape(b, s, h, dk) * torch.tensor(
        dk ** -0.5, dtype=x_in.dtype)
    k = (x_in @ p["wk"]).reshape(b, s, h, dk)
    v = (x_in @ p["wv"]).reshape(b, s, h, dk)
    xf = x_in.float()
    i_gate = torch.sigmoid(xf @ p["w_i"])                         # (B,S,H)
    log_f = log_sigmoid(xf @ p["w_f"] + p["f_bias"])

    # fold the normaliser n into the GLA state via an augmented value column
    k_scaled = k * i_gate[..., None].to(k.dtype)
    v_aug = torch.cat([v, torch.ones((b, s, h, 1), dtype=v.dtype,
                                     device=v.device)], dim=-1)
    state = cache["state"] if cache is not None else None
    if mode == "decode":
        if s != 1:
            raise ValueError("decode takes one token per row")
        o_aug, new_state = ops.ssm_decode_step(
            q[:, 0], k_scaled[:, 0], v_aug[:, 0], log_f[:, 0], state)
        o_aug = o_aug[:, None]
    else:
        o_aug, new_state = ops.ssm_scan(q, k_scaled, v_aug, log_f, state)
    o, den = o_aug[..., :dk], o_aug[..., dk:]
    o = o / torch.clamp(den.abs(), min=1.0)
    o = o.reshape(b, s, d_in) * F.silu(z)
    if cache is not None:
        cache["state"].copy_(new_state)
    return o @ p["w_down"], cache


# ---------------------------------------------------------------------------
# xLSTM sLSTM mixer (scalar memory, stabilised exponential gating)
# ---------------------------------------------------------------------------

def init_slstm(gen: torch.Generator, cfg: ArchConfig, device) -> Params:
    d = cfg.d_model
    h = cfg.resolved_ssm_heads
    p_dim = d // h
    dt = getattr(torch, cfg.dtype)
    f32 = torch.float32
    bias = torch.zeros((4 * d,), dtype=f32, device=device)
    bias[2 * d:3 * d] = 3.0                                  # forget bias
    return {
        "w_gates": dense_init(gen, d, (d, 4 * d), f32, device),
        "r_gates": dense_init(gen, p_dim, (h, p_dim, 4 * p_dim), f32,
                              device),
        "bias": bias,
        "w_out": dense_init(gen, d, (d, d), dt, device),
    }


def init_slstm_cache(cfg: ArchConfig, batch: int, device) -> Params:
    """(h, c, n, m), each (B, d) f32: zeros, as the JAX ``init_cache``
    makes every leaf (its per-layer ``n`` of 1e-6 does not survive the
    stacking)."""
    z = torch.zeros((batch, cfg.d_model), dtype=torch.float32, device=device)
    return {"h": z, "c": z.clone(), "n": z.clone(), "m": z.clone()}


def slstm(p: Params, x: torch.Tensor, *, cfg: ArchConfig,
          cache: Optional[Params] = None, mode: str = "prefill"
          ) -> Tuple[torch.Tensor, Optional[Params]]:
    """The recurrence from the cache's (h, c, n, m) (no cache: the zero
    start) over S tokens, prefill and decode alike; the final state is
    copied into the cache in place.  ``"train"``: from the zero start under
    autograd (its backward kernel on the card), no cache.  The state is
    (B, d) in the cache and (B, H, P) in the kernel (the same memory
    order)."""
    _check_recurrent_mode("slstm", mode, cache)
    b, s, d = x.shape
    h = cfg.resolved_ssm_heads
    p_dim = d // h
    gates_x = x.float() @ p["w_gates"] + p["bias"]               # (B,S,4d)
    state = None
    if cache is not None:
        state = tuple(cache[n].float().reshape(b, h, p_dim) for n in "hcnm")
    hs, final = ops.slstm_scan(gates_x, p["r_gates"], state)
    if cache is not None:
        for n, t in zip("hcnm", final):
            cache[n].copy_(t.reshape(b, d))
    return hs.to(x.dtype) @ p["w_out"], cache
