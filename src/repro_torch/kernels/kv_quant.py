"""Quantized KV-page numerics (int8 and fp8 e4m3) and the parity factory.

The port of ``repro.kernels.kv_quant``.  The paged KV pool can store pages
as int8 (``kv_dtype="int8"``) or fp8 e4m3 (``kv_dtype="fp8"``) with one
symmetric f32 scale per (page, slot, KV head) beside them.  The scale is
per token slot, not per page: a page fills a token (decode), a chunk
(verify, prefill) at a time, and a page-wide scale would requantize the
committed tokens whenever a new one raised the running max.  With per-slot
scales every write is local to its own (page, offset), so the stored bytes
of a committed token never change: chunked equals unchunked prefill, and a
rejected speculative draft never touches its committed neighbours.

A quantized page costs ``page·2·KH·(hd + 4)`` bytes (one f32 scale per hd
stored bytes), ``serving.kv_pool.page_nbytes`` being the one accounting
rule.  The quantizers are plain tensor code on either device, as the JAX
package computes them outside any kernel; the paged kernels read the
stored bytes and the scales themselves (``kernels/paged_*``).

``STRATEGIES`` bundles, for each storage, how fp pools become kernel
operands, the plain version that defines its semantics (dequantize the
pool, then the fp function: ``kernels/ref.py``) and the tolerances a kernel
meets against that oracle (``tol_self``) and the strategy against the exact
one (``tol_exact``).  ``compare_outputs`` reports a quantized engine's
token agreement with an fp engine instead of asserting it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import ref

Q_MAX = 127.0
#: e4m3's largest finite value.  The quantizer clips to it before the cast:
#: some casts saturate there, others (JAX's) give NaN, and the clip makes
#: every backend store the same byte.
FP8_MAX = 448.0
FP8_DTYPE = torch.float8_e4m3fn
#: the pool element type of each ``kv_dtype``
KV_DTYPES = {"int8": torch.int8, "fp8": FP8_DTYPE}
_TINY = torch.finfo(torch.float32).tiny


def _flush(x: torch.Tensor) -> torch.Tensor:
    """f32 subnormals → a zero of their sign.  The JAX package's quantizer
    runs where they flush (XLA's CPU and the TPU), so a row of subnormals,
    or an amax so small that its scale is one, stores zeros and scale 0
    there: the port matches it on every device."""
    return torch.where(x.abs() < _TINY, x * 0.0, x)


def _flush_scale(scale: torch.Tensor) -> torch.Tensor:
    """``_flush`` for scales, which are never negative."""
    return scale.masked_fill(scale < _TINY, 0.0)


def _amax_ratio(x: torch.Tensor, top: float):
    """(x as f32 with subnormals flushed, the row amax, top / amax) — the
    quotient as one IEEE division (``top / tensor`` would multiply by a
    rounded reciprocal and miss JAX's bytes at ties)."""
    xf = _flush(x.float())
    amax = xf.abs().amax(dim=-1)
    ratio = torch.full_like(amax, top) / torch.clamp(amax, min=1e-30)
    return xf, amax, ratio


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization over the trailing (head-dim) axis:
    x (..., hd) → (q int8 (..., hd), scale f32 (...,)) with
    ``dequantize_kv(q, scale) ≈ x``.  All-zero rows give exact zeros
    (scale 0).  Rounds half to even, as ``jnp.round``."""
    xf, amax, ratio = _amax_ratio(x, Q_MAX)
    q = torch.round(xf * ratio[..., None])
    return (torch.clamp(q, -Q_MAX, Q_MAX).to(torch.int8),
            _flush_scale(amax / Q_MAX))


def quantize_kv_fp8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric fp8 (e4m3) quantization over the trailing axis: the row
    amax maps onto ±``FP8_MAX``; the stored element keeps a floating
    mantissa, so entries far below the amax keep relative precision.
    Clipped to ±``FP8_MAX`` before the cast; all-zero rows give exact
    zeros."""
    xf, amax, ratio = _amax_ratio(x, FP8_MAX)
    q = torch.clamp(xf * ratio[..., None], -FP8_MAX, FP8_MAX).to(FP8_DTYPE)
    return q, _flush_scale(amax / FP8_MAX)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of either quantizer: (..., hd) int8/fp8 × (...,) f32 → f32
    (the fp8 → f32 cast is exact, so one multiply serves both)."""
    return q.float() * scale[..., None]


def quantize_kv_as(x: torch.Tensor, dtype: torch.dtype
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize ``x`` for a pool leaf of ``dtype``: the one dispatch the
    write paths (``models.layers._paged_kv_write``, the engine's prefix
    scatter) use."""
    if dtype == torch.int8:
        return quantize_kv(x)
    if dtype == FP8_DTYPE:
        return quantize_kv_fp8(x)
    raise ValueError(f"no KV quantizer for pool dtype {dtype}")


def quantize_pool(k_pool: torch.Tensor, v_pool: torch.Tensor,
                  kv_dtype: str = "int8") -> Dict[str, torch.Tensor]:
    """fp pools (n_pages, page, KH, hd) → the quantized paged-cache leaves
    {"k", "v", "k_scale", "v_scale"} (scales (n_pages, page, KH) f32), the
    layout ``models.layers.init_paged_attn_cache(kv_dtype=...)`` makes."""
    quant = {"int8": quantize_kv, "fp8": quantize_kv_fp8}[kv_dtype]
    kq, ks = quant(k_pool)
    vq, vs = quant(v_pool)
    return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}


# ---------------------------------------------------------------------------
# strategy/oracle factory: quantized-vs-exact parity
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class KVStrategy:
    """One KV storage: pool conversion, defining oracle and bounds.

    ``tol_self``: max |kernel − own oracle| (the same dequantized math).
    ``tol_exact``: max |strategy oracle − exact fp oracle| (the
    quantization noise the strategy is held to)."""
    name: str
    kv_dtype: Optional[str]
    tol_self: float
    tol_exact: float

    def make_pools(self, k_pool: torch.Tensor, v_pool: torch.Tensor
                   ) -> Dict[str, torch.Tensor]:
        """fp pools → the cache leaves this strategy stores."""
        if self.kv_dtype is not None:
            return quantize_pool(k_pool, v_pool, self.kv_dtype)
        return {"k": k_pool, "v": v_pool}

    def scale_kwargs(self, pools: Dict[str, Any]) -> Dict[str, Any]:
        """The scale operands of the ``ops.paged_*`` dispatchers."""
        if "k_scale" in pools:
            return {"k_scale": pools["k_scale"], "v_scale": pools["v_scale"]}
        return {}

    def oracle(self, which: str, q, pools: Dict[str, Any], block_table,
               cache_len, **kw) -> torch.Tensor:
        """The plain version of ``which`` ∈ {"decode", "multi", "prefill"}
        under this storage (dequantize, then gather)."""
        fn = {"decode": ref.paged_decode_attention,
              "multi": ref.paged_multi_decode_attention,
              "prefill": ref.paged_prefill_attention}[which]
        return fn(q, pools["k"], pools["v"], block_table, cache_len,
                  **self.scale_kwargs(pools), **kw)


STRATEGIES: Dict[str, KVStrategy] = {
    "exact": KVStrategy(name="exact", kv_dtype=None,
                        tol_self=5e-5, tol_exact=0.0),
    # int8: per-element error <= amax/254 of the row; softmax-weighted
    # sums keep the same order, 2e-2 on O(1) outputs
    "int8": KVStrategy(name="int8", kv_dtype="int8",
                       tol_self=5e-5, tol_exact=2e-2),
    # e4m3: 3 mantissa bits, per-element error <= amax/16 near the top of
    # the range, relative precision below it
    "fp8": KVStrategy(name="fp8", kv_dtype="fp8",
                      tol_self=5e-5, tol_exact=1.5e-1),
}


def get_strategy(name: str) -> KVStrategy:
    try:
        return STRATEGIES[name]
    except KeyError:
        raise ValueError(
            f"unknown KV strategy {name!r} (have {sorted(STRATEGIES)})")


def for_kv_dtype(kv_dtype: Optional[str]) -> KVStrategy:
    """The strategy serving a given ``EngineCoreConfig.kv_dtype``."""
    for s in STRATEGIES.values():
        if s.kv_dtype == kv_dtype:
            return s
    raise ValueError(f"no KV strategy for kv_dtype {kv_dtype!r}")


def compare_tokens(expected, got) -> Dict[str, Any]:
    """Token-level comparison of two greedy outputs: a mismatch at position
    i makes every later position incomparable, so ``first_divergence`` is
    the summary; ``n_diverged`` counts positional mismatches (and the
    length difference)."""
    e = np.asarray(expected).ravel()
    g = np.asarray(got).ravel()
    n = int(min(e.size, g.size))
    neq = e[:n] != g[:n]
    first = int(np.argmax(neq)) if neq.any() else None
    return {
        "n_tokens": n,
        "n_diverged": int(neq.sum()) + abs(int(e.size) - int(g.size)),
        "first_divergence": first,
        "match": bool(not neq.any() and e.size == g.size),
    }


def compare_outputs(expected: Dict[Any, Any], got: Dict[Any, Any]
                    ) -> Dict[str, Any]:
    """``compare_tokens`` over a {request id: tokens} result: a quantized
    engine's agreement with an fp engine, reported."""
    per_req = {rid: compare_tokens(expected[rid], got[rid])
               for rid in sorted(expected)}
    diverged = {rid: r for rid, r in per_req.items() if not r["match"]}
    return {
        "n_requests": len(per_req),
        "n_tokens": sum(r["n_tokens"] for r in per_req.values()),
        "n_requests_diverged": len(diverged),
        "n_tokens_diverged": sum(r["n_diverged"] for r in per_req.values()),
        "first_divergences": {rid: r["first_divergence"]
                              for rid, r in diverged.items()},
        "match": not diverged and set(expected) == set(got),
    }
