"""Model building blocks of the port (PyTorch; params are dicts of tensors).

The attention-only slice of ``repro.models.layers``: RMSNorm, RoPE with
Qwen2-VL's M-RoPE sections, GQA attention backed by the flash and decode
kernels (modes ``"prefill"`` and dense ``"decode"``), and the SwiGLU MLP.
The other mixers (MoE, Mamba, mLSTM, sLSTM, Hymba) and the paged, verify
and prefill-append modes are not ported yet and raise.

Unlike the JAX package, which is functional, attention writes the KV cache
in place and returns the same cache object.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops

Params = Dict[str, Any]
Index = Union[int, torch.Tensor]


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


def attention(p: Params, x: torch.Tensor, *, cfg: ArchConfig, window: int,
              cos: torch.Tensor, sin: torch.Tensor,
              cache: Optional[Params] = None,
              cache_index: Optional[Index] = None,
              mode: str = "prefill") -> Tuple[torch.Tensor, Params]:
    """``"prefill"``: causal attention over the whole sequence, whose K/V
    fill cache positions [0, S).  ``"decode"``: S == 1 at ``cache_index``
    (an int, or a (B,) tensor of per-row positions), attending to the
    dense cache up to and including that position."""
    if mode not in ("prefill", "decode"):
        raise NotImplementedError(f"attention mode {mode!r} is not ported")
    if cache is None:
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

    if mode == "prefill":
        o = ops.flash_attention(q, k, v, causal=True, window=window,
                                softcap=cfg.attn_softcap)
        cache["k"][:, :s] = k
        cache["v"][:, :s] = v
    else:
        if s != 1:
            raise ValueError("decode takes one token per row")
        idx = cache_index
        if isinstance(idx, int):
            cache["k"][:, idx] = k[:, 0]
            cache["v"][:, idx] = v[:, 0]
        else:
            rows = torch.arange(b, device=x.device)
            cache["k"][rows, idx] = k[:, 0]
            cache["v"][rows, idx] = v[:, 0]
        o = ops.decode_attention(q[:, 0], cache["k"], cache["v"], idx + 1,
                                 window=window, softcap=cfg.attn_softcap)
        o = o[:, None]
    o = o.reshape(b, s, cfg.num_heads * hd)
    return o @ p["wo"], cache


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
    return (F.silu(x @ p["wg"]) * (x @ p["wu"])) @ p["wd"]
