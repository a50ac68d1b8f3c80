"""Attention-guided multi-scale preprocessing: Eq. (3) (§3.2.3).

              ⎧ 0                          K(x^r) < α        (discard)
  f(x^r)  =   ⎨ D(x^r, (β−α)/(K−α))        α ≤ K(x^r) < β    (downsample)
              ⎩ x^r                        β ≤ K(x^r)        (preserve)

The port of ``repro.core.preprocess``, with the GS-only baseline's random
region drop (``random_mask_filter``) beside it.  The scaling factor c = (β−α)/(K−α) ≥ 1 is quantised to a
pyramid of power-of-two pooling levels, as in the JAX package; each region
is replaced by its pooled-then-nearest-upsampled reconstruction (zero if
discarded).  The region side must divide by every level.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch


def _avg_pool(regions: torch.Tensor, f: int) -> torch.Tensor:
    """(B, R, h, w, C) average-pool by factor f then nearest-upsample back."""
    if f == 1:
        return regions
    b, r, h, w, c = regions.shape
    x = regions.reshape(b, r, h // f, f, w // f, f, c).mean(dim=(3, 5))
    return x.repeat_interleave(f, dim=2).repeat_interleave(f, dim=3)


def scale_factor(scores: torch.Tensor, alpha: float, beta: float
                 ) -> torch.Tensor:
    """Paper's c = (β−α)/(K−α) on the downsample band, ∞ below α, 1 above β."""
    c = (beta - alpha) / torch.clamp(scores - alpha, min=1e-9)
    inner = torch.where(scores < alpha, torch.full_like(c, float("inf")),
                        torch.clamp(c, min=1.0))
    return torch.where(scores >= beta, torch.ones_like(c), inner)


def multiscale_filter(regions: torch.Tensor, scores: torch.Tensor, *,
                      alpha: float = 0.35, beta: float = 0.55,
                      levels: Sequence[int] = (1, 2, 4, 8),
                      bytes_per_px: float = 3.0
                      ) -> Tuple[torch.Tensor, torch.Tensor,
                                 Dict[str, torch.Tensor]]:
    """regions: (B, R, h, w, C); scores: (B, R) normalised K(x^r).

    Returns (filtered regions, tx_bytes (B,), meta).  ``tx_bytes`` counts
    h·w·C / c² per kept region (c = selected pooling level), zero if
    dropped."""
    b, r, h, w, ch = regions.shape
    if any(h % f or w % f for f in levels):
        raise ValueError(f"region side {h}x{w} must divide by every "
                         f"pyramid level {tuple(levels)}")
    c = scale_factor(scores, alpha, beta)                      # (B, R)
    # smallest level >= c: the number of levels strictly below c, clipped
    lv = torch.tensor(levels, dtype=torch.float32, device=scores.device)
    li = torch.clamp((lv < c[..., None]).sum(dim=-1), 0, len(levels) - 1)
    discard = scores < alpha

    sel = torch.zeros_like(regions)
    for j, f in enumerate(levels):
        sel = torch.where((li == j)[..., None, None, None],
                          _avg_pool(regions, f), sel)
    out = torch.where(discard[..., None, None, None],
                      torch.zeros_like(sel), sel)

    level_vals = lv[li]
    px = (h * w * ch) / (level_vals ** 2)
    tx_bytes = torch.where(discard, torch.zeros_like(px),
                           px * bytes_per_px).sum(dim=-1)      # (B,)
    full_bytes = float(r * h * w * ch * bytes_per_px)
    meta = {
        "levels": level_vals,
        "discarded": discard,
        "compression_ratio": full_bytes / torch.clamp(tx_bytes, min=1.0),
        "full_bytes": torch.full((b,), full_bytes, device=scores.device),
    }
    return out, tx_bytes, meta


def keep_mask_filter(regions: torch.Tensor, keep: torch.Tensor, *,
                     bytes_per_px: float = 3.0):
    """Zero the regions outside ``keep`` (B, R) bool and count the bytes of
    the kept ones (kept·px·bytes_per_px, f32): the deterministic half of
    ``random_mask_filter``."""
    out = torch.where(keep[..., None, None, None], regions,
                      torch.zeros((), dtype=regions.dtype,
                                  device=regions.device))
    px = regions.shape[2] * regions.shape[3] * regions.shape[4]
    tx_bytes = keep.sum(-1).float() * px * bytes_per_px
    return out, tx_bytes, {"kept": keep}


def random_mask_filter(regions: torch.Tensor, keep_frac: float,
                       generator: torch.Generator, *,
                       bytes_per_px: float = 3.0):
    """GS-only baseline redundancy reduction (Fig. 3/12): random region
    drop, each region kept with probability ``keep_frac``.  One draw from
    ``generator``, which lies on the regions' device."""
    b, r = regions.shape[:2]
    keep = torch.rand((b, r), generator=generator,
                      device=regions.device) < keep_frac
    return keep_mask_filter(regions, keep, bytes_per_px=bytes_per_px)
