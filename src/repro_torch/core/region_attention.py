"""Text-image attention over regions: Eq. (2), kernel-backed (§3.2.2).

``K(x^r) = Σ_i Σ_j cos(V_i(x^r), E_j(T_k))``, computed by the
``region_score`` CUDA kernel on the card and its plain version on the CPU.
The raw score scales with N_V·N_E, so ``score_regions`` also returns the
per-image normalised score used against the paper's thresholds (α=0.35,
β=0.55): mean cosine mapped from [−1, 1] to [0, 1].
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import ops


def score_regions(region_feats: torch.Tensor, text_feats: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """region_feats: (B, R, Nv, D) V(x^r); text_feats: (B, Ne, D) E(T).

    Returns (raw (B, R), normalised (B, R) in [0, 1])."""
    raw = ops.region_score(region_feats, text_feats)
    nv, ne = region_feats.shape[2], text_feats.shape[1]
    mean_cos = raw / float(nv * ne)
    return raw, torch.clamp(0.5 * (mean_cos + 1.0), 0.0, 1.0)
