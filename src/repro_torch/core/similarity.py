"""Simi(·,·) metrics (§3.1.1) and the confidence-training target.

The port of ``repro.core.similarity``.  The confidence network regresses the
realized satellite↔ground output similarity cos(ŷ^s, ŷ^g) (Eq. 1 RHS); task
quality is measured with the task-appropriate Simi against ground truth:
exact match for VQA/classification, region-set IoU for detection.
"""
from __future__ import annotations

import torch


def cosine(a: torch.Tensor, b: torch.Tensor, dim: int = -1,
           eps: float = 1e-8) -> torch.Tensor:
    af = a.float()
    bf = b.float()
    num = (af * bf).sum(dim)
    den = torch.linalg.vector_norm(af, dim=dim) * torch.linalg.vector_norm(
        bf, dim=dim)
    return num / torch.clamp(den, min=eps)


def output_similarity(dist_s: torch.Tensor, dist_g: torch.Tensor
                      ) -> torch.Tensor:
    """cos(ŷ^s, ŷ^g) over answer distributions, per sample.

    dist_*: (B, L_ans, V) answer-token probability distributions; multi-token
    answers are compared position-wise then averaged."""
    return cosine(dist_s, dist_g, dim=-1).mean(-1)


def simi_exact(pred: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """VQA / classification: 1 if equal (per sample)."""
    return (pred == label).float()


def simi_region_iou(pred_mask: torch.Tensor, true_mask: torch.Tensor
                    ) -> torch.Tensor:
    """Detection: IoU between predicted / true region sets (B, N_r)."""
    p = pred_mask.float()
    t = true_mask.float()
    inter = (p * t).sum(-1)
    union = torch.clamp(torch.maximum(p, t).sum(-1), min=1.0)
    return inter / union


def task_simi(task: str, pred: torch.Tensor, label: torch.Tensor
              ) -> torch.Tensor:
    if task in ("vqa", "cls"):
        return simi_exact(pred, label)
    if task == "det":
        return simi_region_iou(pred, label)
    raise ValueError(task)
