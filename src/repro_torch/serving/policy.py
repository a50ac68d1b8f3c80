"""CascadePolicy: per-chunk exit/offload decisions for Algorithm 1.

The port of ``repro.serving.policy`` for the base policy and SpaceVerse's
progressive-confidence policy; the §4.1.5 baselines (static, Tabi, AI-RG)
are not ported yet.  The ``CascadeExecutor`` runs the mechanics; a policy
supplies every decision:

- ``decide_initial``  offload verdict right after encoding (stage 1);
- ``decide_stage``    verdict after each decoded chunk (``None`` = none);
- ``gs_view``         what pixels the ground station receives;
- ``stage_plan``      how onboard decoding is chunked between decisions.

Decisions are (B,) bool tensors with optional (B,) scores.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import torch

from repro_torch.core import confidence as C

Decision = Tuple[Any, Optional[Any]]          # ((B,) bool mask, (B,) scores)


class CascadePolicy:
    """Base policy: run the full answer onboard, never offload."""

    name = "never-offload"
    needs_encode = False
    run_onboard = True
    run_gs = False
    collects_scores = False

    def stage_plan(self, task: str, l_ans: int) -> List[int]:
        return [l_ans] if l_ans > 0 else []

    def decide_initial(self, task: str, batch: int,
                       visual: Optional[torch.Tensor]) -> Decision:
        return torch.zeros((batch,), dtype=torch.bool), None

    def decide_stage(self, stage: int, task: str, tokens: torch.Tensor,
                     probs: torch.Tensor, visual: Optional[torch.Tensor],
                     token_feats_fn: Callable[[], torch.Tensor]
                     ) -> Optional[Decision]:
        return None

    def gs_view(self, pipeline, task: str, images: torch.Tensor,
                region_feats: Optional[torch.Tensor],
                text_feats: Optional[torch.Tensor]):
        return pipeline.full_view(task, images)


class ProgressiveConfidencePolicy(CascadePolicy):
    """SpaceVerse §3.1: progressive confidence network g̃ with per-stage
    thresholds τ_i; offloads transit the Eq. 2/Eq. 3 multiscale pipeline."""

    name = "progressive-confidence"
    needs_encode = True
    run_onboard = True
    run_gs = True
    collects_scores = True

    def __init__(self, conf_params, cascade_cfg):
        self.conf = conf_params
        self.cc = cascade_cfg

    @property
    def num_stages(self) -> int:
        return C.num_stages(self.conf)

    def stage_plan(self, task: str, l_ans: int) -> List[int]:
        """Chunks before confidence stages 2..I; the last stage always sees
        the complete output."""
        n_stages = self.num_stages
        if n_stages <= 1:
            return []
        chunks, done = [], 0
        for _ in range(n_stages - 2):
            c = min(self.cc.n_t, l_ans - done)
            chunks.append(max(c, 0))
            done += c
        chunks.append(max(l_ans - done, 0))
        return chunks

    def _tau(self, stage: int) -> float:
        return self.cc.taus[min(stage, len(self.cc.taus) - 1)]

    def decide_initial(self, task, batch, visual) -> Decision:
        s = C.apply_stage(self.conf, 0, visual)
        return s < self._tau(0), s

    def decide_stage(self, stage, task, tokens, probs, visual,
                     token_feats_fn) -> Decision:
        s = C.apply_stage(self.conf, stage, visual, token_feats_fn())
        return s < self._tau(stage), s

    def gs_view(self, pipeline, task, images, region_feats, text_feats):
        return pipeline.multiscale_view(task, images, region_feats,
                                        text_feats)
