"""CascadePolicy: per-chunk exit/offload decisions for Algorithm 1.

The port of ``repro.serving.policy``: SpaceVerse's progressive-confidence
policy and every §4.1.5 baseline (static satellite-only / GS-only, Tabi,
AI-RG) as policies over one executor.  The ``CascadeExecutor`` runs the
mechanics; a policy supplies every decision:

- ``decide_initial``  offload verdict right after encoding (stage 1);
- ``decide_stage``    verdict after each decoded chunk (``None`` = none);
- ``gs_view``         what pixels the ground station receives;
- ``stage_plan``      how onboard decoding is chunked between decisions.

Decisions are (B,) bool tensors with optional (B,) scores.  The two random
policies (GS-only's region drop, AI-RG's selection) draw from a
``torch.Generator`` seeded from ``seed`` on their ``device``, once per
batch; the JAX package's threefry draws are not reproduced.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import torch

from repro_torch.core import confidence as C
from repro_torch.device import DeviceLike, resolve_device

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


class SatelliteOnlyPolicy(CascadePolicy):
    """Everything answers onboard (status-quo baseline, §4.1.5)."""
    name = "satellite-only"


class GroundOnlyPolicy(CascadePolicy):
    """Everything offloads at stage 0; raw images transit the link, with the
    optional naive random-masking reduction (Fig. 3/12)."""

    name = "ground-only"
    run_onboard = False
    run_gs = True

    def __init__(self, keep_frac: Optional[float] = None, seed: int = 0, *,
                 device: DeviceLike = None):
        self.keep_frac = keep_frac
        self.generator = torch.Generator(
            device=resolve_device(device)).manual_seed(seed)

    def stage_plan(self, task, l_ans):
        return []

    def decide_initial(self, task, batch, visual) -> Decision:
        return torch.ones((batch,), dtype=torch.bool), None

    def gs_view(self, pipeline, task, images, region_feats, text_feats):
        if self.keep_frac is not None and self.keep_frac < 1.0:
            return pipeline.random_view(task, images, self.keep_frac,
                                        self.generator)
        return pipeline.full_view(task, images)


class TabiPolicy(CascadePolicy):
    """Tabi (EuroSys'23): full onboard decode, then one confidence value from
    the answer-token probabilities; offloads transit at full image size."""

    name = "tabi"
    run_onboard = True
    run_gs = True

    def __init__(self, threshold: float = 0.7):
        self.threshold = threshold

    def confidence(self, probs: torch.Tensor) -> torch.Tensor:
        """Mean max answer-token probability (B, L, V) → (B,)."""
        return probs.amax(-1).mean(-1)

    def decide_stage(self, stage, task, tokens, probs, visual,
                     token_feats_fn) -> Decision:
        conf = self.confidence(probs)
        return conf < self.threshold, conf


class AIRGPolicy(CascadePolicy):
    """AI-RG (TMC'24): difficulty-agnostic — a pre-computed offload fraction
    realised by random selection before any decoding."""

    name = "airg"
    run_onboard = True
    run_gs = True

    def __init__(self, fraction_fn: Callable[[str], float], seed: int = 0, *,
                 device: DeviceLike = None):
        self.fraction_fn = fraction_fn
        self.generator = torch.Generator(
            device=resolve_device(device)).manual_seed(seed)

    def decide_initial(self, task, batch, visual) -> Decision:
        rho = self.fraction_fn(task)
        u = torch.rand((batch,), generator=self.generator,
                       device=self.generator.device)
        return u < rho, None
