"""Shared offload pipeline: Eq. 2 region scoring → Eq. 3 multiscale filter →
transmission → GS-tier inference.

The port of ``repro.serving.offload``.  A ``GSView`` describes what the
ground station receives:

- ``images``        the (possibly filtered) pixels the GS model runs on;
- ``bytes_frac``    per-sample fraction of the task's full raw-image bytes
  actually transmitted;
- ``kept_frac``     fraction of vision tokens surviving the filter;
- ``region_scores`` Eq. 2 normalised K(x^r) when computed.

Transmission has two modes matching the two entry points: the analytic
per-sample expectation (``transmit_analytic``, the batch evaluator's
latency ledger) and the window-aware scheduler (``transmit_scheduled``, the
request server).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core import preprocess as PP
from repro_torch.core import region_attention as RA
from repro_torch.data import synthetic


@dataclasses.dataclass
class GSView:
    images: torch.Tensor                  # (B, H, W, C) what the GS tier sees
    bytes_frac: np.ndarray                # (B,) fraction of full task bytes
    kept_frac: np.ndarray                 # (B,) surviving vision-token frac
    region_scores: Optional[torch.Tensor]  # (B, R) Eq. 2 normalised scores
    meta: Dict[str, Any]


class OffloadPipeline:
    """Eq. 2 + Eq. 3 preprocessing and link transmission for offloads."""

    def __init__(self, adapter_cfg, cascade_cfg, latency, link=None,
                 scheduler=None):
        self.ac = adapter_cfg
        self.cc = cascade_cfg
        self.lat = latency
        self.link = link
        self.scheduler = scheduler

    # -- views --------------------------------------------------------------
    def multiscale_view(self, task: str, images: torch.Tensor,
                        region_feats: torch.Tensor, text_feats: torch.Tensor
                        ) -> GSView:
        """Eq. 2 scoring + Eq. 3 attention-guided multiscale filtering."""
        regions = synthetic.regions_of(images, self.ac.grid)
        _, norm = RA.score_regions(region_feats[:, :, None, :], text_feats)
        filtered, txb, meta = PP.multiscale_filter(
            regions, norm, alpha=self.cc.alpha, beta=self.cc.beta)
        gs_images = synthetic.assemble(filtered, self.ac.grid)
        comp = txb.cpu().numpy() / np.maximum(
            meta["full_bytes"].cpu().numpy(), 1.0)
        kept = 1.0 - meta["discarded"].cpu().numpy().mean(-1)
        return GSView(images=gs_images, bytes_frac=comp, kept_frac=kept,
                      region_scores=norm, meta=meta)

    def full_view(self, task: str, images: torch.Tensor) -> GSView:
        b = images.shape[0]
        return GSView(images=images, bytes_frac=np.ones((b,)),
                      kept_frac=np.ones((b,)), region_scores=None, meta={})

    def random_view(self, task: str, images: torch.Tensor, keep_frac: float,
                    generator: torch.Generator) -> GSView:
        """Naive random-masking reduction (GS-only ablation, Fig. 3/12)."""
        regions = synthetic.regions_of(images, self.ac.grid)
        filt, _, meta = PP.random_mask_filter(regions, keep_frac, generator)
        gs_images = synthetic.assemble(filt, self.ac.grid)
        frac = meta["kept"].cpu().numpy().mean(-1)
        return GSView(images=gs_images, bytes_frac=frac, kept_frac=frac,
                      region_scores=None, meta=meta)

    # -- draft piggybacking -------------------------------------------------
    def attach_draft(self, view: GSView, sat_tokens) -> Optional[np.ndarray]:
        """Piggyback the satellite's already-decoded answer tokens on the
        offload payload as the GS verifier's first drafts.  They ride the
        same downlink as the filtered image (a few int32s, recorded in
        ``view.meta``); a wrong draft costs accept rate, never output
        correctness.  Returns the drafts, or None when nothing was decoded
        onboard."""
        if sat_tokens is None or len(sat_tokens) == 0:
            return None
        toks = np.asarray(sat_tokens, np.int32).reshape(-1)
        view.meta["draft_tokens"] = toks
        view.meta["draft_bytes"] = int(toks.size * 4)
        return toks

    # -- urgency metadata ---------------------------------------------------
    def attach_urgency(self, view: GSView, priority: int = 0,
                       deadline_s: Optional[float] = None) -> GSView:
        """Stamp the request's scheduling urgency onto the downlink payload
        metadata (the GS side only sees what rides the link)."""
        view.meta["priority"] = int(priority)
        if deadline_s is not None:
            view.meta["deadline_s"] = float(deadline_s)
        return view

    # -- transmission -------------------------------------------------------
    def payload_bytes(self, task: str, bytes_frac) -> np.ndarray:
        """Modelled raw-image downlink bytes scaled by achieved compression."""
        return self.lat.full_bytes(task) * np.asarray(bytes_frac)

    def transmit_analytic(self, n_bytes: float) -> float:
        """Mean air time on the measured link (batch evaluator's ledger)."""
        return self.lat.tx_s(self.link, n_bytes)

    def transmit_scheduled(self, now: float, n_bytes: float,
                           sample_jitter: bool = False):
        """Window-aware scheduled transfer; returns the scheduler's
        completion record."""
        return self.scheduler.submit(now, n_bytes,
                                     sample_jitter=sample_jitter)
