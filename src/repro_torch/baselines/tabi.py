"""Tabi (EuroSys'23): multi-level inference with a single confidence score.

As compared in §4.1.5 / §4.2: Tabi completes the FULL onboard inference for
every sample, derives one confidence value from the output token
probabilities (mean max-prob), and re-runs low-confidence samples on the
large model.  Its attention-based pruning applies to text tokens, so
offloaded Earth-observation images transit the link at full size.

A ``TabiPolicy`` over the shared ``CascadeExecutor``: one full-answer decode
chunk, one post-decode confidence decision, the full-image GS view.  Only
the latency accounting (text pruning on the GS prompt) stays here.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.baselines.static import _executor
from repro_torch.core.cascade import CascadeConfig, TierModel, eval_loop
from repro_torch.core.latency import DEFAULT_LINK, LatencyModel
from repro_torch.device import DeviceLike, check_on_device, resolve_device
from repro_torch.network.link import LinkModel
from repro_torch.serving.policy import TabiPolicy


class Tabi:
    def __init__(self, sat: TierModel, gs: TierModel,
                 adapter_cfg, cc: Optional[CascadeConfig] = None,
                 latency: Optional[LatencyModel] = None,
                 link: LinkModel = DEFAULT_LINK,
                 threshold: float = 0.7, word_prune_frac: float = 0.3, *,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        check_on_device(self.device, sat=sat.params, gs=gs.params)
        self.sat, self.gs, self.ac = sat, gs, adapter_cfg
        self.cc = cc or CascadeConfig()
        self.lat, self.link = latency or LatencyModel(), link
        self.threshold = threshold
        # attention-based word pruning shortens the GS text prompt only
        self.word_prune_frac = word_prune_frac
        self.policy = TabiPolicy(threshold)

    def confidence(self, probs: torch.Tensor) -> torch.Tensor:
        """Mean max answer-token probability (B, L, V) → (B,)."""
        return self.policy.confidence(probs)

    def run_batch(self, images, prompts, task: str):
        l_ans = self.ac.answer_len(task)
        ex = _executor(self.sat, self.gs, self.ac, self.cc, self.lat,
                       self.link)
        res = ex.run_counterfactual(self.policy, task, images, prompts,
                                    self.cc.answer_vocab)
        offload = res.offload.cpu().numpy()
        # latency: full onboard always; offloaded add full-image tx + GS
        onboard = (self.lat.sat_encode_s() + self.lat.sat_prefill_s()
                   + self.lat.sat_decode_s(l_ans))
        tx = self.lat.tx_s(self.link, self.lat.full_bytes(task))
        text_frac = 1.0 - self.word_prune_frac
        gs_s = 2 * self.lat.gs_params * (
            self.lat.deploy_patches + self.lat.deploy_text * text_frac
            + l_ans) / self.lat.gs_flops
        lat = onboard + offload * (tx + gs_s)
        return {"pred": res.pred, "latency_s": lat, "offload": offload}

    def evaluate(self, task, data, batch_size=32):
        return eval_loop(lambda im, pr: self.run_batch(im, pr, task),
                         task, data, batch_size, self.device)
