"""Analytic latency model, calibrated to the paper's testbed (§4.1, Fig. 4).

Accuracy in our reproduction comes from really-executed proxy LVLMs; latency
comes from this model evaluated at the paper's DEPLOYED pair (Qwen2-VL-2B on
a Jetson AGX Xavier, Qwen2-VL-7B on 8×RTX 3090) and its measured link
(110.67 Mb/s).  Calibration targets from the paper:
 - GS-only ≈ 4.14× satellite-only latency on DOTA,
 - transmission ≈ 76.4 % of GS-only time,
 - contact windows ≈ 4.33 % of the orbital period (throughput studies).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.network.link import LinkModel
from repro_torch.network.orbit import ContactPlan


@dataclasses.dataclass(frozen=True)
class LatencyModel:
    sat_params: float = 2.0e9           # W^s  (Qwen2-VL-2B)
    gs_params: float = 7.6e9            # W^g  (Qwen2-VL-7B)
    sat_flops: float = 20.0e12          # Jetson AGX Xavier effective
    gs_flops: float = 220.0e12          # 8×RTX 3090 effective
    deploy_patches: int = 1024          # vision tokens at deployment scale
    deploy_text: int = 32
    conf_net_flops: float = 2.0e6       # g̃ stage, negligible but counted
    # raw downlink bytes per task, calibrated so GS-only/satellite-only
    # ratios match Fig. 4/9 (det ≈ 4.1×, tx ≈ 76–90 % of GS-only time):
    # RSVQA-LR / RESISC tiles at processed resolution, DOTA-like 2048² scenes
    task_bytes: Dict[str, float] = dataclasses.field(default_factory=lambda: {
        "vqa": 1024 * 1024 * 3.0, "cls": 1024 * 1024 * 3.0,
        "det": 2048 * 2048 * 3.0})

    def prompt_tokens(self) -> int:
        return self.deploy_patches + self.deploy_text

    def sat_prefill_s(self) -> float:
        return 2 * self.sat_params * self.prompt_tokens() / self.sat_flops

    def sat_decode_s(self, n_tokens: float) -> float:
        return 2 * self.sat_params * n_tokens / self.sat_flops

    def sat_encode_s(self) -> float:
        """Visual+text encoding only (stage-1 confidence runs after this)."""
        return 0.15 * self.sat_prefill_s()

    def conf_stage_s(self) -> float:
        return self.conf_net_flops / self.sat_flops

    def gs_infer_s(self, n_answer_tokens: float, kept_fraction: float = 1.0
                   ) -> float:
        """W^g prefill (scaled by surviving vision tokens) + decode."""
        toks = self.deploy_patches * kept_fraction + self.deploy_text
        return 2 * self.gs_params * (toks + n_answer_tokens) / self.gs_flops

    def full_bytes(self, task: str) -> float:
        return self.task_bytes[task]

    def tx_s(self, link: LinkModel, n_bytes: float) -> float:
        return link.tx_seconds(n_bytes, sample_jitter=False)


DEFAULT_LINK = LinkModel(jitter_sigma=0.0)
DEFAULT_PLAN = ContactPlan(alt_km=570.0, num_gs=1)
