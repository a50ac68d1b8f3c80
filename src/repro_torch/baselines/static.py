"""Status-quo baselines (§4.1.5): satellite-only and GS-only.

Both are thin adapters over the shared ``CascadeExecutor`` with static
policies (``SatelliteOnlyPolicy`` / ``GroundOnlyPolicy``), the executor that
runs SpaceVerse and the request server, so baseline and cascade numbers come
from the same forward-pass code.  GS-only optionally applies the naive
random-masking reduction of the Fig. 3 / Fig. 12 studies.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core import eo_adapter as EO
from repro_torch.core.cascade import CascadeConfig, TierModel, eval_loop
from repro_torch.core.latency import DEFAULT_LINK, LatencyModel
from repro_torch.device import DeviceLike, check_on_device, resolve_device
from repro_torch.network.link import LinkModel
from repro_torch.serving.engine_core import shared_core
from repro_torch.serving.executor import CascadeExecutor
from repro_torch.serving.offload import OffloadPipeline
from repro_torch.serving.policy import GroundOnlyPolicy, SatelliteOnlyPolicy


def _executor(tier_a: TierModel, tier_b: TierModel,
              adapter_cfg: EO.EOAdapterConfig, cc: CascadeConfig,
              latency: LatencyModel, link: LinkModel) -> CascadeExecutor:
    pipeline = OffloadPipeline(adapter_cfg, cc, latency, link=link)
    return CascadeExecutor(shared_core(tier_a, adapter_cfg),
                           shared_core(tier_b, adapter_cfg),
                           adapter_cfg, pipeline)


class SatelliteOnly:
    """Everything runs on the compact onboard model."""

    def __init__(self, sat: TierModel, adapter_cfg: EO.EOAdapterConfig,
                 cc: Optional[CascadeConfig] = None,
                 latency: Optional[LatencyModel] = None, *,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        check_on_device(self.device, sat=sat.params)
        self.sat, self.ac = sat, adapter_cfg
        self.cc = cc or CascadeConfig()
        self.lat = latency or LatencyModel()
        self.policy = SatelliteOnlyPolicy()

    def run_batch(self, images, prompts, task: str):
        ex = _executor(self.sat, self.sat, self.ac, self.cc, self.lat,
                       DEFAULT_LINK)
        res = ex.run_counterfactual(self.policy, task, images, prompts,
                                    self.cc.answer_vocab)
        l_ans = self.ac.answer_len(task)
        lat = (self.lat.sat_encode_s() + self.lat.sat_prefill_s()
               + self.lat.sat_decode_s(l_ans))
        return {"pred": res.pred,
                "latency_s": np.full((images.shape[0],), lat)}

    def evaluate(self, task, data, batch_size=32):
        return eval_loop(lambda im, pr: self.run_batch(im, pr, task),
                         task, data, batch_size, self.device)


class GSOnly:
    """Everything offloads; raw images transit the link (optionally with the
    naive random-masking reduction at ``keep_frac``)."""

    def __init__(self, gs: TierModel, adapter_cfg: EO.EOAdapterConfig,
                 cc: Optional[CascadeConfig] = None,
                 latency: Optional[LatencyModel] = None,
                 link: LinkModel = DEFAULT_LINK,
                 keep_frac: Optional[float] = None, seed: int = 0, *,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        check_on_device(self.device, gs=gs.params)
        self.gs, self.ac = gs, adapter_cfg
        self.cc = cc or CascadeConfig()
        self.lat, self.link = latency or LatencyModel(), link
        self.keep_frac = keep_frac
        self.policy = GroundOnlyPolicy(keep_frac=keep_frac, seed=seed,
                                       device=self.device)

    def run_batch(self, images, prompts, task: str):
        b = images.shape[0]
        ex = _executor(self.gs, self.gs, self.ac, self.cc, self.lat,
                       self.link)
        res = ex.run_counterfactual(self.policy, task, images, prompts,
                                    self.cc.answer_vocab)
        frac = np.asarray(res.gs_view.bytes_frac)
        full_bytes = self.lat.full_bytes(task)
        l_ans = self.ac.answer_len(task)
        tx = np.array([self.lat.tx_s(self.link, full_bytes * f)
                       for f in frac])
        gs_s = np.asarray(self.lat.gs_infer_s(l_ans, res.gs_view.kept_frac))
        return {"pred": res.pred, "latency_s": tx + gs_s,
                "offload": np.ones((b,), bool)}

    def evaluate(self, task, data, batch_size=32):
        return eval_loop(lambda im, pr: self.run_batch(im, pr, task),
                         task, data, batch_size, self.device)
