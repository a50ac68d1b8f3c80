"""AI-RG (He et al., TMC'24): active inference with rewardless guidance.

As characterised in §4.1.5/§4.3: AI-RG jointly optimises computation and
communication (offloaded samples skip onboard inference entirely) but its
offloading policy is **difficulty-agnostic**: it picks an offload
*fraction* by minimising an expected-free-energy style cost over
latency/load beliefs, then selects the samples at random.

An ``AIRGPolicy`` over the shared ``CascadeExecutor``: the free-energy
fraction selection stays here (latency-belief arithmetic in numpy), the
random realisation is the policy's stage-0 decision, and offloads take the
full-image GS view.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.baselines.static import _executor
from repro_torch.core.cascade import CascadeConfig, TierModel, eval_loop
from repro_torch.core.latency import DEFAULT_LINK, LatencyModel
from repro_torch.device import DeviceLike, check_on_device, resolve_device
from repro_torch.network.link import LinkModel
from repro_torch.serving.policy import AIRGPolicy


class AIRG:
    def __init__(self, sat: TierModel, gs: TierModel, adapter_cfg,
                 cc: Optional[CascadeConfig] = None,
                 latency: Optional[LatencyModel] = None,
                 link: LinkModel = DEFAULT_LINK,
                 latency_weight: float = 0.4, seed: int = 0,
                 offload_fraction: Optional[float] = None, *,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        check_on_device(self.device, sat=sat.params, gs=gs.params)
        self.sat, self.gs, self.ac = sat, gs, adapter_cfg
        self.cc = cc or CascadeConfig()
        self.lat, self.link = latency or LatencyModel(), link
        self.latency_weight = latency_weight
        self._frac = offload_fraction   # None → choose by free-energy min.
        self.policy = AIRGPolicy(self.plan_fraction, seed=seed,
                                 device=self.device)

    # -- expected-free-energy style fraction selection --------------------
    def plan_fraction(self, task: str) -> float:
        if self._frac is not None:
            return self._frac
        l_ans = self.ac.answer_len(task)
        t_sat = (self.lat.sat_encode_s() + self.lat.sat_prefill_s()
                 + self.lat.sat_decode_s(l_ans))
        t_gs = (self.lat.tx_s(self.link, self.lat.full_bytes(task))
                + self.lat.gs_infer_s(l_ans))
        # beliefs: GS answers are better by a fixed prior margin; latency and
        # (1 - accuracy) trade off through latency_weight.
        acc_gain_belief = 0.25
        best, best_cost = 0.0, np.inf
        for rho in np.linspace(0.0, 1.0, 21):
            # expected free energy: latency belief (with link congestion
            # growing in the offload fraction) + accuracy-loss belief
            e_lat = (1 - rho) * t_sat + rho * t_gs * (1.0 + rho)
            e_acc_loss = (1 - rho) * acc_gain_belief
            cost = self.latency_weight * e_lat / max(t_gs, 1e-9) \
                + (1 - self.latency_weight) * e_acc_loss
            if cost < best_cost:
                best, best_cost = rho, cost
        return float(best)

    def run_batch(self, images, prompts, task: str):
        l_ans = self.ac.answer_len(task)
        ex = _executor(self.sat, self.gs, self.ac, self.cc, self.lat,
                       self.link)
        res = ex.run_counterfactual(self.policy, task, images, prompts,
                                    self.cc.answer_vocab)
        offload = res.offload.cpu().numpy()

        t_onboard = (self.lat.sat_encode_s() + self.lat.sat_prefill_s()
                     + self.lat.sat_decode_s(l_ans))
        tx = self.lat.tx_s(self.link, self.lat.full_bytes(task))
        gs_s = self.lat.gs_infer_s(l_ans)
        lat = np.where(offload, tx + gs_s, t_onboard)
        return {"pred": res.pred, "latency_s": lat, "offload": offload}

    def evaluate(self, task, data, batch_size=32):
        return eval_loop(lambda im, pr: self.run_batch(im, pr, task),
                         task, data, batch_size, self.device)
