"""Request-level SpaceVerse server: the deployable face of Algorithm 1.

The port of ``repro.serving.cascade_server``.  It processes a request stream
the way the satellite would: progressive confidence exits decide per
request, offloaded requests go through Eq. 2/Eq. 3 preprocessing, a
simulated link with contact windows, and the ground tier.  Every model
decision and forward pass happens in the shared ``CascadeExecutor``; this
class owns the transmission scheduler and the per-request latency ledger.

It runs on the card unless ``device="cpu"`` is asked for, and the tiers'
weights must already lie on that device.  With ``spec_gamma > 0`` offloaded
requests decode speculatively at the ground station: the satellite tier
drafts, and its piggybacked partial answer seeds the first verify chunks;
the tokens stay the greedy engine's.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import eo_adapter as EO
from repro_torch.core.cascade import CascadeConfig, TierModel
from repro_torch.core.latency import DEFAULT_LINK, LatencyModel
from repro_torch.device import DeviceLike, check_on_device, resolve_device
from repro_torch.network.link import LinkModel
from repro_torch.network.orbit import ContactPlan
from repro_torch.network.scheduler import TransmissionScheduler
from repro_torch.serving.engine_core import (EngineCore, EngineCoreConfig,
                                             shared_core)
from repro_torch.serving.executor import CascadeExecutor
from repro_torch.serving.offload import OffloadPipeline
from repro_torch.serving.policy import ProgressiveConfidencePolicy
from repro_torch.serving.request import Request, Response, scene_key


class CascadeServer:
    def __init__(self, sat: TierModel, gs: TierModel,
                 adapter_cfg: EO.EOAdapterConfig, conf_params,
                 cascade_cfg: Optional[CascadeConfig] = None,
                 latency: Optional[LatencyModel] = None,
                 link: LinkModel = DEFAULT_LINK,
                 plan: Optional[ContactPlan] = None,
                 link_up: bool = True, tx_jitter: bool = False,
                 spec_gamma: int = 0, *, device: DeviceLike = None):
        self.device = resolve_device(device)
        check_on_device(self.device, sat=sat.params, gs=gs.params,
                        conf=conf_params)
        self.sat, self.gs = sat, gs
        self.ac, self.conf = adapter_cfg, conf_params
        self.cc = cascade_cfg or CascadeConfig()
        self.lat = latency or LatencyModel()
        self.link = link
        self.plan = plan or ContactPlan(contact_fraction_override=1.0)
        self.scheduler = TransmissionScheduler(self.plan, self.link)
        self.link_up = link_up
        self.tx_jitter = tx_jitter
        self._gs_spec_core = None
        if spec_gamma:
            self._gs_spec_core = EngineCore(
                gs, adapter_cfg,
                EngineCoreConfig(slots=1, answer_vocab=self.cc.answer_vocab,
                                 spec_gamma=spec_gamma),
                draft=sat)

    def warmup(self) -> None:
        """Allocate the speculative GS core's slot tables and bind its
        kernels, so the first offloaded request pays for neither.  No-op
        when ``spec_gamma == 0``: the batch path allocates per call."""
        if self._gs_spec_core is not None:
            self._gs_spec_core.warmup()

    # ------------------------------------------------------------------
    def _pipeline(self) -> OffloadPipeline:
        # built per request so runtime config changes (self.cc) apply
        return OffloadPipeline(self.ac, self.cc, self.lat,
                               link=self.link, scheduler=self.scheduler)

    def _executor(self, pipeline: OffloadPipeline) -> CascadeExecutor:
        gs_core = self._gs_spec_core or shared_core(self.gs, self.ac)
        return CascadeExecutor(shared_core(self.sat, self.ac), gs_core,
                               self.ac, pipeline)

    def _policy(self) -> ProgressiveConfidencePolicy:
        return ProgressiveConfidencePolicy(self.conf, self.cc)

    # ------------------------------------------------------------------
    def handle(self, req: Request, now: float = 0.0) -> Response:
        images = torch.as_tensor(np.asarray(req.image)[None],
                                 device=self.device)
        prompts = torch.tensor([req.prompt], dtype=torch.int32,
                               device=self.device)
        l_ans = self.ac.answer_len(req.task)

        pipeline = self._pipeline()
        res = self._executor(pipeline).run_serve(
            self._policy(), req.task, images, prompts, self.cc.answer_vocab,
            allow_offload=self.link_up, scene=scene_key(req),
            prompt_id=req.prompt, priority=req.priority,
            deadline_s=req.deadline_s)
        exit_stage = int(res.exit_stage[0])
        offload = bool(res.offload[0])

        # -- per-request latency ledger ------------------------------------
        timings: Dict[str, float] = {
            "encode": self.lat.sat_encode_s(),
            "confidence": self.lat.conf_stage_s(),
        }
        if res.prefill_ran:
            timings["sat_prefill"] = self.lat.sat_prefill_s()
        for stage, n_tok in res.ran_stages:
            if n_tok > 0:
                timings[f"sat_decode_{stage}"] = self.lat.sat_decode_s(n_tok)
            timings[f"confidence_{stage}"] = self.lat.conf_stage_s()

        if offload:
            kept = float(res.gs_view.kept_frac[0])
            n_bytes = float(pipeline.payload_bytes(
                req.task, res.gs_view.bytes_frac[0]))
            tr = pipeline.transmit_scheduled(now, n_bytes,
                                             sample_jitter=self.tx_jitter)
            timings["tx"] = tr.t_done - tr.t_submit
            timings["gs_infer"] = self.lat.gs_infer_s(l_ans, kept)
            tokens = res.gs_tokens[0]
            tier = "ground"
        else:
            if res.fallback_full:
                timings["sat_fallback"] = (self.lat.sat_prefill_s()
                                           + self.lat.sat_decode_s(l_ans))
            elif res.fallback_tokens:
                timings["sat_fallback"] = self.lat.sat_decode_s(
                    res.fallback_tokens)
            tokens = res.sat_tokens
            n_bytes = 0.0
            tier = "satellite"

        pred = tokens[0] if req.task in ("vqa", "cls") else tokens
        return Response(
            request_id=req.request_id, tokens=tokens, pred=pred, tier=tier,
            exit_stage=exit_stage, latency_s=float(sum(timings.values())),
            tx_bytes=n_bytes if offload else 0.0, timings=timings)
