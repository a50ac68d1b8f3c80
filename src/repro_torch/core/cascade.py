"""SpaceVerse cascade orchestrator: Algorithm 1, the batch evaluator.

The port of ``repro.core.cascade``.  Per input (x_k, T_k):
 1. encode regions V(x_k) and prompt E(T_k) with the onboard model W^s;
 2. progressive confidence: stage 1 from pooled V(x) alone; stages i>1 after
    each additional chunk of N_t generated tokens; a score below τ_i aborts
    onboard decoding and offloads;
 3. offloaded samples pass Eq. (2) region scoring + Eq. (3) multi-scale
    preprocessing, transit the simulated link, and are answered by W^g;
 4. surviving samples answer onboard.

The model execution lives in the shared ``serving.executor.CascadeExecutor``
driven by a ``ProgressiveConfidencePolicy``, which the request server
``serving.cascade_server.CascadeServer`` also routes through.  This class
is the counterfactual-evaluation adapter: the whole batch is vectorised,
decisions are boolean masks, both branches are computed, and the latency
ledger charges each sample only for the branch it took.  Accuracy comes from
the executed models; per-sample latency from ``LatencyModel`` at the
paper's deployment pair.

``SpaceVerse`` runs on the card unless ``device="cpu"`` is asked for, and
the tiers' and confidence net's weights must already lie on that device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import eo_adapter as EO
from repro_torch.core.latency import DEFAULT_LINK, LatencyModel
from repro_torch.core.similarity import task_simi
from repro_torch.device import DeviceLike, check_on_device, resolve_device
from repro_torch.network.link import LinkModel

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class CascadeConfig:
    taus: Tuple[float, ...] = (0.5, 0.4)      # τ_1..τ_I (paper §4.1.4)
    alpha: float = 0.35
    beta: float = 0.55
    n_t: int = 8                               # tokens per progressive chunk
    answer_vocab: int = 64


@dataclasses.dataclass
class TierModel:
    params: Params
    cfg: ArchConfig


def eval_loop(run_batch, task: str, data: Dict[str, np.ndarray],
              batch_size: int, device: torch.device) -> Dict[str, Any]:
    """Run ``run_batch(images, prompts)`` over ``data`` in slices of
    ``batch_size`` moved to ``device``, and score the predictions with
    ``task_simi`` against ``labels`` (det: ``region_rel``)."""
    n = data["images"].shape[0]
    outs = []
    for i in range(0, n, batch_size):
        sl = slice(i, min(i + batch_size, n))
        outs.append(run_batch(torch.from_numpy(data["images"][sl]).to(device),
                              torch.from_numpy(data["prompts"][sl]).to(device)))
    pred = np.concatenate([o["pred"].cpu().numpy() for o in outs])
    lat_s = np.concatenate([o["latency_s"] for o in outs])
    label = (data["region_rel"] if task == "det" else data["labels"])[:n]
    simi = task_simi(task, torch.from_numpy(pred),
                     torch.from_numpy(np.asarray(label))).numpy()
    out = {"performance": float(simi.mean()), "latency_s": float(lat_s.mean()),
           "per_sample_latency": lat_s, "per_sample_simi": simi}
    if "offload" in outs[0]:
        off = np.concatenate([torch.as_tensor(o["offload"]).cpu().numpy()
                              for o in outs])
        out["offload_rate"] = float(off.mean())
        out["offload"] = off
    return out


class SpaceVerse:
    """Two-tier cascade with progressive confidence + multi-scale preprocess."""

    def __init__(self, sat: TierModel, gs: TierModel,
                 adapter_cfg: EO.EOAdapterConfig, conf_params: Params,
                 cascade_cfg: Optional[CascadeConfig] = None,
                 latency: Optional[LatencyModel] = None,
                 link: LinkModel = DEFAULT_LINK, *,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        check_on_device(self.device, sat=sat.params, gs=gs.params,
                        conf=conf_params)
        self.sat = sat
        self.gs = gs
        self.adapter_cfg = adapter_cfg
        self.conf = conf_params
        self.cc = cascade_cfg or CascadeConfig()
        self.lat = latency or LatencyModel()
        self.link = link

    # ------------------------------------------------------------------
    def _pipeline(self):
        from repro_torch.serving.offload import OffloadPipeline
        return OffloadPipeline(self.adapter_cfg, self.cc, self.lat,
                               link=self.link)

    def _executor(self, pipeline):
        from repro_torch.serving.engine_core import shared_core
        from repro_torch.serving.executor import CascadeExecutor
        return CascadeExecutor(shared_core(self.sat, self.adapter_cfg),
                               shared_core(self.gs, self.adapter_cfg),
                               self.adapter_cfg, pipeline)

    def _policy(self):
        from repro_torch.serving.policy import ProgressiveConfidencePolicy
        return ProgressiveConfidencePolicy(self.conf, self.cc)

    def _stage_plan(self, task: str) -> Sequence[int]:
        """Token counts decoded before confidence stages 2..I (the last stage
        always sees the complete output)."""
        return self._policy().stage_plan(task,
                                         self.adapter_cfg.answer_len(task))

    # ------------------------------------------------------------------
    def run_batch(self, task: str, images: torch.Tensor,
                  prompts: torch.Tensor) -> Dict[str, Any]:
        lat = self.lat
        b = images.shape[0]
        l_ans = self.adapter_cfg.answer_len(task)

        pipeline = self._pipeline()
        res = self._executor(pipeline).run_counterfactual(
            self._policy(), task, images, prompts, self.cc.answer_vocab)

        view = res.gs_view
        # modelled raw-image bytes scaled by the achieved Eq. 3 compression
        tx_bytes = pipeline.payload_bytes(task, view.bytes_frac)    # (B,)
        kept_frac = view.kept_frac

        # --- latency ledger (numpy float64) --------------------------------
        plan = res.stage_plan
        lat_s = np.full((b,), lat.sat_encode_s() + lat.conf_stage_s())
        exit_np = res.exit_stage.cpu().numpy()
        # onboard decode cost: tokens decoded before this sample's exit
        toks_before = np.zeros((b,))
        for si in range(len(plan)):
            ran_chunk = (exit_np < 0) | (exit_np >= si + 1)
            toks_before += np.where(ran_chunk, plan[si], 0)
        ran_prefill = exit_np != 0
        lat_s += ran_prefill * lat.sat_prefill_s()
        lat_s += lat.sat_decode_s(toks_before)
        lat_s += np.maximum(exit_np, 0) * lat.conf_stage_s()
        tx_s = np.array([pipeline.transmit_analytic(byt)
                         for byt in tx_bytes])
        gs_s = np.asarray(lat.gs_infer_s(l_ans, np.asarray(kept_frac)))
        lat_s += res.offload.cpu().numpy() * (tx_s + gs_s)

        return {
            "pred": res.pred, "offload": res.offload,
            "exit_stage": res.exit_stage,
            "conf_scores": res.conf_scores,
            "sat_pred": res.sat_pred, "gs_pred": res.gs_pred,
            "sat_probs": res.sat_probs, "gs_probs": res.gs_probs,
            "tx_bytes": tx_bytes, "latency_s": lat_s,
            "kept_frac": np.asarray(kept_frac),
            "region_scores": view.region_scores,
        }

    # ------------------------------------------------------------------
    def evaluate(self, task: str, data: Dict[str, np.ndarray],
                 batch_size: int = 32) -> Dict[str, Any]:
        return eval_loop(lambda im, pr: self.run_batch(task, im, pr), task,
                         data, batch_size, self.device)
