"""CascadeExecutor: the one implementation of Algorithm 1.

The port of ``repro.serving.executor``.  ``SpaceVerse.run_batch``,
``CascadeServer.handle`` and the ``baselines`` are thin adapters that pick
a ``CascadePolicy`` and a run mode.  The executor owns the mechanical
sequence

    encode V(x), E(T)  →  stage-0 decision  →  prefill  →
    chunked onboard decode with per-chunk decisions  →
    offload pipeline (Eq. 2 → Eq. 3 → link)  →  GS-tier inference

while the policy owns every decision and the ``OffloadPipeline`` owns what
the GS tier receives.  Two modes:

- ``run_counterfactual``: both branches run for the whole batch and
  decisions are boolean masks (the adapters' latency ledgers charge each
  sample only for the branch it took);
- ``run_serve``: batch of one, decisions take effect: onboard decoding
  stops at the exit stage and only the chosen branch runs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import eo_adapter as EO
from repro_torch.serving.offload import GSView, OffloadPipeline
from repro_torch.serving.policy import CascadePolicy


@dataclasses.dataclass
class ExecutionResult:
    task: str
    batch: int
    l_ans: int
    stage_plan: List[int]
    offload: Any                        # (B,) bool
    exit_stage: Any                     # (B,) int; −1 = answered onboard
    conf_scores: Optional[Any]          # (B, n_decisions)
    sat_tokens: Optional[Any]           # tokens decoded onboard
    sat_probs: Optional[Any]
    sat_pred: Optional[Any]
    gs_tokens: Optional[Any]
    gs_probs: Optional[Any]
    gs_pred: Optional[Any]
    gs_view: Optional[GSView]
    pred: Any
    prefill_ran: bool = False
    ran_stages: List[Tuple[int, int]] = dataclasses.field(
        default_factory=list)          # (stage, tokens decoded AT it)
    fallback_tokens: int = 0           # link-down onboard completion tokens
    fallback_full: bool = False        # fallback needed its own prefill


class CascadeExecutor:
    """Executor over a satellite-tier and a GS-tier ``EngineCore``."""

    def __init__(self, sat_core, gs_core, adapter_cfg,
                 pipeline: OffloadPipeline):
        self.sat_core = sat_core
        self.gs_core = gs_core
        self.ac = adapter_cfg
        self.pipeline = pipeline

    def run_counterfactual(self, policy: CascadePolicy, task: str,
                           images, prompts, answer_vocab: int
                           ) -> ExecutionResult:
        """Vectorised both-branch execution (the batch evaluator's mode)."""
        b = images.shape[0]
        l_ans = self.ac.answer_len(task)
        plan = policy.stage_plan(task, l_ans)
        device = images.device

        rf = tf = vis = None
        if policy.needs_encode:
            rf, tf, vis = self.sat_core.encode(task, images, prompts)

        mask0, s0 = policy.decide_initial(task, b, vis)
        offload = torch.as_tensor(mask0).to(device)
        exit_stage = torch.full((b,), -1, dtype=torch.int32,
                                device=device).masked_fill(offload, 0)
        scores = [s0] if policy.collects_scores else None

        sat_tokens = sat_probs = sat_pred = None
        if policy.run_onboard:
            logits, cache, idx = self.sat_core.prefill(task, images, prompts,
                                                       l_ans)
            toks_all, probs_all = [], []
            for si, n_tok in enumerate(plan):
                stage = si + 1
                if n_tok > 0:
                    toks, probs, cache, logits, idx = \
                        self.sat_core.decode_chunk(cache, logits, idx, n_tok,
                                                   answer_vocab)
                    toks_all.append(toks)
                    probs_all.append(probs)
                gen = torch.cat(toks_all, 1)
                gen_probs = torch.cat(probs_all, 1)
                dec = policy.decide_stage(
                    stage, task, gen, gen_probs, vis,
                    lambda g=gen: self.sat_core.token_features(g))
                if dec is not None:
                    mask, s = dec
                    if scores is not None:
                        scores.append(s)
                    newly = torch.as_tensor(mask).to(device) & (exit_stage < 0)
                    exit_stage = exit_stage.masked_fill(newly, stage)
                    offload = offload | newly
            sat_tokens = (torch.cat(toks_all, 1) if toks_all
                          else torch.zeros((b, l_ans), dtype=torch.int32,
                                           device=device))
            sat_probs = (torch.cat(probs_all, 1) if probs_all
                         else torch.zeros((b, l_ans, answer_vocab),
                                          device=device))
            sat_pred = EO.prediction_from_tokens(task, sat_tokens)

        gs_view = gs_tokens = gs_probs = gs_pred = None
        if policy.run_gs:
            gs_view = policy.gs_view(self.pipeline, task, images, rf, tf)
            gs_tokens, gs_probs = self.gs_core.generate(
                task, gs_view.images, prompts, answer_vocab)
            gs_pred = EO.prediction_from_tokens(task, gs_tokens)

        if sat_pred is None:
            pred = gs_pred
        elif gs_pred is None:
            pred = sat_pred
        else:
            sel = offload[:, None] if task == "det" else offload
            pred = torch.where(sel, gs_pred, sat_pred)

        return ExecutionResult(
            task=task, batch=b, l_ans=l_ans, stage_plan=plan,
            offload=offload, exit_stage=exit_stage,
            conf_scores=torch.stack(scores, 1) if scores else None,
            sat_tokens=sat_tokens, sat_probs=sat_probs, sat_pred=sat_pred,
            gs_tokens=gs_tokens, gs_probs=gs_probs, gs_pred=gs_pred,
            gs_view=gs_view, pred=pred)

    def run_serve(self, policy: CascadePolicy, task: str, images, prompts,
                  answer_vocab: int, allow_offload: bool = True,
                  scene: Optional[Any] = None,
                  prompt_id: Optional[int] = None,
                  priority: int = 0,
                  deadline_s: Optional[float] = None) -> ExecutionResult:
        """Batch-of-one execution with real early exits.

        Onboard decoding stops at the exit stage and only the branch the
        request takes is computed.  With ``allow_offload`` False (link
        down) an offload verdict degrades to onboard completion.  ``scene``
        lets queries over one captured scene reuse the satellite encode;
        ``priority``/``deadline_s`` ride the offload payload's metadata."""
        if images.shape[0] != 1:
            raise ValueError("serve mode is per-request")
        l_ans = self.ac.answer_len(task)
        plan = policy.stage_plan(task, l_ans)
        device = self.sat_core.device

        rf = tf = vis = None
        if policy.needs_encode:
            rf, tf, vis = self.sat_core.encode_cached(task, images, prompts,
                                                      scene=scene,
                                                      prompt_id=prompt_id)

        mask0, s0 = policy.decide_initial(task, 1, vis)
        exit_stage = 0 if bool(mask0[0]) else -1
        scores = [s0] if policy.collects_scores else None

        sat_tokens = None
        cache = logits = idx = None
        prefill_ran = False
        ran_stages: List[Tuple[int, int]] = []
        decoded = 0
        if exit_stage < 0 and policy.run_onboard:
            logits, cache, idx = self.sat_core.prefill(task, images, prompts,
                                                       l_ans)
            prefill_ran = True
            toks_all, probs_all = [], []
            for si, n_tok in enumerate(plan):
                stage = si + 1
                if n_tok > 0:
                    toks, probs, cache, logits, idx = \
                        self.sat_core.decode_chunk(cache, logits, idx, n_tok,
                                                   answer_vocab)
                    toks_all.append(toks.cpu().numpy())
                    probs_all.append(probs)
                    decoded += n_tok
                gen = torch.from_numpy(
                    np.concatenate(toks_all, 1) if toks_all
                    else np.zeros((1, 0), np.int32)).to(device)
                gen_probs = (torch.cat(probs_all, 1) if probs_all else None)
                dec = policy.decide_stage(
                    stage, task, gen, gen_probs, vis,
                    lambda g=gen: self.sat_core.token_features(g))
                ran_stages.append((stage, n_tok))
                if dec is not None:
                    mask, s = dec
                    if scores is not None:
                        scores.append(s)
                    if bool(mask[0]):
                        exit_stage = stage
                        break
            sat_tokens = (np.concatenate(toks_all, 1)[0] if toks_all
                          else None)

        offload = exit_stage >= 0 and allow_offload and policy.run_gs
        gs_view = gs_tokens = gs_probs = gs_pred = None
        fallback_tokens = 0
        fallback_full = False
        if offload:
            gs_view = policy.gs_view(self.pipeline, task, images, rf, tf)
            self.pipeline.attach_urgency(gs_view, priority, deadline_s)
            if self.gs_core.cfg.spec_gamma:
                # speculative GS inference: the satellite's partial answer
                # (decoded before the offload verdict) rides the downlink as
                # the verifier's first drafts
                drafts = self.pipeline.attach_draft(gs_view, sat_tokens)
                gs_toks, gs_probs = self.gs_core.generate_spec(
                    task, gs_view.images, prompts, answer_vocab,
                    draft_tokens=drafts, priority=priority,
                    deadline_s=deadline_s)
            else:
                gs_toks, gs_probs = self.gs_core.generate(
                    task, gs_view.images, prompts, answer_vocab)
            gs_tokens = gs_toks.cpu().numpy()
            gs_pred = EO.prediction_from_tokens(task, gs_tokens)
            tokens = gs_tokens[0]
        else:
            if sat_tokens is None:
                # offload wanted but unavailable before any decoding: run the
                # full answer onboard (graceful degradation)
                logits, cache, idx = self.sat_core.prefill(
                    task, images, prompts, l_ans)
                toks, _, cache, logits, idx = self.sat_core.decode_chunk(
                    cache, logits, idx, l_ans, answer_vocab)
                sat_tokens = toks.cpu().numpy()[0]
                fallback_tokens = l_ans
                fallback_full = True
            elif decoded < l_ans:
                # exit mid-decode with the link down: finish from the cache
                toks, _, cache, logits, idx = self.sat_core.decode_chunk(
                    cache, logits, idx, l_ans - decoded, answer_vocab)
                sat_tokens = np.concatenate(
                    [sat_tokens, toks.cpu().numpy()[0]])
                fallback_tokens = l_ans - decoded
            tokens = sat_tokens

        pred = tokens[0] if task in ("vqa", "cls") else tokens
        conf = None
        if scores:
            conf = np.stack([s.cpu().numpy() for s in scores], 1)
        sat_pred = None
        if sat_tokens is not None and len(sat_tokens) == l_ans:
            sat_pred = EO.prediction_from_tokens(task, sat_tokens[None])
        return ExecutionResult(
            task=task, batch=1, l_ans=l_ans, stage_plan=plan,
            offload=np.asarray([offload]),
            exit_stage=np.asarray([exit_stage]),
            conf_scores=conf, sat_tokens=sat_tokens, sat_probs=None,
            sat_pred=sat_pred,
            gs_tokens=gs_tokens, gs_probs=gs_probs, gs_pred=gs_pred,
            gs_view=gs_view, pred=pred,
            prefill_ran=prefill_ran, ran_stages=ran_stages,
            fallback_tokens=fallback_tokens, fallback_full=fallback_full)
