"""Batched inference engine: slot-based continuous batching over the
``EngineCore`` slot table.

The port of ``repro.serving.engine``.  The engine owns a fixed number of
batch slots.  Arriving requests are admitted into free slots in ONE
``admit_many`` call per refill; every ``EngineCore.step()`` advances all
active slots by one decode token (or, with ``spec_gamma``, by up to γ+1
verified tokens) through one batched call with per-slot cache positions;
finished slots free at once and are refilled mid-stream, so the batch never
drains to admit the next request.  The KV cache behind the slots is paged
by default: queries over one captured scene share the image-region prefix
pages read-only and only prefill their prompt token.  With
``EngineConfig(prefill_chunk=C)`` a new scene's region prefill streams
into its pages C tokens at a time inside the steps, next to the decoding
slots, instead of running at admission.  With
``EngineConfig(overload=OverloadConfig(...))`` ``serve`` submits the
requests once to the engine's bounded priority queue, which admits them
page-pool-aware, preempts and rejects under saturation
(``last_rejected``).  With ``EngineConfig(mesh=...)`` the core comes from
``serving.sharded.make_engine_core``: a tensor-parallel ``EngineCore`` for
a mesh whose data axis is 1, a ``ShardedEngineCore`` (one engine per data
shard behind a scene-affine router) above that.

It runs on the card unless ``device="cpu"`` is asked for, and the weights
must already lie on that device.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import eo_adapter as EO
from repro_torch.core.cascade import TierModel
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.serving.admission import OverloadConfig
from repro_torch.serving.engine_core import EngineCoreConfig, check_ported
from repro_torch.serving.sharded import make_engine_core
from repro_torch.serving.request import Request, Response
from repro_torch.tree import tree_leaves


@dataclasses.dataclass
class EngineConfig:
    slots: int = 8
    max_new_tokens: int = 64
    answer_vocab: int = 64
    step_impl: str = "batched"          # "batched" ("vmap": not ported)
    cache_impl: str = "paged"           # "paged" | "dense" (oracle)
    page_size: int = 8                  # KV tokens per page (paged only)
    prefix_cache_scenes: Optional[int] = None   # resident scenes (→ slots)
    #: speculative decoding: γ compact-model draft tokens verified per step
    #: (0 = off).  Needs a ``draft`` tier passed to ``InferenceEngine``.
    spec_gamma: int = 0
    #: chunked prefill: region tokens per fused step and scene (0 = off)
    prefill_chunk: int = 0
    token_budget: Optional[int] = None  # fused-step tokens (→ slots + chunk)
    #: explicit KV pool size in pages (None → worst-case bound)
    pool_pages: Optional[int] = None
    #: explicit KV pool size as a device byte budget (paged only; the page
    #: count follows the kv_dtype page size, see EngineCoreConfig)
    pool_bytes: Optional[int] = None
    #: KV page storage: None = the model dtype, "int8" / "fp8" = quantized
    #: pages with per-(page, slot, head) scales, read by the paged kernels
    kv_dtype: Optional[str] = None
    #: ``launch.mesh.Mesh`` with ("data", "model") axes, or None (one
    #: device): the "model" axis splits the core's steps over the mesh's
    #: process group, a "data" axis above 1 splits the slot table into
    #: per-shard engines behind a scene-affine router (serving/sharded.py)
    mesh: Optional[Any] = None
    #: overload control: page-pool-aware admission, bounded priority queue,
    #: deadline expiry and priority preemption (None = off; see
    #: serving/admission.py)
    overload: Optional[OverloadConfig] = None

    def __post_init__(self):
        check_ported(self)


class InferenceEngine:
    """Single-tier engine over an EO-adapted backbone.

    With ``EngineConfig(spec_gamma=γ)`` and a compact ``draft`` tier the
    engine decodes speculatively: the draft model proposes γ tokens per
    slot and this tier verifies them in one multi-token scoring step, so
    the token streams stay exactly the greedy streams."""

    def __init__(self, params, cfg: ArchConfig,
                 adapter_cfg: EO.EOAdapterConfig,
                 engine_cfg: Optional[EngineConfig] = None,
                 tier: str = "satellite", draft: Optional[TierModel] = None,
                 *, device: DeviceLike = None):
        self.device = resolve_device(device)
        trees = [params] + ([draft.params] if draft is not None else [])
        for tree in trees:
            for t in tree_leaves(tree):
                if t.device.type != self.device.type:
                    raise ValueError(f"weights lie on {t.device}, the "
                                     f"engine on {self.device}")
        self.params = params
        self.cfg = cfg
        self.ac = adapter_cfg
        self.ec = engine_cfg or EngineConfig()
        self.tier = tier
        self.core = make_engine_core(
            TierModel(params, cfg), adapter_cfg,
            EngineCoreConfig(slots=self.ec.slots,
                             answer_vocab=self.ec.answer_vocab,
                             step_impl=self.ec.step_impl,
                             cache_impl=self.ec.cache_impl,
                             page_size=self.ec.page_size,
                             prefix_cache_scenes=self.ec.prefix_cache_scenes,
                             spec_gamma=self.ec.spec_gamma,
                             prefill_chunk=self.ec.prefill_chunk,
                             token_budget=self.ec.token_budget,
                             pool_pages=self.ec.pool_pages,
                             pool_bytes=self.ec.pool_bytes,
                             kv_dtype=self.ec.kv_dtype,
                             mesh=self.ec.mesh,
                             overload=self.ec.overload),
            draft=draft)
        #: (request, reason) pairs dropped by the last overload-controlled
        #: ``serve``: a rejected request gets no Response
        self.last_rejected: List[Tuple[Request, str]] = []

    def warmup(self) -> None:
        """Allocate the slot tables and build the kernels before the first
        ``serve``, so no build stalls the serving loop."""
        self.core.warmup()

    # -- batch-level API ---------------------------------------------------
    def generate_batch(self, task: str, images: torch.Tensor,
                       prompts: torch.Tensor
                       ) -> Tuple[np.ndarray, np.ndarray]:
        toks, probs = self.core.generate(task, images, prompts,
                                         self.ec.answer_vocab)
        return toks.cpu().numpy(), probs.cpu().numpy()

    # -- request-level API (slot-based continuous batching) ----------------
    def serve(self, requests: List[Request]) -> List[Response]:
        """Serve a queue of requests through the fixed batch slots.

        Requests are admitted whenever a slot is free, including slots that
        finished on the previous step while the rest of the batch is still
        mid-answer, so 1-token VQA/CLS answers next to N_r-token detection
        answers keep every slot busy.

        With ``EngineConfig(overload=...)`` the requests are submitted once
        to the engine's own queue instead, which admits them page-pool-aware
        in priority order, preempting and rejecting under saturation.  A
        rejected request gets no Response: ``self.last_rejected`` holds the
        (request, reason) pairs after the call."""
        out: List[Response] = []
        core = self.core

        def emit(req: Request, toks: np.ndarray) -> None:
            pred = toks[0] if req.task in ("vqa", "cls") else toks
            out.append(Response(
                request_id=req.request_id, tokens=toks, pred=pred,
                tier=self.tier, exit_stage=-1, latency_s=0.0,
                tx_bytes=0.0))

        if self.ec.overload is not None:
            self.last_rejected = []
            core.submit_many(list(requests))
            self.last_rejected.extend(core.take_rejected())
            while core.queue_depth() or core.active_count() > 0:
                for req, toks in core.step():
                    emit(req, toks)
                self.last_rejected.extend(core.take_rejected())
            return out

        queue = deque(requests)
        while queue or core.active_count() > 0:
            n = min(len(queue), len(core.free_slots()))
            if n:
                core.admit_many([queue.popleft() for _ in range(n)])
            for req, toks in core.step():
                emit(req, toks)
        return out
