"""EngineCore: one tier's execution substrate for Algorithm 1.

The port of ``repro.serving.engine_core``.  PyTorch runs eagerly, so where
the JAX engine builds jitted closures the port calls plain methods over the
tier's parameters, and the KV caches are updated in place.

- **batch path** (``encode`` / ``encode_cached`` / ``prefill`` /
  ``decode_chunk`` / ``token_features`` / ``generate``): used by the
  ``CascadeExecutor`` for the per-request server.
- **slot path** (``admit`` / ``admit_many`` / ``step``): a fixed-capacity
  slot table for continuous batching.  Every slot holds one in-flight
  request's next-token logits and decode position; ``step`` advances all
  slots one token through one batched ``T.decode_step`` over the whole
  table with a (slots,) index vector.  Finished slots free at once and are
  refilled mid-stream.  The KV cache behind it is ``"paged"`` (default: a
  page pool addressed through per-slot block tables, the scene's region
  prefix prefilled once and mapped read-only into every query over that
  scene; admission then runs only the 1-token prompt suffix) or
  ``"dense"`` (one worst-case cache row per slot, the token-for-token
  oracle).
- **speculative decoding** (``spec_gamma = γ``, paged only): a compact draft
  tier proposes γ tokens per slot on its own dense cache (or the request
  carries them, ``Request.draft_tokens``) and this tier verifies all of
  them in one γ+1-token scoring step; the committed stream is exactly the
  greedy stream.
- **chunked prefill** (``prefill_chunk = C``, paged only): admission runs no
  model forward; a new scene's N_r region tokens stream into its shared
  pages C at a time inside fused token-budget steps, next to every
  in-flight decode row and pending prompt suffix (``_step_chunked``), so
  decoding never stops for admission.  The tokens are the unchunked
  engine's.

Every tensor shape of the slot path is fixed when the tables are allocated
(pools, block table, logits, index, staging buffer, the fused step's flat
(token_budget,) batch), so a later CUDA graph can capture the steps.
The page pools may be quantized (``kv_dtype`` "int8" or "fp8", with
per-(page, slot, head) scales) and sized by a byte budget
(``pool_bytes``).
- **overload control** (``overload=OverloadConfig(...)``, every flavour
  above): ``submit_many`` admits page-pool-aware from a bounded priority
  queue, expires queued requests past their deadline, and preempts the
  lowest-priority slot (drop-and-recompute) for a request that outranks
  it; ``step`` pumps the queue first.  ``admit_many`` stays the
  unconditional path the pump commits through.

- **tensor parallelism** (``mesh``, a ``launch.mesh.Mesh`` whose data axis
  is 1; the batched paged engine on attention-only stacks): every rank
  process runs this engine over its block of the heads and the FFN
  (``distributed.sharding.tp_serving_plan``, ``shard_backbone``); its
  page pools hold only its KV heads, the model all-reduces the attention
  and MLP outputs over the mesh's group inside the step bodies
  (``distributed.collectives.tp_context``), the regions-only prefix
  prefill and the draft tier run replicated at full width, and every
  decision that reads the clock takes rank 0's, so every rank takes the
  same decisions.  A data axis above 1 is ``serving.sharded``'s.

The ``step_impl="vmap"`` oracle and tiers with recurrent (mLSTM/sLSTM)
blocks are not ported yet: they raise ``NotImplementedError`` naming their
ROADMAP item.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ATTN
from repro_torch.core import eo_adapter as EO
from repro_torch.device import same_device
from repro_torch.distributed import collectives as CO
from repro_torch.distributed import sharding as SH
from repro_torch.kernels import ops
from repro_torch.kernels import paged_prefill_attention as PPA
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serving.admission import (ADMITTED, QUEUED, REJECTED,
                                           REASON_EXPIRED, REASON_INFEASIBLE,
                                           REASON_QUEUE_FULL, AdmissionQueue,
                                           OverloadConfig, QueueEntry)
from repro_torch.serving.kv_pool import (KVPagePool, PrefixCache, TRASH_PAGE,
                                         page_nbytes)
from repro_torch.serving.request import Request, scene_key

Params = Dict[str, Any]


def check_ported(cfg: Any) -> None:
    """Raise ``NotImplementedError`` for a config the port does not run
    yet.  A chunked config the JAX engine refuses (off the batched paged
    engine) raises its ``ValueError`` first."""
    if cfg.prefill_chunk and (cfg.step_impl != "batched"
                              or cfg.cache_impl != "paged"):
        raise ValueError("chunked prefill requires the batched paged engine "
                         "(chunking off is the oracle)")
    if cfg.step_impl == "vmap":
        raise NotImplementedError(
            "step_impl='vmap' (the per-slot oracle) is not ported "
            "(ROADMAP queue 1, item 6)")


@dataclasses.dataclass
class EngineCoreConfig:
    slots: int = 8
    answer_vocab: int = 64
    max_answer_len: Optional[int] = None   # default: N_r (longest task = det)
    step_impl: str = "batched"             # "batched" ("vmap": not ported)
    cache_impl: str = "paged"              # "paged" | "dense" (oracle)
    page_size: int = 8                     # tokens per KV page (paged only)
    #: scenes the prefix cache keeps resident beyond the active slots'
    #: (None → slots)
    prefix_cache_scenes: Optional[int] = None
    #: speculative decoding: γ draft tokens per slot, verified by one
    #: multi-token scoring step of this tier (0 = off, the greedy oracle)
    spec_gamma: int = 0
    #: chunked prefill: a new scene's region prefill streams into its
    #: pages this many tokens at a time inside fused token-budget steps
    #: (0 = off, synchronous admission, the oracle); values above N_r clamp
    prefill_chunk: int = 0
    #: tokens per fused step: decode rows first, then prompt suffixes, then
    #: region chunks (None → slots + prefill_chunk; must exceed slots)
    token_budget: Optional[int] = None
    #: explicit KV pool size in pages (paged only); None → the worst-case
    #: bound, under which admission never runs out of pages
    pool_pages: Optional[int] = None
    #: explicit KV pool size as a device byte budget (paged only; excludes
    #: pool_pages): ``pool_bytes // bytes per page`` pages, a page costing
    #: every attention layer's K+V pools and scales
    #: (``kv_pool.page_nbytes``), so an 8-bit pool buys ~2x a bf16 pool's
    #: pages.  Must buy one slot's pages + the trash page.
    pool_bytes: Optional[int] = None
    #: KV pool storage (paged only): None → the model dtype (exact);
    #: "int8" / "fp8" (e4m3) → pages quantized per (page, slot, head) with
    #: f32 scales beside them, read by the paged kernels themselves
    kv_dtype: Optional[str] = None
    #: ``launch.mesh.Mesh`` with ("data", "model") axes, or None (one
    #: device).  The "model" axis splits heads, FFN and page pools over
    #: the mesh's process group (batched paged engine, attention-only
    #: stacks); a "data" axis above 1 is ``serving.sharded``'s job
    mesh: Optional[Any] = None
    #: overload control: page-pool-aware admission, bounded priority queue,
    #: deadline expiry and priority preemption (None = off, the
    #: admit-unconditionally contract; see serving/admission.py)
    overload: Optional[OverloadConfig] = None

    def __post_init__(self):
        check_ported(self)


@dataclasses.dataclass
class _Slot:
    request: Optional[Request] = None
    l_ans: int = 0
    tokens: Optional[List[int]] = None
    active: bool = False
    scene: Optional[Any] = None         # paged: resident prefix this slot maps
    private_pages: Optional[List[int]] = None
    #: remaining piggybacked draft tokens, aligned with answer positions;
    #: dropped on the first committed token that diverges from them
    pending_drafts: Optional[List[int]] = None
    #: speculative engines only: per-emitted-token answer-vocab probability
    #: rows, so ``generate_spec`` honours ``generate``'s (tokens, probs)
    probs: Optional[List[np.ndarray]] = None
    #: chunked prefill's phase machine: "prefill" (this slot streams its
    #: scene's region chunks), "wait" (another slot streams its scene; the
    #: shared pages map at publication), "prompt" (prefix resident, the
    #: 1-token prompt suffix pending), "decode" (the only phase of other
    #: engines)
    phase: str = "decode"
    #: wall-clock request milestones (time-to-first-token accounting)
    t_admit: float = 0.0
    t_first: Optional[float] = None


def _sel_scatter(full: Params, new: Params, slots: torch.Tensor,
                 axis: int) -> None:
    """The engine's one slot-scatter idiom, in place: row ``j`` of every
    leaf of ``new`` along ``axis`` goes to row ``slots[j]`` of ``full``.
    Eager PyTorch needs none of the JAX package's padded slot ids."""
    for name, leaf in full.items():
        leaf.index_copy_(axis, slots, new[name].to(leaf.dtype))


def shared_core(tier, adapter_cfg: EO.EOAdapterConfig) -> "EngineCore":
    """Per-tier ``EngineCore`` cache keyed by adapter-config value, living
    on the ``TierModel`` instance (as in the JAX package, where it shares
    jit caches; here it shares the encode memo)."""
    cache = getattr(tier, "_engine_cores", None)
    if cache is None:
        cache = {}
        tier._engine_cores = cache
    core = cache.get(adapter_cfg)
    if core is None:
        core = EngineCore(tier, adapter_cfg)
        cache[adapter_cfg] = core
    return core


class EngineCore:
    """Batch path + slot table over one tier model."""

    def __init__(self, tier, adapter_cfg: EO.EOAdapterConfig,
                 core_cfg: Optional[EngineCoreConfig] = None,
                 draft=None):
        self.tier = tier
        self.ac = adapter_cfg
        self.cfg = core_cfg or EngineCoreConfig()
        check_ported(self.cfg)
        params, cfg, ac = tier.params, tier.cfg, adapter_cfg
        self.device = params["patch_proj"].device
        self.max_answer_len = self.cfg.max_answer_len or ac.n_regions
        # fixed slot-cache capacity: [regions | prompt | longest answer]
        self._slot_max_len = ac.n_regions + 1 + self.max_answer_len
        if self.cfg.step_impl != "batched":
            raise ValueError(f"unknown step_impl {self.cfg.step_impl!r}")
        if self.cfg.cache_impl not in ("paged", "dense"):
            raise ValueError(f"unknown cache_impl {self.cfg.cache_impl!r}")
        self.cache_impl = self.cfg.cache_impl

        self.draft = draft
        if self.cfg.spec_gamma:
            if self.cfg.spec_gamma < 1:
                raise ValueError("spec_gamma must be >= 1 when set")
            if draft is None:
                raise ValueError("spec_gamma > 0 requires a compact draft "
                                 "tier (the cascade's satellite model)")
            if self.cache_impl != "paged":
                raise ValueError("speculative decoding requires the paged "
                                 "engine (spec=off is the oracle)")
            if draft.params["patch_proj"].device != self.device:
                raise ValueError("the draft tier must lie on the engine's "
                                 "device")
            for c in (tier.cfg, draft.cfg):
                if any(s.kind != ATTN for s in c.block_pattern):
                    raise ValueError(
                        "speculative decoding requires attention-only "
                        "stacks: recurrent state folds the whole chunk into "
                        "one snapshot, so only attention KV rolls back for "
                        "free (a per-row length decrement)")
            self._draft_max_len = self._slot_max_len + self.cfg.spec_gamma
        # a verify chunk writes γ positions past the committed index, so
        # spec engines reserve γ extra KV slots per row
        self._spec_margin = self.cfg.spec_gamma

        self._chunk = self._token_budget = 0
        if self.cfg.prefill_chunk:
            if self.cfg.prefill_chunk < 1:
                raise ValueError("prefill_chunk must be >= 1 when set")
            if any(s.kind != ATTN for s in tier.cfg.block_pattern):
                raise ValueError(
                    "chunked prefill requires attention-only stacks: KV "
                    "appends are bit-stable across chunk boundaries, "
                    "recurrent scans are not")
            self._chunk = min(self.cfg.prefill_chunk, adapter_cfg.n_regions)
            self._token_budget = (self.cfg.token_budget
                                  if self.cfg.token_budget is not None
                                  else self.cfg.slots + self._chunk)
            if self._token_budget <= self.cfg.slots:
                raise ValueError(
                    f"token_budget {self._token_budget} must exceed the "
                    f"slot count {self.cfg.slots}: every decode row takes "
                    "one token per step, so a smaller budget would starve "
                    "prefill streams")
            # the prefix-append kernel's row tiles of a fused step: a fixed
            # count, so the step's launch shape never follows its mix
            self._group = tier.cfg.num_heads // tier.cfg.num_kv_heads
            self._plan_tiles = PPA.plan_tiles(
                self._token_budget, self.cfg.slots, self._group)
        # -- device mesh / tensor-parallel plan (None = one device) --------
        self.mesh = self.cfg.mesh
        self._tp_plan: Optional[SH.TPServingPlan] = None
        self._tp_group, self._tp_rank = None, 0
        #: the backbone and config the slot path's step bodies run: this
        #: rank's block under a mesh, the tier's own otherwise
        self._bb, self._mcfg = tier.params["backbone"], tier.cfg
        if self.mesh is not None:
            if self.cache_impl != "paged":
                raise ValueError(
                    "mesh requires the batched paged engine (the vmap/dense "
                    "oracles stay single-device by design)")
            if SH.mesh_axis_size(self.mesh, "data") != 1:
                raise ValueError(
                    "EngineCore shards tensor-parallel only (the mesh's "
                    "'data' axis must be 1); data-parallel slot splits are "
                    "serving.sharded.ShardedEngineCore's job: it runs one "
                    "EngineCore per data shard on a 1-row sub-mesh")
            if any(s.kind != ATTN for s in tier.cfg.block_pattern):
                raise ValueError(
                    "mesh serving requires attention-only stacks: recurrent "
                    "prefix-state rows would have to be replicated across "
                    "the admit path (and head-splitting has nothing to "
                    "split in an SSM state)")
            want = torch.device(self.mesh.device())
            if not same_device(want, self.device):
                raise ValueError(f"the tier's weights lie on {self.device}, "
                                 f"the mesh puts rank {self.mesh.rank} on "
                                 f"{want}")
            plan = SH.tp_serving_plan(tier.cfg, self.mesh)
            self._tp_plan = plan
            self._tp_group, self._tp_rank = self.mesh.group, self.mesh.rank
            self._mcfg = plan.cfg_local
            self._bb = SH.shard_backbone(self._bb, plan, self._tp_rank)
        if any(s.kind != ATTN for s in tier.cfg.block_pattern):
            # the model runs mLSTM/sLSTM stacks (transformer.prefill /
            # decode_step), but the engine's admission does not carry their
            # state yet: nothing may half-run
            raise NotImplementedError(
                "an EngineCore over recurrent blocks needs the engine's "
                "recurrent-state admission (prefix-state snapshots in "
                "_paged_admit, the state branch of _prefix_scatter), which "
                "is not ported (ROADMAP queue 1, item 17)")
        #: chunked engines: scene → {slot, pages, progress, order, priority}
        #: of the region streams in flight (FIFO by order within priority)
        self._streaming: Dict[Any, Dict[str, Any]] = {}
        self._stream_seq = 0
        self._staging = None

        @torch.inference_mode()
        def _encode(images, ptok):
            rf = EO.encode_regions(params, ac, images)
            tf = EO.encode_text(params, cfg, ptok)
            return rf, tf, rf.float().mean(dim=1)

        self._encode = _encode
        self._token_feats = torch.inference_mode()(
            lambda toks: EO.token_features(params, toks))
        # V(x) alone, the one model call of chunked admission
        self._region_embed = torch.inference_mode()(
            lambda images: EO.encode_regions(params, ac, images))
        # scene-keyed encode memo for the serve path (bounded LRU)
        self._encode_cache: "OrderedDict[Any, Tuple]" = OrderedDict()
        self._encode_cache_cap = 32

        if self.cfg.kv_dtype is not None:
            if self.cfg.kv_dtype not in ("int8", "fp8"):
                raise ValueError(f"unknown kv_dtype {self.cfg.kv_dtype!r} "
                                 "(None, 'int8' or 'fp8')")
            if self.cache_impl != "paged":
                raise ValueError(
                    "kv_dtype requires the paged cache: quantization lives "
                    "in the page pools and the paged kernels (the dense "
                    "engine stays the exact oracle)")

        n_slots = self.cfg.slots
        if self.cache_impl == "paged":
            ps = self.cfg.page_size
            if ps < 1:
                raise ValueError(f"page_size must be positive, got {ps}")
            if ac.n_regions % ps != 0:
                # the shared scene prefix must occupy whole pages
                ps = math.gcd(ps, ac.n_regions)
            self._page_size = ps
            self._n_shared_pages = ac.n_regions // ps
            self._pages_per_slot = -(-(self._slot_max_len
                                       + self._spec_margin) // ps)
            self._private_per_slot = (self._pages_per_slot
                                      - self._n_shared_pages)
            scenes = (self.cfg.prefix_cache_scenes
                      if self.cfg.prefix_cache_scenes is not None
                      else n_slots)
            # worst case: every slot holds a distinct scene + `scenes`
            # cache-only prefixes
            self._n_pages = (1 + n_slots * self._pages_per_slot
                             + scenes * self._n_shared_pages)
            floor = 1 + self._pages_per_slot
            if self.cfg.pool_pages is not None:
                if self.cfg.pool_bytes is not None:
                    raise ValueError("pool_pages and pool_bytes are "
                                     "mutually exclusive pool-size knobs")
                if self.cfg.pool_pages < floor:
                    raise ValueError(
                        f"pool_pages {self.cfg.pool_pages} below the "
                        f"single-slot floor {floor} (trash page + one "
                        "slot's worst-case pages)")
                self._n_pages = self.cfg.pool_pages
            elif self.cfg.pool_bytes is not None:
                # one page's device cost across the whole stack, scales
                # included: the accounting rule kv_stats() checks
                per_page = self._page_nbytes_stack()
                n = self.cfg.pool_bytes // per_page
                if n < floor:
                    raise ValueError(
                        f"pool_bytes {self.cfg.pool_bytes} buys only {n} "
                        f"pages at {per_page} B/page, below the "
                        f"single-slot floor {floor} (trash page + one "
                        "slot's worst-case pages)")
                self._n_pages = int(n)
            self._pool = KVPagePool(self._n_pages, ps)
            self._prefix = PrefixCache(self._pool, capacity=n_slots + scenes)
            self._bt_np = np.full((n_slots, self._pages_per_slot),
                                  TRASH_PAGE, np.int32)
            self._bt_dev = None
        elif self.cfg.pool_pages is not None:
            raise ValueError("pool_pages only applies to the paged cache")
        elif self.cfg.pool_bytes is not None:
            raise ValueError("pool_bytes only applies to the paged cache")

        self._slots: List[_Slot] = [_Slot() for _ in range(n_slots)]
        self._slot_cache = None
        self._slot_logits = None
        self._slot_index = None
        self._draft_cache = None
        self._spec_probs: "OrderedDict[int, np.ndarray]" = OrderedDict()
        # active mask on device, re-uploaded only when admission or release
        # changes it
        self._active_dev = None
        self._step_no = 0
        self.stats: Dict[str, Any] = {
            "admitted": 0, "finished": 0, "mid_stream_refills": 0,
            "prefix_hits": 0, "prefix_misses": 0,
            "prefill_tokens": 0,        # tokens actually run through prefill
            #: the same counter by kind ("dense", "prefix", "prompt",
            #: "draft"), kept by the one hook ``_note_prefill``
            "prefill_by_kind": {},
            "encode_reuse": 0,          # serve-path scene-encode cache hits
            "occupancy_log": [],        # (step, active_slots_after_admit)
            #: finished-request milestones (bounded): {request_id, task,
            #: t_admit, t_first, t_done, priority} wall-clock
            "request_log": [],
            #: per-step scheduling ledger (every step flavour): tokens by
            #: kind, fused-step budget accounting, stall steps (a fused step
            #: in which a streaming scene got no budget), and per fused step
            #: (decode, prompt, chunk) tokens (bounded)
            "sched": {"steps": 0, "fused_steps": 0, "decode_tokens": 0,
                      "prompt_tokens": 0, "chunk_tokens": 0,
                      "scheduled_tokens": 0, "stall_steps": 0,
                      "budget": self._token_budget, "step_log": []},
        }
        # -- overload control (None = admit unconditionally) ---------------
        self._admq: Optional[AdmissionQueue] = None
        if self.cfg.overload is not None:
            self._admq = AdmissionQueue(self.cfg.overload.queue_cap)
            self._submit_seq = 0
            #: request_id → {t_submit, seq, deferred, preempts, t_preempt}:
            #: alive from submit to finish or rejection (bounded by
            #: queue_cap + slots)
            self._submit_meta: Dict[int, Dict[str, Any]] = {}
            #: (request, reason) drained by ``take_rejected``: expiry and
            #: overflow by a later push happen inside ``step``, after
            #: ``submit_many`` returned
            self._rejected: List[Tuple[Request, str]] = []
            self.stats["overload"] = {
                "submitted": 0, "admissions_deferred": 0,
                "preemptions": 0,
                "rejections": {REASON_QUEUE_FULL: 0, REASON_EXPIRED: 0},
                #: seconds between a preemption and the re-admission of
                #: the same request (bounded; scheduler_stats summarises)
                "readmit_wait_s": [],
            }
        if self.cfg.spec_gamma:
            self.stats["spec"] = {
                "steps": 0,             # speculative engine steps
                "verify_only_steps": 0,  # steps that skipped the drafter
                "slot_steps": 0,        # active-slot · step pairs
                "drafted": 0,           # γ per active slot per step
                "accepted": 0,          # drafts the verifier accepted
                "committed": 0,         # tokens committed (1 + accepted)
                "emitted": 0,           # committed tokens kept (≤ l_ans)
                "piggybacked": 0,       # drafts supplied by the request
            }
        self._occupancy_cap = 4096      # keep the logs bounded on long runs

    # ------------------------------------------------------------------
    # batch path (shared by CascadeExecutor)
    # ------------------------------------------------------------------
    def encode(self, task: str, images: torch.Tensor, prompts: torch.Tensor):
        """V(x), E(T) and pooled visual features: (B,R,d), (B,1,d), (B,d)."""
        return self._encode(images, self.ac.prompt_token(task, prompts))

    def encode_cached(self, task: str, images: torch.Tensor,
                      prompts: torch.Tensor, scene: Optional[Any] = None,
                      prompt_id: Optional[int] = None):
        """``encode`` with a scene-keyed memo for the batch-of-one serve
        path: queries fanning out over one captured scene reuse V(x)/E(T).
        ``prompt_id`` is the host-side prompt scalar (``Request.prompt``);
        callers that have it pass it so the key never reads the device."""
        if scene is None or images.shape[0] != 1:
            return self.encode(task, images, prompts)
        if prompt_id is None:
            prompt_id = int(prompts[0])  # spacelint: disable=SL001 (cache-key fetch for callers without host prompt metadata)
        key = (scene, task, prompt_id)
        hit = self._encode_cache.get(key)
        if hit is not None:
            self._encode_cache.move_to_end(key)
            self.stats["encode_reuse"] += 1
            return hit
        out = self.encode(task, images, prompts)
        self._encode_cache[key] = out
        while len(self._encode_cache) > self._encode_cache_cap:
            self._encode_cache.popitem(last=False)
        return out

    def prefill(self, task: str, images: torch.Tensor, prompts: torch.Tensor,
                extra_len: int):
        max_len = self.ac.n_regions + 1 + extra_len
        return EO.prefill_tokens(self.tier.params, self.tier.cfg, self.ac,
                                 images, self.ac.prompt_token(task, prompts),
                                 max_len)

    def decode_chunk(self, cache, logits, idx, n_tokens: int,
                     answer_vocab: int):
        return EO.decode_chunk(self.tier.params, self.tier.cfg, cache, logits,
                               idx, n_tokens, answer_vocab)

    def token_features(self, tokens: torch.Tensor) -> torch.Tensor:
        return self._token_feats(tokens)

    def generate(self, task: str, images: torch.Tensor, prompts: torch.Tensor,
                 answer_vocab: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full greedy answer (prefill + one chunk), as ``EO.generate``."""
        l_ans = self.ac.answer_len(task)
        logits, cache, idx = self.prefill(task, images, prompts, l_ans)
        toks, probs, *_ = self.decode_chunk(cache, logits, idx, l_ans,
                                            answer_vocab)
        return toks, probs

    # ------------------------------------------------------------------
    # slot path (continuous batching)
    # ------------------------------------------------------------------
    def _ensure_slot_tables(self) -> None:
        """Allocate every slot-path tensor once, at its final shape."""
        cfg, dev, n = self.tier.cfg, self.device, self.cfg.slots
        if self._slot_cache is None:
            if self.cache_impl == "paged":
                # under a mesh, at this rank's KV heads
                self._slot_cache = T.init_paged_cache(
                    self._mcfg, n, self._n_pages, self._page_size, dev,
                    kv_dtype=self.cfg.kv_dtype)
            else:
                self._slot_cache = T.init_cache(cfg, n, self._slot_max_len,
                                                dev)
            self._slot_logits = torch.zeros((n, cfg.vocab_size),
                                            dtype=torch.float32, device=dev)
            self._slot_index = torch.zeros((n,), dtype=torch.int32,
                                           device=dev)
        if self.cfg.spec_gamma and self._draft_cache is None:
            self._draft_cache = T.init_cache(self.draft.cfg, n,
                                             self._draft_max_len, dev)
        if self.cfg.prefill_chunk and self._staging is None:
            # each streaming slot's region embeddings, fed C at a time
            self._staging = torch.zeros(
                (n, self.ac.n_regions, cfg.d_model),
                dtype=getattr(torch, cfg.dtype), device=dev)

    def _block_table_dev(self) -> torch.Tensor:
        """The (slots, pages) block table on the device, uploaded again only
        after admission or release changed it."""
        if self._bt_dev is None:
            self._bt_dev = torch.from_numpy(self._bt_np).to(self.device)
        return self._bt_dev

    def _active_mask_dev(self) -> torch.Tensor:
        if self._active_dev is None:
            self._active_dev = torch.tensor([s.active for s in self._slots],
                                            device=self.device)
        return self._active_dev

    def _host_to_dev(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a)).to(self.device)

    def _tp(self):
        """The context the slot path's step bodies run in: the all-reduce
        hooks armed over the mesh's group (nothing on one device)."""
        if self._tp_group is None:
            return contextlib.nullcontext()
        return CO.tp_context(self._tp_group, attn=self._tp_plan.attn,
                             mlp=self._tp_plan.mlp)

    def _now(self, now: Optional[float] = None) -> float:
        """The time a decision reads: ``now``, else the clock; under a mesh,
        rank 0's, broadcast over the group.  Ranks that expired different
        requests would run different steps and deadlock in a collective."""
        now = time.perf_counter() if now is None else now
        if self._tp_group is None:
            return now
        t = torch.tensor([now], dtype=torch.float64, device=self.device)
        dist.broadcast(t, src=dist.get_global_rank(self._tp_group, 0),
                       group=self._tp_group)
        return float(t.item())

    def _page_nbytes_stack(self) -> int:
        """Device bytes ONE pool page costs across the whole stack (every
        attention layer's K+V pools and an 8-bit pool's scales):
        ``pool_bytes`` sizing divides by it, ``kv_stats`` checks the live
        pools against it."""
        cfg = self.tier.cfg
        n_kv = cfg.n_super * len(cfg.block_pattern)
        return n_kv * page_nbytes(
            self._page_size, cfg.num_kv_heads, cfg.resolved_head_dim,
            kv_dtype=self.cfg.kv_dtype,
            fp_bytes=torch.empty((), dtype=getattr(torch, cfg.dtype))
            .element_size())

    def _note_prefill(self, kind: str, tokens: int) -> None:
        """The ONE prefill-token accounting hook: every path that runs
        tokens through a prefill reports here."""
        self.stats["prefill_tokens"] += tokens
        by_kind = self.stats["prefill_by_kind"]
        by_kind[kind] = by_kind.get(kind, 0) + tokens

    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self._slots) if not s.active]

    def active_count(self) -> int:
        return sum(s.active for s in self._slots)

    @torch.inference_mode()
    def warmup(self) -> None:
        """Allocate the slot tables and build/bind every kernel ahead of
        the first admission, so no ``nvcc`` build lands mid-serve.  Eager
        PyTorch compiles nothing per shape, so there are no admission
        buckets to pre-compile as in the JAX engine.  Chunked engines also
        run one all-idle fused step (every flat row unscheduled: its writes
        land on the trash page, no logits are taken), the shape their
        serving steps take.  Slot state is untouched."""
        self._ensure_slot_tables()
        if self.device.type == "cuda":
            for kernel in ops.KERNELS.values():
                kernel.bind()
        if self.cfg.prefill_chunk:
            tb, n = self._token_budget, self.cfg.slots
            zeros = np.zeros((tb,), np.int32)
            self._fused_step(np.full((tb,), n, np.int32), zeros, zeros,
                             np.zeros((tb,), bool), np.zeros((tb,), bool))

    def _images(self, requests: List[Request]) -> torch.Tensor:
        return torch.from_numpy(np.stack(
            [np.asarray(r.image) for r in requests])).to(self.device)

    def admit(self, request: Request) -> int:
        """Prefill ``request`` into a free slot; returns the slot id."""
        return self.admit_many([request])[0]

    @torch.inference_mode()
    def admit_many(self, requests: List[Request]) -> List[int]:
        """Admit up to the free slot count of pending requests in one batched
        call.  Dense cache: the full [regions | prompt] prefix prefills per
        request and its cache rows are copied into the slots.  Paged cache:
        the region prefix prefills once per scene not already resident,
        then every request maps the shared prefix pages read-only and runs
        only its 1-token prompt suffix (``_admit_many_paged``).  Returns
        the slot id per request."""
        if not requests:
            return []
        t_admit = time.perf_counter()      # TTFT clocks start before prefill
        free = self.free_slots()
        if len(requests) > len(free):
            raise RuntimeError("no free slot")
        self._ensure_slot_tables()
        if self.cfg.prefill_chunk:
            return self._admit_many_chunked(requests, free, t_admit)
        if self.cache_impl == "paged":
            return self._admit_many_paged(requests, free, t_admit)
        k = len(requests)
        target = free[:k]
        ptok = self._host_to_dev([self.ac.prompt_id(r.task, r.prompt)
                                  for r in requests])
        logits, cache, idx = EO.prefill_tokens(
            self.tier.params, self.tier.cfg, self.ac, self._images(requests),
            ptok, self._slot_max_len)
        slots = self._host_to_dev(target)
        for full, new in zip(self._slot_cache, cache):
            _sel_scatter(full, new, slots, 1)
        self._slot_logits.index_copy_(0, slots, logits)
        self._slot_index.index_fill_(0, slots, idx)
        self._note_prefill("dense", k * (self.ac.n_regions + 1))
        self._record_admissions(target, requests, t_admit=t_admit)
        return target

    def _record_admissions(self, slot_ids: List[int],
                           requests: List[Request], scenes=None,
                           private=None, phases=None,
                           t_admit: Optional[float] = None) -> None:
        log = self.stats["occupancy_log"]
        now = t_admit if t_admit is not None else time.perf_counter()
        for j, (s, request) in enumerate(zip(slot_ids, requests)):
            others_active = self.active_count()
            pending = None
            if self.cfg.spec_gamma and request.draft_tokens is not None:
                # Request.__post_init__ normalised drafts to host int32
                pending = [int(t) for t in request.draft_tokens]
            wants_probs = (self.cfg.spec_gamma
                           and getattr(request, "_wants_probs", False))
            self._slots[s] = _Slot(
                request=request, l_ans=self.ac.answer_len(request.task),
                tokens=[], active=True,
                scene=scenes[j] if scenes else None,
                private_pages=private[j] if private else None,
                pending_drafts=pending,
                probs=[] if wants_probs else None,
                phase=phases[j] if phases else "decode", t_admit=now)
            self.stats["admitted"] += 1
            if self._step_no > 0 and others_active > 0:
                self.stats["mid_stream_refills"] += 1
            log.append((self._step_no, self.active_count()))
        self._active_dev = None
        if len(log) > self._occupancy_cap:
            del log[:self._occupancy_cap // 2]

    # -- paged admission ------------------------------------------------
    def _prefill_prefixes(self, miss: List[Tuple[Any, Request]]) -> None:
        """Region-prefill the scenes in ``miss`` (one batched call), write
        their KV into freshly allocated shared pages, and make them
        resident in the prefix cache.  The caller has budgeted the pages
        and entries already (check-then-commit), so nothing here fails."""
        km = len(miss)
        n_shared, ps = self._n_shared_pages, self._page_size
        _, cache, _ = EO.prefill_regions(
            self.tier.params, self.tier.cfg, self.ac,
            self._images([r for _, r in miss]), self.ac.n_regions)
        allocs = [self._pool.alloc(n_shared) for _ in range(km)]
        pages = self._host_to_dev([p for pg in allocs for p in pg])
        # under a mesh the prefill ran at full heads on every rank; this
        # rank keeps its KV-head block, sliced before quantization (scales
        # are per (token, head), so slicing commutes with it exactly)
        heads = (SH.kv_head_block(self._tp_plan, self._tp_rank)
                 if self._tp_plan is not None else slice(None))

        def kv(pool: Params, pref: Params) -> Params:
            # a quantized pool takes the dense prefix quantized here, the
            # layout every other write path keeps (scales drop the hd axis)
            pref = L.quantize_leaves(pool, pref["k"][:, :, :, heads],
                                     pref["v"][:, :, :, heads])
            for name, leaf in pool.items():
                x = pref[name]                     # (n_super, K, N_r, KH, ...)
                ns = x.shape[0]
                L.put_pool(leaf, (slice(None), pages),
                           x.reshape((ns, km * n_shared, ps)
                                     + tuple(x.shape[3:])))
            return pool

        T.map_cache_kinds(self.tier.cfg, [self._slot_cache, cache], kv=kv,
                          state=None)
        for i, (scene, _r) in enumerate(miss):
            self._prefix.put(scene, allocs[i], None)
        self.stats["prefix_misses"] += km
        self._note_prefill("prefix", km * self.ac.n_regions)

    def _paged_admit(self, target: List[int], ptoks: np.ndarray) -> None:
        """Admit requests whose prefixes are page-resident: ONE decode step
        over the whole table runs only the admitted rows' 1-token prompt
        suffix at position N_r; every other row is steered at the trash
        page with index 0 (its write lands there, its logits and index are
        kept).  This is the paged prefill: the region tokens are never
        recomputed."""
        n, n_r = self.cfg.slots, self.ac.n_regions
        hit = np.zeros((n,), bool)
        hit[target] = True
        bt_call = np.where(hit[:, None], self._bt_np, TRASH_PAGE)
        ptok_row = np.zeros((n,), np.int32)
        ptok_row[target] = ptoks
        idx_in = np.where(hit, n_r, 0).astype(np.int32)
        with self._tp():
            logits, _ = T.decode_step(
                self._bb, self._mcfg, self._slot_cache,
                {"tokens": self._host_to_dev(ptok_row)[:, None]},
                self._host_to_dev(idx_in),
                block_table=self._host_to_dev(bt_call.astype(np.int32)))
        slots = self._host_to_dev(target)
        self._slot_logits.index_copy_(0, slots, logits.index_select(0, slots))
        self._slot_index.index_fill_(0, slots, n_r + 1)

    def _admit_many_paged(self, requests: List[Request], free: List[int],
                          t_admit: Optional[float] = None) -> List[int]:
        """Scene-shared admission: prefix pages are mapped read-only into
        each new request's block table (refcount++), and only the 1-token
        prompt suffix runs through the model."""
        k = len(requests)
        scenes = [scene_key(r) for r in requests]
        miss, seen = [], set()
        for s_, r in zip(scenes, requests):
            if s_ not in self._prefix and s_ not in seen:
                miss.append((s_, r))
                seen.add(s_)
        # check-then-commit: ONE eviction call budgets the whole batch
        # before anything is allocated, so a MemoryError leaves the engine
        # as it was
        self._prefix.evict_for(
            k * self._private_per_slot + len(miss) * self._n_shared_pages,
            need_entries=len(miss), protect=set(scenes))
        if miss:
            self._prefill_prefixes(miss)
        self.stats["prefix_hits"] += k - len(miss)
        target = free[:k]
        ptoks = np.empty((k,), np.int32)
        private = []
        for i, (r, s_) in enumerate(zip(requests, scenes)):
            entry = self._prefix.acquire(s_)
            priv = self._pool.alloc(self._private_per_slot)
            self._bt_np[target[i]] = list(entry.pages) + priv
            ptoks[i] = self.ac.prompt_id(r.task, r.prompt)
            private.append(priv)
        self._bt_dev = None
        self._paged_admit(target, ptoks)
        self._note_prefill("prompt", k)        # one prompt token per request
        if self.cfg.spec_gamma:
            self._draft_prefill(requests, ptoks, target)
        self._record_admissions(target, requests, scenes=scenes,
                                private=private, t_admit=t_admit)
        return target

    # -- chunked admission ------------------------------------------------
    def _admit_many_chunked(self, requests: List[Request], free: List[int],
                            t_admit: Optional[float] = None) -> List[int]:
        """Stall-free admission: no model forward runs here.  Each request
        gets a slot, private pages and a phase: its scene resident in the
        prefix cache → ``"prompt"`` (shared pages mapped read-only, the
        prompt suffix rides the next fused step); its scene streaming in
        another slot → ``"wait"`` (shared pages mapped at publication); its
        scene unseen → ``"prefill"``: this slot streams the scene, fresh
        shared pages are allocated and the region embeddings (one small
        projection, the only model call here) are staged.  Only the first
        query of a scene streams; fan-out queries share its pages."""
        k = len(requests)
        scenes = [scene_key(r) for r in requests]
        new_streams, seen = [], set()
        for s_ in scenes:
            if (s_ not in self._prefix and s_ not in self._streaming
                    and s_ not in seen):
                new_streams.append(s_)
                seen.add(s_)
        # one page budget for the whole batch, up front; streams in flight
        # are protected too (not resident yet, but they must not be
        # evicted and restreamed), and their later publications reserve
        # entry capacity now (put() never checks it)
        self._prefix.evict_for(
            k * self._private_per_slot
            + len(new_streams) * self._n_shared_pages,
            need_entries=len(new_streams) + len(self._streaming),
            protect=set(scenes) | set(self._streaming))
        target = free[:k]
        stream_reqs, stream_slots, phases, private = [], [], [], []
        for r, s_, slot in zip(requests, scenes, target):
            priv = self._pool.alloc(self._private_per_slot)
            private.append(priv)
            if s_ in self._prefix:
                entry = self._prefix.acquire(s_)
                self._bt_np[slot] = list(entry.pages) + priv
                phases.append("prompt")
            elif s_ in self._streaming:
                # shared blocks stay on the trash page until publication; a
                # higher-priority waiter raises the stream's priority
                st = self._streaming[s_]
                st["priority"] = max(st["priority"], r.priority)
                self._bt_np[slot] = ([TRASH_PAGE] * self._n_shared_pages
                                     + priv)
                phases.append("wait")
            else:
                shared = self._pool.alloc(self._n_shared_pages)
                self._streaming[s_] = {"slot": slot, "pages": shared,
                                       "progress": 0,
                                       "order": self._stream_seq,
                                       "priority": r.priority}
                self._stream_seq += 1
                self._bt_np[slot] = shared + priv
                phases.append("prefill")
                stream_reqs.append(r)
                stream_slots.append(slot)
        self._bt_dev = None
        self.stats["prefix_hits"] += k - len(new_streams)
        self.stats["prefix_misses"] += len(new_streams)
        if stream_slots:
            embs = self._region_embed(self._images(stream_reqs))
            self._staging.index_copy_(0, self._host_to_dev(stream_slots),
                                      embs.to(self._staging.dtype))
        self._record_admissions(target, requests, scenes=scenes,
                                private=private, phases=phases,
                                t_admit=t_admit)
        return target

    def _release_slot(self, i: int) -> None:
        slot = self._slots[i]
        self._slots[i] = _Slot()
        self._active_dev = None
        if self.cache_impl == "paged" and slot.private_pages is not None:
            self._pool.free(slot.private_pages)
            self._prefix.release(slot.scene)
            self._bt_np[i] = TRASH_PAGE
            self._bt_dev = None

    def _finish_slot(self, i: int,
                     finished: List[Tuple[Request, np.ndarray]]) -> None:
        """Emit the answer, log the request's wall-clock milestones, stash
        spec probs if the request asked for them, and free the slot."""
        slot = self._slots[i]
        finished.append((slot.request, np.asarray(slot.tokens, np.int32)))
        log = self.stats["request_log"]
        # overload engines log the queue wait too: t_submit is when the
        # request entered submit_many (<= t_admit), and per-priority TTFT
        # is measured from it, so time parked under saturation is charged
        meta = (self._submit_meta.pop(slot.request.request_id, None)
                if self._admq is not None else None)
        log.append({"request_id": slot.request.request_id,
                    "task": slot.request.task, "t_admit": slot.t_admit,
                    "t_first": slot.t_first, "t_done": time.perf_counter(),
                    "priority": slot.request.priority,
                    "t_submit": (meta["t_submit"] if meta is not None
                                 else slot.t_admit),
                    "preempts": meta["preempts"] if meta is not None else 0})
        if len(log) > self._occupancy_cap:
            del log[:self._occupancy_cap // 2]
        if slot.probs:
            self._stash_spec_probs(slot)
        self._release_slot(i)
        self.stats["finished"] += 1

    # ------------------------------------------------------------------
    # overload control (cfg.overload set): page-pool-aware admission with
    # a bounded priority queue, deadline expiry and priority preemption
    # ------------------------------------------------------------------
    def page_demand(self, request: Request) -> int:
        """Worst-case page demand of admitting ``request`` now: its private
        pages (prompt + longest answer + spec γ slack, the fixed per-slot
        reservation) plus the shared scene prefix unless the scene is
        resident or streaming.  Dense caches reserve every slot's rows up
        front, so their demand is 0 (admission is gated by slots alone)."""
        if self.cache_impl != "paged":
            return 0
        s_ = scene_key(request)
        shared = (0 if s_ in self._prefix or s_ in self._streaming
                  else self._n_shared_pages)
        return self._private_per_slot + shared

    def _fits(self, entries: List[QueueEntry]) -> bool:
        """Would the admit path's one up-front ``evict_for`` succeed for
        ``entries`` as one batch?  Headroom = free pages + zero-user
        unprotected prefix pages.  A pure probe: nothing is evicted or
        allocated here, so requests that do not fit stay parked without
        tearing down cache state (check-then-commit)."""
        if self.cache_impl != "paged":
            return True
        k = len(entries)
        scenes = [scene_key(e.request) for e in entries]
        streams = self._streaming          # empty unless chunked
        new = {s_ for s_ in scenes
               if s_ not in self._prefix and s_ not in streams}
        protect = set(scenes) | set(streams)
        need_pages = (k * self._private_per_slot
                      + len(new) * self._n_shared_pages)
        # the admit paths' eviction budget exactly: streams in flight
        # reserve entry capacity for their later publications
        need_entries = len(new) + len(streams)
        if (self._pool.free_pages + self._prefix.evictable_pages(protect)
                < need_pages):
            return False
        resident = len(self._prefix) - self._prefix.evictable_entries(protect)
        return resident + need_entries <= self._prefix.capacity

    def queue_depth(self) -> int:
        return len(self._admq) if self._admq is not None else 0

    def take_rejected(self) -> List[Tuple[Request, str]]:
        """Drain the (request, reason) pairs rejected since the last call.
        A request ``submit_many`` returned as queued can be rejected later
        (deadline expiry at pump time, or displacement by a later
        higher-priority push), so drivers poll this beside ``step``'s
        finished list."""
        if self._admq is None:
            return []
        out, self._rejected = self._rejected, []
        return out

    def submit_many(self, requests: List[Request],
                    now: Optional[float] = None) -> Dict[int, str]:
        """The overload-controlled admission entry: an outcome per request
        id, ``"admitted"`` (in a slot now), ``"queued"`` (parked in the
        bounded priority queue; admitted, preempted for or rejected later)
        or ``"rejected"`` (queue overflow, already expired, or a demand no
        idle pool could hold).  ``now`` is the submit time on the
        ``time.perf_counter`` clock (default: the clock).  Requires
        ``EngineCoreConfig.overload``; ``admit_many`` stays the
        unconditional path, which the pump commits through."""
        if self._admq is None:
            raise ValueError("submit_many requires EngineCoreConfig."
                             "overload (admit_many is the unconditional "
                             "path)")
        now = self._now(now)
        ol = self.stats["overload"]
        out: Dict[int, str] = {}
        for r in requests:
            ol["submitted"] += 1
            meta = {"t_submit": now, "seq": self._submit_seq,
                    "deferred": False, "preempts": 0, "t_preempt": None}
            self._submit_meta[r.request_id] = meta
            self._submit_seq += 1
            entry = QueueEntry(request=r, seq=meta["seq"], t_submit=now)
            dropped = self._admq.push(entry)
            if dropped is entry:
                # the queue is full of work at least as valuable: admit
                # what fits into free slots first, then retry once, so a
                # burst on an idle engine is not refused by the bound that
                # exists for saturation
                self._pump_queue(now)
                dropped = self._admq.push(entry)
            if dropped is not None:
                self._reject(dropped, REASON_QUEUE_FULL)
                if dropped is entry:
                    out[r.request_id] = REJECTED
                    continue
            out[r.request_id] = QUEUED
        self._pump_queue(now)
        active = {s.request.request_id for s in self._slots if s.active}
        queued = {e.request.request_id for e in self._admq}
        for r in requests:
            rid = r.request_id
            if out[rid] == REJECTED:
                continue
            if rid in active:
                out[rid] = ADMITTED
            elif rid in queued:
                meta = self._submit_meta[rid]
                if not meta["deferred"]:
                    meta["deferred"] = True
                    ol["admissions_deferred"] += 1
            else:
                out[rid] = REJECTED     # expired or displaced in the pump
        return out

    def _reject(self, entry: QueueEntry, reason: str) -> None:
        ol = self.stats["overload"]
        ol["rejections"][reason] = ol["rejections"].get(reason, 0) + 1
        self._submit_meta.pop(entry.request.request_id, None)
        self._rejected.append((entry.request, reason))
        if len(self._rejected) > self._occupancy_cap:
            del self._rejected[:self._occupancy_cap // 2]

    def _pump_queue(self, now: Optional[float] = None) -> None:
        """Admit the longest prefix of the priority-ordered queue that fits
        (slots and pages); when the head does not fit and outranks an
        in-flight request, preempt the lowest-priority slot and retry.
        Strict head-of-line by priority: a lower-priority entry never
        jumps a parked urgent one, so backfill cannot take the pages it is
        waiting for."""
        if self._admq is None or len(self._admq) == 0:
            return
        now = self._now(now)
        for e in self._admq.expire(now):
            self._reject(e, REASON_EXPIRED)
        ov = self.cfg.overload
        while len(self._admq):
            free = len(self.free_slots())
            batch: List[QueueEntry] = []
            for e in self._admq:
                if len(batch) >= free:
                    break
                if not self._fits(batch + [e]):
                    break
                batch.append(e)
            if batch:
                for _ in batch:
                    self._admq.pop()
                self._admit_submitted(batch, now)
                continue
            head = self._admq.peek()
            if (ov.preempt and head is not None
                    and self._preempt_one(head.request.priority, now)):
                continue
            if head is not None and self.active_count() == 0 \
                    and not self._fits([head]):
                # an idle engine with everything evictable counted still
                # cannot hold it: it can never be admitted, and parked it
                # would wedge the strict-priority head for good
                self._admq.pop()
                self._reject(head, REASON_INFEASIBLE)
                continue
            break

    def _admit_submitted(self, entries: List[QueueEntry], now: float
                         ) -> None:
        """The pump's commit phase: ``_fits`` proved the batch feasible, so
        the unconditional admit path runs unchanged (its one up-front
        ``evict_for`` succeeds by construction)."""
        self.admit_many([e.request for e in entries])
        ol = self.stats["overload"]
        for e in entries:
            meta = self._submit_meta.get(e.request.request_id)
            if meta is not None and meta["t_preempt"] is not None:
                wait = ol["readmit_wait_s"]
                wait.append(now - meta["t_preempt"])
                meta["t_preempt"] = None
                if len(wait) > self._occupancy_cap:
                    del wait[:self._occupancy_cap // 2]

    def _preempt_one(self, above_priority: int, now: float) -> bool:
        """Preempt ONE in-flight slot whose priority is strictly below
        ``above_priority``, drop-and-recompute: free its private pages,
        release its prefix mapping, and queue the request again at the
        front of its priority class (its original submit seq keeps its
        age).  Greedy decoding is deterministic and the scene prefix stays
        resident (or is prefilled again), so the re-admitted request
        gives the tokens it would have given uncontended (a prefix
        prefilled again in another batch may round otherwise in bf16).
        The victim: the lowest priority, then the least decode progress
        (the least recompute lost), then the lowest slot id.  Only slots
        that own their prefix mapping (decode/prompt phases) are eligible:
        a chunked streamer's pages are what its waiters wait on, and
        "wait" and "prefill" slots have not acquired the prefix the
        release unmaps."""
        victims = [(s.request.priority, len(s.tokens or ()), i)
                   for i, s in enumerate(self._slots)
                   if s.active and s.phase in ("decode", "prompt")
                   and s.request.priority < above_priority]
        if not victims:
            return False
        victims.sort()
        i = victims[0][2]
        req = self._slots[i].request
        t_admit = self._slots[i].t_admit
        ol = self.stats["overload"]
        ol["preemptions"] += 1
        meta = self._submit_meta.get(req.request_id)
        if meta is None:
            # admitted through admit_many (its callers may mix with submit
            # traffic): make its meta now so its age still counts
            meta = {"t_submit": t_admit, "seq": self._submit_seq,
                    "deferred": False, "preempts": 0, "t_preempt": None}
            self._submit_meta[req.request_id] = meta
            self._submit_seq += 1
        meta["preempts"] += 1
        meta["t_preempt"] = now
        self._release_slot(i)
        dropped = self._admq.push(QueueEntry(
            request=req, seq=meta["seq"], t_submit=meta["t_submit"],
            preempts=meta["preempts"]))
        if dropped is not None:
            # a queue full of work at least this valuable: the victim (or
            # the entry it displaced) is the least valuable in the system
            self._reject(dropped, REASON_QUEUE_FULL)
        return True

    # -- the step ---------------------------------------------------------
    def _slot_step(self) -> torch.Tensor:
        """All-slot decode step: ONE batched ``T.decode_step`` over the
        whole table with the (slots,) index vector (through the block
        table when paged).  Inactive slots compute garbage that nothing
        reads (paged: their table rows name the trash page) and keep their
        index.  Returns the tokens fed, (slots,) int32."""
        av = self.cfg.answer_vocab
        toks = torch.argmax(self._slot_logits[:, :av], dim=-1).to(torch.int32)
        bt = (self._block_table_dev() if self.cache_impl == "paged"
              else None)
        with self._tp():
            self._slot_logits, _ = T.decode_step(
                self._bb, self._mcfg, self._slot_cache,
                {"tokens": toks[:, None]}, self._slot_index, block_table=bt)
        self._slot_index = torch.where(self._active_mask_dev(),
                                       self._slot_index + 1,
                                       self._slot_index)
        return toks

    @torch.inference_mode()
    def step(self) -> List[Tuple[Request, np.ndarray]]:
        """Advance every active slot; return finished requests.

        Non-speculative engines commit one token per slot; speculative
        engines commit the longest verified draft prefix + 1 (up to γ+1
        tokens per slot), token-for-token the greedy stream.  Finished
        slots free immediately; callers refill them before the next
        ``step`` (continuous batching).  Overload-controlled engines pump
        their own admission queue first, so slots the previous step freed
        refill before the slots advance."""
        if self._admq is not None:
            self._pump_queue()
        if self.cfg.prefill_chunk and any(
                s.active and s.phase != "decode" for s in self._slots):
            return self._step_chunked()
        if self.cfg.spec_gamma:
            return self._step_spec()
        if self.active_count() == 0:
            return []
        toks = self._slot_step()
        toks_np = toks.cpu().numpy()  # spacelint: disable=SL001 (the single deliberate per-step fetch: committed tokens must reach the host-side scheduler)
        self._step_no += 1
        now = time.perf_counter()
        sched = self.stats["sched"]
        sched["steps"] += 1
        finished: List[Tuple[Request, np.ndarray]] = []
        for i, slot in enumerate(self._slots):
            if not slot.active:
                continue
            slot.tokens.append(int(toks_np[i]))
            sched["decode_tokens"] += 1
            if slot.t_first is None:
                slot.t_first = now
            if len(slot.tokens) >= slot.l_ans:
                self._finish_slot(i, finished)
        return finished

    # -- chunked prefill: the fused token-budget step ------------------------
    def _slot_pos(self, i: int) -> int:
        """A slot's logical cache index from the phase machine (the host
        owns it in chunked engines)."""
        slot = self._slots[i]
        if not slot.active:
            return 0
        if slot.phase == "decode":
            return self.ac.n_regions + 1 + len(slot.tokens)
        if slot.phase == "prompt":
            return self.ac.n_regions
        if slot.phase == "prefill":
            return self._streaming[slot.scene]["progress"]
        return 0                                   # wait: nothing written

    def _fused_step(self, srow: np.ndarray, tokens: np.ndarray,
                    pos: np.ndarray, patch_mask: np.ndarray,
                    use_argmax: np.ndarray, want_probs: bool = False
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """ONE step over a flat (token_budget,) batch: row ``j`` is one
        token of slot ``srow[j]`` at cache slot ``pos[j]``.  Decode rows
        feed their slot's argmax, prompt rows ``tokens[j]``, region rows
        the staged embedding at ``pos[j]``; a scene's chunk takes up to C
        consecutive rows on its streamer's table row, whose KV lands before
        the reads, so chunk token t sees its siblings < t through the
        cache.  Those rows share the prefix-append kernel's row tiles
        through a tile plan built here from ``srow`` and ``pos`` and
        shipped in the step's one host-to-device copy.  Padding rows
        (``srow == slots``) are unscheduled: their writes go to the trash
        page and their outputs are dropped.  The
        held logits of each slot with a decode or prompt row are replaced
        by that row's.  Returns (the flat tokens fed, the answer-vocab
        probabilities of the held logits before the step if asked)."""
        n_slots, n_r = self.cfg.slots, self.ac.n_regions
        av, tb, dev = self.cfg.answer_vocab, len(srow), self.device
        plan = PPA.tile_plan(srow, pos, n_slots, self._group,
                             self._plan_tiles)
        flat = self._host_to_dev(np.concatenate(
            [np.stack([srow, tokens, pos, patch_mask, use_argmax]),
             np.pad(plan, ((0, 0), (0, tb - plan.shape[1])))]
        ).astype(np.int32))
        srow_d, tokens_d, pos_d = flat[0], flat[1], flat[2]
        pmask, argm = flat[3].bool(), flat[4].bool()
        plan_d = flat[5:, :plan.shape[1]]
        valid = srow_d < n_slots
        sclamp = torch.clamp(srow_d, max=n_slots - 1).long()
        av_logits = self._slot_logits[:, :av]
        probs0 = torch.softmax(av_logits, dim=-1) if want_probs else None
        y1 = torch.argmax(av_logits, dim=-1).to(torch.int32)
        tok = torch.where(argm, y1[sclamp], tokens_d)
        feed = self._staging[sclamp, torch.clamp(pos_d, 0, n_r - 1).long()]
        with self._tp():
            logits_f, _ = T.prefill_chunk_step(
                self._bb, self._mcfg, self._slot_cache,
                {"tokens": tok[:, None], "patch_embeds": feed[:, None],
                 "patch_mask": pmask}, pos_d,
                block_table=self._block_table_dev()[sclamp],
                chunk_lens=valid.to(torch.int32), tile_plan=plan_d)
        # the flat row feeding each slot's logits (-1: none); unscheduled
        # and region rows all go to the dropped index ``n_slots``
        dest = torch.where(valid & ~pmask, srow_d, n_slots).long()
        src = torch.full((n_slots + 1,), -1, dtype=torch.long, device=dev)
        src = src.scatter_(0, dest, torch.arange(tb, device=dev))[:n_slots]
        self._slot_logits = torch.where(
            (src >= 0)[:, None], logits_f[torch.clamp(src, min=0)],
            self._slot_logits)
        return tok, probs0

    def _step_chunked(self) -> List[Tuple[Request, np.ndarray]]:
        """ONE fused token-budget step (Sarathi-style chunked prefill).

        The flat (token_budget,) batch takes every decode row first (one
        token each: admission never delays an in-flight answer), then the
        pending 1-token prompt suffixes, then up to C region tokens per
        streaming scene; prompts and streams go by priority, then FIFO.  A
        scene whose stream completes is published to the prefix cache and
        its streamer and waiters move to the prompt phase; speculative
        engines drafter-prefill the rows that reach the decode phase."""
        n_slots, C = self.cfg.slots, self._chunk
        n_r, tb = self.ac.n_regions, self._token_budget
        srow = np.full((tb,), n_slots, np.int32)
        tokens = np.zeros((tb,), np.int32)
        pos = np.zeros((tb,), np.int32)
        patch_mask = np.zeros((tb,), bool)
        use_argmax = np.zeros((tb,), bool)
        decode_rows = [i for i, s in enumerate(self._slots)
                       if s.active and s.phase == "decode"]
        prompt_rows = sorted(
            (i for i, s in enumerate(self._slots)
             if s.active and s.phase == "prompt"),
            key=lambda i: (-self._slots[i].request.priority, i))
        j = 0
        decode_flat = {}
        for i in decode_rows:
            srow[j] = i
            pos[j] = n_r + 1 + len(self._slots[i].tokens)
            use_argmax[j] = True
            decode_flat[i] = j
            j += 1
        scheduled_prompt = []
        for i in prompt_rows:
            if j >= tb:
                break
            req = self._slots[i].request
            srow[j] = i
            pos[j] = n_r
            tokens[j] = self.ac.prompt_id(req.task, req.prompt)
            scheduled_prompt.append(i)
            j += 1
        streams = sorted(self._streaming.items(),
                         key=lambda kv: (-kv[1]["priority"], kv[1]["order"]))
        stream_sched = []                          # (scene, tokens granted)
        for s_, st in streams:
            c = min(C, n_r - st["progress"], tb - j)
            if c <= 0:
                continue
            srow[j:j + c] = st["slot"]
            pos[j:j + c] = st["progress"] + np.arange(c)
            patch_mask[j:j + c] = True
            j += c
            stream_sched.append((s_, c))

        want_probs = any(self._slots[i].probs is not None
                         for i in decode_rows)
        tok, probs0 = self._fused_step(srow, tokens, pos, patch_mask,
                                       use_argmax, want_probs)
        toks_np = tok.cpu().numpy()  # spacelint: disable=SL001 (the single deliberate per-step fetch: committed tokens must reach the host-side phase machine)
        # spacelint: disable=SL001 (probs ride the step, and only for slots that asked for them)
        probs_np = probs0.cpu().numpy() if want_probs else None
        self._step_no += 1
        now = time.perf_counter()

        n_prompt = len(scheduled_prompt)
        n_chunk = sum(c for _, c in stream_sched)
        sched = self.stats["sched"]
        sched["steps"] += 1
        sched["fused_steps"] += 1
        sched["decode_tokens"] += len(decode_rows)
        sched["prompt_tokens"] += n_prompt
        sched["chunk_tokens"] += n_chunk
        sched["scheduled_tokens"] += len(decode_rows) + n_prompt + n_chunk
        if self._streaming and n_chunk == 0:
            sched["stall_steps"] += 1
        slog = sched["step_log"]
        slog.append((len(decode_rows), n_prompt, n_chunk))
        if len(slog) > self._occupancy_cap:
            del slog[:self._occupancy_cap // 2]
        self._note_prefill("prompt", n_prompt)
        self._note_prefill("chunk", n_chunk)

        if self.cfg.spec_gamma and decode_rows:
            # fused steps commit decode tokens through the plain path the
            # drafter never sees: mirror them into its cache
            dtoks = np.zeros((n_slots,), np.int32)
            didx = np.zeros((n_slots,), np.int32)
            for i in decode_rows:
                dtoks[i] = toks_np[decode_flat[i]]
                didx[i] = pos[decode_flat[i]]
            self._draft_feed(dtoks, didx)

        finished: List[Tuple[Request, np.ndarray]] = []
        for i in decode_rows:
            slot = self._slots[i]
            slot.tokens.append(int(toks_np[decode_flat[i]]))
            if slot.t_first is None:
                slot.t_first = now
            if slot.probs is not None:
                slot.probs.append(probs_np[i])
            if len(slot.tokens) >= slot.l_ans:
                self._finish_slot(i, finished)
        for i in scheduled_prompt:
            self._slots[i].phase = "decode"
        for s_, c in stream_sched:
            st = self._streaming[s_]
            st["progress"] += c
            if st["progress"] < n_r:
                continue
            # stream complete: publish the prefix (the alloc-time page
            # reference becomes the cache's own) and move the streamer and
            # every waiter to the prompt phase, remapping the waiters'
            # shared blocks off the trash page
            del self._streaming[s_]
            self._prefix.put(s_, st["pages"], None)
            for jj, slot in enumerate(self._slots):
                if (slot.active and slot.scene == s_
                        and slot.phase in ("prefill", "wait")):
                    self._prefix.acquire(s_)
                    if slot.phase == "wait":
                        self._bt_np[jj, :self._n_shared_pages] = st["pages"]
                        self._bt_dev = None
                    slot.phase = "prompt"
        # the per-slot index the plain and speculative steps read once the
        # streams drain (fused steps take positions per flat token)
        self._slot_index = self._host_to_dev(np.asarray(
            [self._slot_pos(i) for i in range(n_slots)], np.int32))
        if self.cfg.spec_gamma and scheduled_prompt:
            self._draft_prefill_rows(scheduled_prompt)
        return finished

    def _draft_feed(self, toks: np.ndarray, idx: np.ndarray) -> None:
        """Mirror tokens committed outside a speculative step (the fused
        steps' decode rows) into the drafter's cache at per-row ``idx``, so
        it holds exactly the committed stream and later drafts see no
        zero-KV gaps.  Rows with nothing committed write a token at
        position 0 of drafter rows that are prefilled anew before their
        next draft (at the prompt-to-decode transition), so nothing reads
        it."""
        T.decode_step(self.draft.params["backbone"], self.draft.cfg,
                      self._draft_cache,
                      {"tokens": self._host_to_dev(toks)[:, None]},
                      self._host_to_dev(idx))

    def _draft_prefill(self, requests: List[Request], ptoks: np.ndarray,
                       rows: List[int]) -> None:
        """The drafter's [regions | prompt] prefill of ``requests`` into its
        dense cache rows ``rows`` (it mirrors the slot table on its own
        cache, which is cheap and never shared)."""
        _, dcache, _ = EO.prefill_tokens(
            self.draft.params, self.draft.cfg, self.ac,
            self._images(requests), self._host_to_dev(ptoks),
            self._draft_max_len)
        slots = self._host_to_dev(rows)
        for full, new in zip(self._draft_cache, dcache):
            _sel_scatter(full, new, slots, 1)
        self._note_prefill("draft", len(rows) * (self.ac.n_regions + 1))

    def _draft_prefill_rows(self, rows: List[int]) -> None:
        """Chunked + speculative engines: drafting starts when a slot
        reaches the decode phase, so its drafter prefill runs then, not at
        admission (which stays free of model forwards)."""
        reqs = [self._slots[i].request for i in rows]
        ptoks = np.asarray([self.ac.prompt_id(r.task, r.prompt)
                            for r in reqs], np.int32)
        self._draft_prefill(reqs, ptoks, rows)

    # -- speculative decoding ----------------------------------------------
    def _verify_accept(self, chunk: torch.Tensor):
        """ONE γ+1-token scoring step of this tier + the longest accepted
        prefix per row, on the device.  ``chunk``: (slots, γ+1) =
        [y₁ | d₁..d_γ], y₁ this tier's own next token, d_i the drafts.
        d_i commits iff it equals the verifier's argmax at its position.
        Rollback is the index update (idx += 1 + accepted): rejected
        positions stay in row-private pages and the next chunk overwrites
        them.  Returns (n_commit (slots,), tok_probs (slots, γ+1, V_ans))
        and updates the held logits and index."""
        g, av = self.cfg.spec_gamma, self.cfg.answer_vocab
        with self._tp():
            logits_all, _ = T.verify_step(
                self._bb, self._mcfg, self._slot_cache,
                {"tokens": chunk}, self._slot_index,
                block_table=self._block_table_dev())
        gtok = torch.argmax(logits_all[..., :av], dim=-1).to(torch.int32)
        eq = (gtok[:, :g] == chunk[:, 1:]).to(torch.int32)
        acc = torch.cumprod(eq, dim=1).sum(dim=1)          # (S,) prefix
        n_commit = 1 + acc
        # the distribution each chunk token was argmaxed from: y₁ ← the held
        # logits, chunk token j ← the verifier's logits after chunk[..j-1]
        tok_probs = torch.softmax(torch.cat(
            [self._slot_logits[:, None, :av], logits_all[:, :-1, :av]],
            dim=1), dim=-1)
        rows = torch.arange(chunk.shape[0], device=chunk.device)
        self._slot_logits = logits_all[rows, acc]
        self._slot_index = torch.where(
            self._active_mask_dev(), self._slot_index + n_commit,
            self._slot_index).to(torch.int32)
        return n_commit, tok_probs

    def _draft_chunk(self, pending: torch.Tensor,
                     pending_len: torch.Tensor) -> torch.Tensor:
        """γ+1 compact-model feeds over the drafter's dense cache, from each
        row's y₁ at its committed index.  Piggybacked ``pending`` drafts
        override the drafter's argmax where provided and are fed through
        it, so its cache tracks the committed stream; the last feed writes
        the last draft's KV.  Returns the chunk [y₁ | d₁..d_γ]."""
        g, av = self.cfg.spec_gamma, self.cfg.answer_vocab
        dparams, dcfg = self.draft.params, self.draft.cfg
        y1 = torch.argmax(self._slot_logits[:, :av], dim=-1).to(torch.int32)
        tok, i, drafts = y1, self._slot_index, []
        for j in range(g + 1):
            dlogits, _ = T.decode_step(dparams["backbone"], dcfg,
                                       self._draft_cache,
                                       {"tokens": tok[:, None]}, i)
            nxt = torch.argmax(dlogits[:, :av], dim=-1).to(torch.int32)
            nxt = torch.where(j < pending_len, pending[:, min(j, g - 1)],
                              nxt)
            drafts.append(nxt)
            tok, i = nxt, i + 1
        return torch.cat([y1[:, None], torch.stack(drafts[:g], dim=1)], dim=1)

    def _step_spec(self) -> List[Tuple[Request, np.ndarray]]:
        """Speculative all-slot step: draft γ tokens per row (piggybacked
        drafts supply them where available), verify all of them in ONE
        scoring step, commit each row's longest accepted prefix + 1.  When
        every active row's useful drafts were piggybacked, the drafter is
        skipped (verify-only); its cache then goes stale for those rows,
        which can only lower later local accept rates, never correctness."""
        if self.active_count() == 0:
            return []
        g, n_slots = self.cfg.spec_gamma, self.cfg.slots
        pend = np.zeros((n_slots, g), np.int32)
        plen = np.zeros((n_slots,), np.int32)
        n_active = covered = 0
        for i, slot in enumerate(self._slots):
            if not slot.active:
                continue
            n_active += 1
            p = slot.pending_drafts
            if p:
                # y₁ covers answer position len(tokens); draft j predicts
                # position len(tokens) + j
                off = len(slot.tokens) + 1
                avail = p[off:off + g]
                pend[i, :len(avail)] = avail
                plen[i] = len(avail)
            # drafts past the answer end are useless
            useful = min(g, max(slot.l_ans - len(slot.tokens) - 1, 0))
            if plen[i] >= useful:
                covered += 1
        sp = self.stats["spec"]
        pend_dev = self._host_to_dev(pend)
        verify_only = covered == n_active
        if verify_only:
            av = self.cfg.answer_vocab
            y1 = torch.argmax(self._slot_logits[:, :av],
                              dim=-1).to(torch.int32)
            chunk = torch.cat([y1[:, None], pend_dev], dim=1)
            sp["verify_only_steps"] += 1
        else:
            chunk = self._draft_chunk(pend_dev, self._host_to_dev(plen))
        n_commit, tok_probs = self._verify_accept(chunk)
        # spacelint: disable=SL001 (the single deliberate per-step fetch: the verified chunk and its accept counts reach the host-side scheduler together)
        fetched = torch.cat([chunk, n_commit[:, None].to(chunk.dtype)],
                            dim=1).cpu().numpy()
        chunk_np, n_np = fetched[:, :-1], fetched[:, -1]
        probs_np = None
        if any(s.active and s.probs is not None for s in self._slots):
            # spacelint: disable=SL001 (probs ride the step, and only for slots that asked for them)
            probs_np = tok_probs.cpu().numpy()
        self._step_no += 1
        now = time.perf_counter()
        sp["steps"] += 1
        sp["slot_steps"] += n_active
        sp["piggybacked"] += int(plen.sum())
        sched = self.stats["sched"]
        sched["steps"] += 1
        finished: List[Tuple[Request, np.ndarray]] = []
        for i, slot in enumerate(self._slots):
            if not slot.active:
                continue
            n = int(n_np[i])
            # accept-rate accounting counts REAL drafts only: the drafter
            # proposes γ per row, a verify-only step exactly plen[i]
            real = int(plen[i]) if verify_only else g
            sp["drafted"] += real
            sp["accepted"] += min(n - 1, real)
            sp["committed"] += n
            for j in range(n):
                pos = len(slot.tokens)
                if pos >= slot.l_ans:
                    break                       # over-commit past the answer
                t = int(chunk_np[i, j])
                p = slot.pending_drafts
                if p is not None and pos < len(p) and p[pos] != t:
                    slot.pending_drafts = None  # the draft stream diverged
                slot.tokens.append(t)
                if slot.t_first is None:
                    slot.t_first = now
                if slot.probs is not None:
                    slot.probs.append(probs_np[i, j])
                sp["emitted"] += 1
                sched["decode_tokens"] += 1
            if len(slot.tokens) >= slot.l_ans:
                self._finish_slot(i, finished)
        return finished

    def _stash_spec_probs(self, slot: _Slot) -> None:
        """Keep a finished slot's per-token probability rows for
        ``generate_spec`` (bounded)."""
        if not slot.probs:
            return
        self._spec_probs[slot.request.request_id] = np.stack(slot.probs)
        while len(self._spec_probs) > 64:
            self._spec_probs.popitem(last=False)

    # ------------------------------------------------------------------
    # stats
    # ------------------------------------------------------------------
    def scheduler_stats(self) -> Dict[str, Any]:
        """Step counters + derived rates, for every engine flavour; the
        fused-step fields (budget utilisation, token mix, stall steps) are
        only non-trivial for chunked engines; overload-controlled engines
        add an ``"overload"`` block (queue depth and peak, deferrals,
        preemptions, rejections by reason, re-admission wait, TTFT from
        submit by priority).  There is no ``steady_recompiles``: eager
        PyTorch compiles nothing per shape."""
        sched = self.stats["sched"]
        out = {k: v for k, v in sched.items() if k != "step_log"}
        steps = max(sched["steps"], 1)
        out["tokens_per_step"] = {
            "decode": sched["decode_tokens"] / steps,
            "prompt": sched["prompt_tokens"] / steps,
            "chunk": sched["chunk_tokens"] / steps,
        }
        fused = sched["fused_steps"]
        out["budget_utilization"] = (
            sched["scheduled_tokens"] / (fused * sched["budget"])
            if fused and sched["budget"] else 0.0)
        out["prefill_by_kind"] = dict(self.stats["prefill_by_kind"])
        if self._admq is not None:
            ol = self.stats["overload"]
            # per-priority TTFT from SUBMIT time (the queue wait is
            # charged): under saturation the urgent class's tail should
            # hold while bulk's degrades
            by_prio: Dict[int, List[float]] = {}
            for e in self.stats["request_log"]:
                if e["t_first"] is not None:
                    by_prio.setdefault(e["priority"], []).append(
                        e["t_first"] - e["t_submit"])
            ttft = {
                p: {"n": len(v),
                    "p50_ms": float(np.percentile(v, 50)) * 1e3,
                    "p99_ms": float(np.percentile(v, 99)) * 1e3}
                for p, v in sorted(by_prio.items())}
            wait = ol["readmit_wait_s"]
            out["overload"] = {
                "queue_depth": len(self._admq),
                "queue_peak": self._admq.depth_peak,
                "submitted": ol["submitted"],
                "admissions_deferred": ol["admissions_deferred"],
                "preemptions": ol["preemptions"],
                "rejections": dict(ol["rejections"]),
                "rejected_total": sum(ol["rejections"].values()),
                "readmit_wait_ms": {
                    "n": len(wait),
                    "mean": float(np.mean(wait)) * 1e3 if wait else 0.0,
                    "p50": (float(np.percentile(wait, 50)) * 1e3
                            if wait else 0.0)},
                "ttft_by_priority": ttft,
            }
        return out

    def spec_stats(self) -> Dict[str, Any]:
        """Speculative-decoding counters + derived rates (empty when off)."""
        sp = dict(self.stats.get("spec") or {})
        if not sp:
            return sp
        sp["accept_rate"] = sp["accepted"] / max(sp["drafted"], 1)
        sp["drafts_per_step"] = sp["drafted"] / max(sp["steps"], 1)
        sp["tokens_per_slot_step"] = (sp["committed"]
                                      / max(sp["slot_steps"], 1))
        sp["piggyback_frac"] = sp["piggybacked"] / max(sp["drafted"], 1)
        return sp

    def generate_spec(self, task: str, images: torch.Tensor,
                      prompts: torch.Tensor, answer_vocab: int,
                      draft_tokens=None, priority: int = 0,
                      deadline_s: Optional[float] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Batch-of-one greedy answer through the speculative slot path, so
        piggybacked answer tokens can seed the verify chunks.  Honours
        ``generate``'s contract: the same tokens, and probs that are the
        answer-vocab distributions each token was argmaxed from.  Meant for
        a dedicated core (it drains only its own request)."""
        if not self.cfg.spec_gamma:
            raise ValueError("generate_spec requires spec_gamma > 0")
        if answer_vocab != self.cfg.answer_vocab:
            raise ValueError(f"answer_vocab {answer_vocab} != engine "
                             f"answer_vocab {self.cfg.answer_vocab}")
        req = Request(task=task, image=images[0].cpu().numpy(),
                      prompt=int(prompts[0]), draft_tokens=draft_tokens,
                      priority=priority, deadline_s=deadline_s)
        req._wants_probs = True
        self.admit_many([req])
        while True:
            for r, toks in self.step():
                if r is req:
                    probs = self._spec_probs.pop(req.request_id)
                    return (torch.from_numpy(toks[None]).to(self.device),
                            torch.from_numpy(probs[None]).to(self.device))

    def kv_stats(self) -> Dict[str, Any]:
        """KV-cache footprint of the slot table.  ``kv_bytes_per_slot``:
        dense, the reserved worst-case row every slot holds; paged, each
        active slot's private pages plus its amortised share of the prefix
        pages it maps (idle engines report the reserved-page
        equivalent)."""
        self._ensure_slot_tables()
        # under a mesh the pools hold this rank's KV heads: the numbers
        # below are global (the logical pool, as the JAX engine reports),
        # the "_device" ones this rank's
        tp_kv = (self._tp_plan.tp if self._tp_plan is not None
                 and self._tp_plan.attn else 1)
        total = tp_kv * sum(t.numel() * t.element_size()
                            for layer in self._slot_cache
                            for t in layer.values())
        scales = tp_kv * sum(t.numel() * t.element_size()
                             for layer in self._slot_cache
                             for name, t in layer.items()
                             if name.endswith("_scale"))
        out: Dict[str, Any] = {"cache_impl": self.cache_impl,
                               "kv_bytes_total": int(total),
                               "kv_dtype": self.cfg.kv_dtype,
                               #: the f32 scales of an 8-bit pool, inside
                               #: kv_bytes_total
                               "kv_scale_bytes": int(scales)}
        adm = self.stats["prefix_hits"] + self.stats["prefix_misses"]
        out["prefix_hit_rate"] = (self.stats["prefix_hits"] / adm
                                  if adm else 0.0)
        out["prefill_tokens"] = self.stats["prefill_tokens"]
        if self.cache_impl == "dense":
            out["kv_bytes_per_slot"] = int(total // self.cfg.slots)
            return out
        page_bytes = total // self._n_pages
        assert page_bytes == self._page_nbytes_stack()
        out.update(page_size=self._page_size, n_pages=self._n_pages,
                   page_bytes=int(page_bytes),
                   pages_in_use=self._pool.pages_in_use,
                   **{f"prefix_{k}": v for k, v in
                      self._prefix.stats().items()})
        active = [s for s in self._slots if s.active]
        if active:
            pages = 0.0
            for s in active:
                entry = self._prefix.get(s.scene)
                if entry is None:
                    # chunked: the scene is still streaming; its streamer is
                    # charged the whole shared group, its waiters nothing
                    share = (self._n_shared_pages
                             if s.phase == "prefill" else 0)
                else:
                    share = self._n_shared_pages / max(entry.users, 1)
                pages += self._private_per_slot + share
            out["kv_bytes_per_slot"] = int(page_bytes * pages / len(active))
        else:
            out["kv_bytes_per_slot"] = int(page_bytes * self._pages_per_slot)
        if self.mesh is not None:
            out["mesh"] = {a: int(self.mesh.shape[a])
                           for a in self.mesh.axis_names}
            out["tp_kv_shards"] = tp_kv
            out["kv_bytes_total_device"] = int(total // tp_kv)
            out["kv_bytes_per_slot_device"] = int(
                out["kv_bytes_per_slot"] // tp_kv)
        return out
