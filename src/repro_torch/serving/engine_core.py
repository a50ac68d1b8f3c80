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

Every tensor shape of the slot path is fixed when the tables are allocated
(pools, block table, logits, index), so a later CUDA graph can capture the
step.  Chunked prefill, overload control, quantized pools, the device mesh
and the ``step_impl="vmap"`` oracle are not ported yet: setting them raises
``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

import dataclasses
import math
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import eo_adapter as EO
from repro_torch.kernels import ops
from repro_torch.models import transformer as T
from repro_torch.serving.kv_pool import (KVPagePool, PrefixCache, TRASH_PAGE,
                                         page_nbytes)
from repro_torch.serving.request import Request, scene_key

Params = Dict[str, Any]

#: fields of the JAX engine configs outside the port so far: (field, the
#: value the port takes, where ROADMAP queue 1 lists it)
NOT_PORTED = (
    ("prefill_chunk", 0, "item 8 (chunked prefill)"),
    ("token_budget", None, "item 8 (chunked prefill)"),
    ("overload", None, "item 9 (overload control)"),
    ("kv_dtype", None, "item 10 (quantized paged KV)"),
    ("pool_bytes", None, "item 10 (quantized paged KV)"),
    ("mesh", None, "item 13 (sharded serving)"),
)


def check_ported(cfg: Any) -> None:
    """Raise ``NotImplementedError`` for a config field set to anything the
    port does not run yet."""
    for name, value, item in NOT_PORTED:
        if getattr(cfg, name) != value:
            raise NotImplementedError(
                f"{name}={getattr(cfg, name)!r} is not ported "
                f"(ROADMAP queue 1, {item})")
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
    prefill_chunk: int = 0                 # not ported (ROADMAP item 8)
    token_budget: Optional[int] = None     # not ported (ROADMAP item 8)
    #: explicit KV pool size in pages (paged only); None → the worst-case
    #: bound, under which admission never runs out of pages
    pool_pages: Optional[int] = None
    pool_bytes: Optional[int] = None       # not ported (ROADMAP item 10)
    kv_dtype: Optional[str] = None         # not ported (ROADMAP item 10)
    mesh: Optional[Any] = None             # not ported (ROADMAP item 13)
    overload: Optional[Any] = None         # not ported (ROADMAP item 9)

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
            self._draft_max_len = self._slot_max_len + self.cfg.spec_gamma
        # a verify chunk writes γ positions past the committed index, so
        # spec engines reserve γ extra KV slots per row
        self._spec_margin = self.cfg.spec_gamma

        @torch.inference_mode()
        def _encode(images, ptok):
            rf = EO.encode_regions(params, ac, images)
            tf = EO.encode_text(params, cfg, ptok)
            return rf, tf, rf.float().mean(dim=1)

        self._encode = _encode
        self._token_feats = torch.inference_mode()(
            lambda toks: EO.token_features(params, toks))
        # scene-keyed encode memo for the serve path (bounded LRU)
        self._encode_cache: "OrderedDict[Any, Tuple]" = OrderedDict()
        self._encode_cache_cap = 32

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
            if self.cfg.pool_pages is not None:
                floor = 1 + self._pages_per_slot
                if self.cfg.pool_pages < floor:
                    raise ValueError(
                        f"pool_pages {self.cfg.pool_pages} below the "
                        f"single-slot floor {floor} (trash page + one "
                        "slot's worst-case pages)")
                self._n_pages = self.cfg.pool_pages
            self._pool = KVPagePool(self._n_pages, ps)
            self._prefix = PrefixCache(self._pool, capacity=n_slots + scenes)
            self._bt_np = np.full((n_slots, self._pages_per_slot),
                                  TRASH_PAGE, np.int32)
            self._bt_dev = None
        elif self.cfg.pool_pages is not None:
            raise ValueError("pool_pages only applies to the paged cache")

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
            #: per-step scheduling ledger; the fused-step fields stay 0
            #: (chunked prefill is not ported)
            "sched": {"steps": 0, "fused_steps": 0, "decode_tokens": 0,
                      "prompt_tokens": 0, "chunk_tokens": 0,
                      "scheduled_tokens": 0, "stall_steps": 0,
                      "budget": 0, "step_log": []},
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
                self._slot_cache = T.init_paged_cache(
                    cfg, n, self._n_pages, self._page_size, dev)
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

    def _page_nbytes_stack(self) -> int:
        """Device bytes ONE pool page costs across the whole stack (every
        attention layer's K+V pools)."""
        cfg = self.tier.cfg
        n_kv = cfg.n_super * len(cfg.block_pattern)
        return n_kv * page_nbytes(
            self._page_size, cfg.num_kv_heads, cfg.resolved_head_dim,
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
        buckets to pre-compile as in the JAX engine.  Slot state is
        untouched."""
        self._ensure_slot_tables()
        if self.device.type == "cuda":
            for kernel in ops.KERNELS.values():
                kernel.bind()

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
                           private=None,
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
                probs=[] if wants_probs else None, t_admit=now)
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

        def kv(pool: Params, pref: Params) -> Params:
            for name, leaf in pool.items():
                x = pref[name]                     # (n_super, K, N_r, KH, hd)
                ns = x.shape[0]
                leaf[:, pages] = x.reshape((ns, km * n_shared, ps)
                                           + tuple(x.shape[3:]))
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
        logits, _ = T.decode_step(
            self.tier.params["backbone"], self.tier.cfg, self._slot_cache,
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
            # the drafter mirrors the slot table on its own dense cache: one
            # [regions | prompt] prefill for the admitted batch
            _, dcache, _ = EO.prefill_tokens(
                self.draft.params, self.draft.cfg, self.ac,
                self._images(requests), self._host_to_dev(ptoks),
                self._draft_max_len)
            slots = self._host_to_dev(target)
            for full, new in zip(self._draft_cache, dcache):
                _sel_scatter(full, new, slots, 1)
            self._note_prefill("draft", k * (self.ac.n_regions + 1))
        self._record_admissions(target, requests, scenes=scenes,
                                private=private, t_admit=t_admit)
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
        log.append({"request_id": slot.request.request_id,
                    "task": slot.request.task, "t_admit": slot.t_admit,
                    "t_first": slot.t_first, "t_done": time.perf_counter(),
                    "priority": slot.request.priority})
        if len(log) > self._occupancy_cap:
            del log[:self._occupancy_cap // 2]
        if slot.probs:
            self._stash_spec_probs(slot)
        self._release_slot(i)
        self.stats["finished"] += 1

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
        self._slot_logits, _ = T.decode_step(
            self.tier.params["backbone"], self.tier.cfg, self._slot_cache,
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
        ``step`` (continuous batching)."""
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
        logits_all, _ = T.verify_step(
            self.tier.params["backbone"], self.tier.cfg, self._slot_cache,
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
        """Step counters + derived rates.  The fused-step fields stay 0
        (chunked prefill is not ported), and there is no
        ``steady_recompiles``: eager PyTorch compiles nothing per shape."""
        sched = self.stats["sched"]
        out = {k: v for k, v in sched.items() if k != "step_log"}
        steps = max(sched["steps"], 1)
        out["tokens_per_step"] = {
            "decode": sched["decode_tokens"] / steps,
            "prompt": sched["prompt_tokens"] / steps,
            "chunk": sched["chunk_tokens"] / steps,
        }
        out["budget_utilization"] = 0.0
        out["prefill_by_kind"] = dict(self.stats["prefill_by_kind"])
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
        total = sum(t.numel() * t.element_size()
                    for layer in self._slot_cache for t in layer.values())
        out: Dict[str, Any] = {"cache_impl": self.cache_impl,
                               "kv_bytes_total": int(total),
                               "kv_dtype": None, "kv_scale_bytes": 0}
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
                pages += (self._private_per_slot
                          + self._n_shared_pages / max(entry.users, 1))
            out["kv_bytes_per_slot"] = int(page_bytes * pages / len(active))
        else:
            out["kv_bytes_per_slot"] = int(page_bytes * self._pages_per_slot)
        return out
