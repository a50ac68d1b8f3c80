"""Data-parallel serving over a device mesh: the slot table, split.

The port of ``repro.serving.sharded``.  ``EngineCore`` handles the mesh's
tensor-parallel "model" axis itself (head-split projections and page pools
over the mesh's process group); this module adds the "data" axis on top.
A ``ShardedEngineCore`` carves the slot table into one disjoint slot range
per data shard and runs an ordinary ``EngineCore`` for each on its own
1-row sub-mesh, so every shard owns a private page pool, block table and
prefix cache.  The data axis needs no collective: every rank process of the
model axis hosts all the shards and runs the same router on the same
requests.  A shard on another device than the tier's gets its own copy of
the weights there; on one card all shards share one copy.  The router is
host scheduling:

- **Routing** is scene-affine first (a request whose scene is already
  page-resident or streaming on a shard goes there: prefix pages are
  per shard, so affinity is what keeps the prefix-cache hit rate under
  fan-out), least-loaded otherwise (most free slots, then fewest pages in
  use, then lowest shard id, so routing is replayable).
- **Admission** (``admit_many``) is capacity-aware: affinity only wins
  when the target shard has a free slot, so the "admit up to the free-slot
  count" contract aggregates.
- **Overload control** (``submit_many``) routes per request, then each
  shard's own page-pool-aware admission queue arbitrates its range;
  outcome dicts merge, ``take_rejected`` drains every shard.
- **Slot ids** are global, ``shard_offset + local_id``, so callers see one
  contiguous table, as a single core reports it.

``make_engine_core`` is the factory the engine layer uses: a plain
``EngineCore`` for ``mesh=None`` or a pure-TP mesh, a ``ShardedEngineCore``
when the mesh's data axis is above 1.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import eo_adapter as EO
from repro_torch.core.cascade import TierModel
from repro_torch.device import same_device
from repro_torch.distributed import sharding as SH
from repro_torch.launch.mesh import Mesh
from repro_torch.serving.engine_core import EngineCore, EngineCoreConfig
from repro_torch.serving.request import Request, scene_key
from repro_torch.tree import tree_map


def _submesh(mesh: Mesh, row: int) -> Mesh:
    """Row ``row`` of the (data, model) device grid as a (1, model) mesh
    over the same group: the shard-local mesh its EngineCore runs
    tensor-parallel on."""
    return Mesh(mesh.devices[row:row + 1], mesh.group)


def _tier_on(tier, device: torch.device, copies: Dict[str, Any]):
    """``tier`` with its weights on ``device``: the tier itself where they
    lie there already, else one copy per device (``copies``)."""
    if same_device(tier.params["patch_proj"].device, device):
        return tier
    key = str(device)
    if key not in copies:
        copies[key] = TierModel(tree_map(lambda t: t.to(device),
                                         tier.params), tier.cfg)
    return copies[key]


class ShardedEngineCore:
    """DP router over per-shard ``EngineCore``s (disjoint slot ranges)."""

    def __init__(self, tier, adapter_cfg: EO.EOAdapterConfig,
                 core_cfg: Optional[EngineCoreConfig] = None,
                 draft=None):
        self.cfg = core_cfg or EngineCoreConfig()
        mesh = self.cfg.mesh
        if mesh is None:
            raise ValueError("ShardedEngineCore requires a mesh "
                             "(EngineCore is the single-device engine)")
        dp = SH.mesh_axis_size(mesh, "data")
        if dp < 2:
            raise ValueError(
                f"data axis is {dp}: a pure-TP mesh belongs to EngineCore "
                "directly (use make_engine_core to pick automatically)")
        if self.cfg.slots < dp:
            raise ValueError(
                f"slots={self.cfg.slots} cannot split over {dp} data "
                "shards (every shard needs at least one slot)")
        self.mesh = mesh
        self.tier = tier
        self.ac = adapter_cfg
        self.draft = draft

        base, extra = divmod(self.cfg.slots, dp)
        sizes = [base + (1 if i < extra else 0) for i in range(dp)]
        #: global slot id of each shard's slot 0
        self._offsets: List[int] = np.cumsum([0] + sizes).tolist()
        self._shards: List[EngineCore] = []
        tiers: Dict[str, Any] = {}
        drafts: Dict[str, Any] = {}
        for i in range(dp):
            dev = torch.device(mesh.device(i))
            self._shards.append(EngineCore(
                _tier_on(tier, dev, tiers), adapter_cfg,
                self._shard_cfg(sizes[i], dp, _submesh(mesh, i)),
                draft=(None if draft is None
                       else _tier_on(draft, dev, drafts))))
        #: requests routed to each shard so far (the queue-routing counter
        #: surfaced per shard in scheduler_stats)
        self._routed: List[int] = [0] * dp
        #: router-level continuous-batching proof: admissions that landed
        #: while ANY global slot was mid-decode (a 1-slot shard never
        #: refills "mid-stream" locally even when the fleet is busy)
        self._stepped = False
        self._refills = 0
        self.cache_impl = self._shards[0].cache_impl

    def _shard_cfg(self, slots_i: int, dp: int, sub) -> EngineCoreConfig:
        """One shard's EngineCoreConfig: its slot-range size, its 1/dp cut
        of every pool/budget knob, its own sub-mesh."""
        cfg = self.cfg
        kw: Dict[str, Any] = dict(mesh=sub, slots=slots_i)
        if cfg.pool_pages is not None:
            kw["pool_pages"] = cfg.pool_pages // dp
        if cfg.pool_bytes is not None:
            kw["pool_bytes"] = cfg.pool_bytes // dp
        if cfg.prefix_cache_scenes is not None:
            kw["prefix_cache_scenes"] = max(
                -(-cfg.prefix_cache_scenes // dp), 1)
        if cfg.token_budget is not None:
            # split the above-slots prefill allowance, keeping every
            # shard's budget strictly above its own slot count (the
            # no-starvation invariant EngineCore enforces)
            spare = max(cfg.token_budget - cfg.slots, dp)
            kw["token_budget"] = slots_i + max(-(-spare // dp), 1)
        return dataclasses.replace(cfg, **kw)

    # -- identity / capacity --------------------------------------------
    @property
    def shards(self) -> List[EngineCore]:
        return list(self._shards)

    @property
    def _slots(self):
        """Read-only concatenated slot view (global order)."""
        return [s for sh in self._shards for s in sh._slots]

    @property
    def _slot_logits(self):
        return tuple(sh._slot_logits for sh in self._shards)

    def free_slots(self) -> List[int]:
        return [off + s for off, sh in zip(self._offsets, self._shards)
                for s in sh.free_slots()]

    def active_count(self) -> int:
        return sum(sh.active_count() for sh in self._shards)

    def warmup(self) -> None:
        for sh in self._shards:
            sh.warmup()

    # -- routing --------------------------------------------------------
    def _affine_shard(self, request: Request) -> Optional[int]:
        """Shard already holding this request's scene prefix (resident
        pages or a mid-flight chunked stream), if any."""
        if self.cache_impl != "paged":
            return None
        s_ = scene_key(request)
        for i, sh in enumerate(self._shards):
            if s_ in sh._prefix:
                return i
            if self.cfg.prefill_chunk and s_ in sh._streaming:
                return i
        return None

    def _least_loaded(self, free: List[int]) -> int:
        """Most free slots, then fewest pool pages in use, then lowest id:
        a deterministic tie-break so routing is replayable."""
        def load(i: int) -> Tuple[int, int, int]:
            pages = (self._shards[i]._pool.pages_in_use
                     if self.cache_impl == "paged" else 0)
            return (-free[i], pages, i)
        return min(range(len(self._shards)), key=load)

    def route(self, request: Request,
              free: Optional[List[int]] = None,
              batch_scenes: Optional[Dict[Any, int]] = None) -> int:
        """Pick the shard for ``request``: scene affinity when the target
        has capacity, least-loaded otherwise.  ``free`` is the caller's
        running free-slot ledger (mutated by greedy batch assignment);
        ``batch_scenes`` maps scenes already placed earlier in the same
        batch, so same-scene fan-out inside one admit call stays together
        before any shard's prefix cache has seen it."""
        if free is None:
            free = [len(sh.free_slots()) for sh in self._shards]
        aff = self._affine_shard(request)
        if aff is None and batch_scenes is not None:
            aff = batch_scenes.get(scene_key(request))
        if aff is not None and free[aff] > 0:
            return aff
        return self._least_loaded(free)

    # -- admission (admit up to the free slots, else raise) ---------------
    def admit(self, request: Request) -> int:
        return self.admit_many([request])[0]

    def admit_many(self, requests: List[Request]) -> List[int]:
        """Route and admit a batch; returns GLOBAL slot ids, in request
        order.  One ``admit_many`` per shard that received work."""
        if not requests:
            return []
        free = [len(sh.free_slots()) for sh in self._shards]
        if len(requests) > sum(free):
            raise RuntimeError(
                f"admit_many: {len(requests)} requests exceed the "
                f"{sum(free)} free slots across {len(self._shards)} shards")
        if self._stepped:
            act = self.active_count()
            self._refills += sum(1 for j in range(len(requests))
                                 if act + j > 0)
        assign: List[List[Tuple[int, Request]]] = [
            [] for _ in self._shards]
        batch_scenes: Dict[Any, int] = {}
        for j, r in enumerate(requests):
            i = self.route(r, free, batch_scenes)
            free[i] -= 1
            self._routed[i] += 1
            batch_scenes.setdefault(scene_key(r), i)
            assign[i].append((j, r))
        out: List[int] = [-1] * len(requests)
        for i, batch in enumerate(assign):
            if not batch:
                continue
            local = self._shards[i].admit_many([r for _, r in batch])
            for (j, _r), sid in zip(batch, local):
                out[j] = self._offsets[i] + sid
        return out

    # -- overload-controlled admission -----------------------------------
    def submit_many(self, requests: List[Request],
                    now: Optional[float] = None) -> Dict[int, str]:
        """Route each request to a shard, then submit per shard: each
        shard's own bounded priority queue and page-aware pump arbitrates
        its slot range.  Outcomes merge by request id."""
        if not requests:
            return {}
        free = [len(sh.free_slots()) for sh in self._shards]
        assign: List[List[Request]] = [[] for _ in self._shards]
        batch_scenes: Dict[Any, int] = {}
        for r in requests:
            i = self.route(r, free, batch_scenes)
            if free[i] > 0:
                free[i] -= 1
            self._routed[i] += 1
            batch_scenes.setdefault(scene_key(r), i)
            assign[i].append(r)
        out: Dict[int, str] = {}
        for i, batch in enumerate(assign):
            if batch:
                out.update(self._shards[i].submit_many(batch, now=now))
        return out

    def queue_depth(self) -> int:
        return sum(sh.queue_depth() for sh in self._shards)

    def take_rejected(self) -> List[Tuple[Request, str]]:
        out: List[Tuple[Request, str]] = []
        for sh in self._shards:
            out.extend(sh.take_rejected())
        return out

    def page_demand(self, request: Request) -> int:
        # identical across shards (same model / page geometry)
        return self._shards[0].page_demand(request)

    # -- serving ---------------------------------------------------------
    def step(self) -> List[Tuple[Request, np.ndarray]]:
        """Advance every shard's slot table; shards step one after another
        and independently, finished requests concatenate in shard order."""
        self._stepped = True
        finished: List[Tuple[Request, np.ndarray]] = []
        for sh in self._shards:
            finished.extend(sh.step())
        return finished

    # -- batch-level API: replicated params, any shard answers ------------
    def generate(self, *a, **kw):
        return self._shards[0].generate(*a, **kw)

    def generate_spec(self, *a, **kw):
        return self._shards[0].generate_spec(*a, **kw)

    def encode(self, *a, **kw):
        return self._shards[0].encode(*a, **kw)

    def prefill(self, *a, **kw):
        return self._shards[0].prefill(*a, **kw)

    def decode_chunk(self, *a, **kw):
        return self._shards[0].decode_chunk(*a, **kw)

    # -- stats ------------------------------------------------------------
    @property
    def stats(self) -> Dict[str, Any]:
        """Merged per-shard counters (a fresh dict per access): ints sum,
        dicts merge-sum, lists concatenate in shard order.
        ``mid_stream_refills`` takes the router's global count (any slot
        active fleet-wide) when it exceeds the per-shard sum."""
        out = _merge_stats([sh.stats for sh in self._shards])
        out["mid_stream_refills"] = max(
            out.get("mid_stream_refills", 0), self._refills)
        return out

    def _per_shard(self) -> List[Dict[str, Any]]:
        """Pages free/used, slots active, queue depth and requests routed,
        per data shard."""
        out = []
        for i, sh in enumerate(self._shards):
            row: Dict[str, Any] = {
                "shard": i,
                "slots": sh.cfg.slots,
                "slot_offset": self._offsets[i],
                "slots_active": sh.active_count(),
                "routed": self._routed[i],
                "queue_depth": sh.queue_depth(),
            }
            if self.cache_impl == "paged":
                row["pages_used"] = sh._pool.pages_in_use
                row["pages_free"] = sh._pool.free_pages
            out.append(row)
        return out

    def kv_stats(self) -> Dict[str, Any]:
        """Shard 0's shape/geometry fields, summed totals and the per-shard
        breakdown.  ``kv_bytes_per_slot`` aggregates slot-weighted so the
        number means what it means on one core."""
        per = [sh.kv_stats() for sh in self._shards]
        out = dict(per[0])
        for key in ("kv_bytes_total", "kv_scale_bytes", "prefill_tokens",
                    "pages_in_use", "n_pages", "kv_bytes_total_device"):
            if key in out:
                out[key] = sum(p[key] for p in per)
        slots = [sh.cfg.slots for sh in self._shards]
        for key in ("kv_bytes_per_slot", "kv_bytes_per_slot_device"):
            if key in out:
                out[key] = int(sum(p[key] * n for p, n in zip(per, slots))
                               // sum(slots))
        hits = sum(sh.stats["prefix_hits"] for sh in self._shards)
        adm = hits + sum(sh.stats["prefix_misses"] for sh in self._shards)
        out["prefix_hit_rate"] = hits / adm if adm else 0.0
        out["mesh"] = {a: int(self.mesh.shape[a])
                       for a in self.mesh.axis_names}
        out["per_shard"] = self._per_shard()
        return out

    def scheduler_stats(self) -> Dict[str, Any]:
        """Summed scheduler counters, recomputed rates and the per-shard
        breakdown."""
        per = [sh.scheduler_stats() for sh in self._shards]
        out = dict(per[0])
        for key in ("steps", "fused_steps", "decode_tokens",
                    "prompt_tokens", "chunk_tokens", "scheduled_tokens",
                    "stall_steps", "steady_recompiles"):
            if key in out:
                out[key] = sum(p.get(key, 0) for p in per)
        steps = max(out.get("steps", 0), 1)
        out["tokens_per_step"] = {
            k: out.get(f"{k}_tokens", 0) / steps
            for k in ("decode", "prompt", "chunk")}
        # shards have different token budgets: utilisation weights each
        # shard's fused steps by its own budget
        cap = sum(p.get("fused_steps", 0) * (p.get("budget") or 0)
                  for p in per)
        out["budget"] = sum((p.get("budget") or 0) for p in per) or None
        out["budget_utilization"] = (
            out["scheduled_tokens"] / cap if cap else 0.0)
        if any("overload" in p for p in per):
            ols = [p["overload"] for p in per if "overload" in p]
            out["overload"] = {
                k: sum(o.get(k, 0) for o in ols)
                for k in ("queue_depth", "queue_peak", "submitted",
                          "admissions_deferred", "preemptions",
                          "rejected_total")}
            out["overload"]["per_shard"] = ols
        merged_pbk: Dict[str, int] = {}
        for p in per:
            for k, v in p.get("prefill_by_kind", {}).items():
                merged_pbk[k] = merged_pbk.get(k, 0) + v
        out["prefill_by_kind"] = merged_pbk
        out["per_shard"] = self._per_shard()
        return out

    def spec_stats(self) -> Dict[str, Any]:
        per = [sh.spec_stats() for sh in self._shards]
        if not per or not per[0]:
            return {}
        sp: Dict[str, Any] = {}
        for key in ("steps", "verify_only_steps", "slot_steps", "drafted",
                    "accepted", "committed", "emitted", "piggybacked"):
            sp[key] = sum(p.get(key, 0) for p in per)
        sp["accept_rate"] = sp["accepted"] / max(sp["drafted"], 1)
        sp["drafts_per_step"] = sp["drafted"] / max(sp["steps"], 1)
        sp["tokens_per_slot_step"] = (sp["committed"]
                                      / max(sp["slot_steps"], 1))
        sp["piggyback_frac"] = sp["piggybacked"] / max(sp["drafted"], 1)
        return sp


def _merge_stats(dicts: List[Dict[str, Any]]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for d in dicts:
        for k, v in d.items():
            if isinstance(v, dict):
                out[k] = _merge_stats([out.get(k, {}), v])
            elif isinstance(v, list):
                out.setdefault(k, [])
                out[k] = out[k] + v
            elif isinstance(v, (int, float)) and not isinstance(v, bool):
                out[k] = out.get(k, 0) + v
            else:
                out.setdefault(k, v)
    return out


def make_engine_core(tier, adapter_cfg: EO.EOAdapterConfig,
                     core_cfg: Optional[EngineCoreConfig] = None,
                     draft=None):
    """The one mesh-aware constructor: a plain ``EngineCore`` for
    ``mesh=None`` or a pure-TP mesh, a ``ShardedEngineCore`` when the data
    axis is above 1."""
    cfg = core_cfg or EngineCoreConfig()
    if cfg.mesh is not None and SH.mesh_axis_size(cfg.mesh, "data") > 1:
        return ShardedEngineCore(tier, adapter_cfg, cfg, draft=draft)
    return EngineCore(tier, adapter_cfg, cfg, draft=draft)
