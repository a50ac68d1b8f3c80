"""The port's overload control against the JAX package's.

Page-pool-aware admission, the bounded priority queue, deadline expiry and
drop-and-recompute preemption: the same scripts drive the JAX engine and
the port's on the CPU from the same proxy weights (``proxy_pair("small")``,
float32, matmul precision pinned; made by the port from a seed and handed
to JAX as arrays, which spares JAX's random-init compiles), with the same
explicit request ids.  The saturation scenario is ``chip_smoke.py``'s
``overload_saturation``, which the card's phase 3 runs too.
Outcomes, rejections with their reasons, finished order and tokens,
``scheduler_stats()["overload"]``'s counts (not its milliseconds), the
engine counters and the pages must be equal; every completed answer of an
engine with exact pools equals the uncontended dense oracle.  Deadlines
expire only through ``submit_many(..., now=...)``: the pump inside
``step`` reads the clock, so a deadline a run could reach there would make
the two engines expire different entries.
"""
import dataclasses
import importlib.util
import pathlib
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: pytest's workers share the cores, and torch's
# default of a thread a core in each worker oversubscribes them
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.spaceverse_pair import proxy_pair as jproxy_pair  # noqa: E402
from repro.core import eo_adapter as JEO  # noqa: E402
from repro.core.cascade import TierModel as JTierModel  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import EngineCore as JEngineCore  # noqa: E402
from repro.serving import EngineCoreConfig as JEngineCoreConfig  # noqa: E402
from repro.serving import InferenceEngine as JInferenceEngine  # noqa: E402
from repro.serving import OverloadConfig as JOverloadConfig  # noqa: E402
from repro.serving import PRIORITY_URGENT as JPRIORITY_URGENT  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import admission as jadm  # noqa: E402
from repro.serving import kv_pool as jkv  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.spaceverse_pair import proxy_pair  # noqa: E402
from repro_torch.core import eo_adapter as EO  # noqa: E402
from repro_torch.core.cascade import TierModel  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.serving import (ADMITTED, PRIORITY_BULK,  # noqa: E402
                                 PRIORITY_NORMAL, PRIORITY_URGENT, QUEUED,
                                 REJECTED, EngineConfig, EngineCore,
                                 EngineCoreConfig, InferenceEngine,
                                 OverloadConfig, Request)
from repro_torch.serving import admission as tadm  # noqa: E402
from repro_torch.serving import kv_pool as tkv  # noqa: E402

_SMOKE = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
_spec = importlib.util.spec_from_file_location("chip_smoke", _SMOKE)
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

ANSWER_VOCAB = 9
COUNTERS = ("prefix_hits", "prefix_misses", "prefill_tokens",
            "prefill_by_kind", "mid_stream_refills", "admitted", "finished")
PAGES = ("pages_in_use", "n_pages", "prefix_entries", "prefix_entries_in_use",
         "prefix_shared_pages")
#: a deadline no run reaches on the clock; only an explicit ``now`` past it
#: expires the request
FAR = 1e5


@pytest.fixture(scope="module")
def system():
    jsat_cfg, jgs_cfg = jproxy_pair("small")
    sat_cfg, gs_cfg = proxy_pair("small")
    jac, ac = JEO.EOAdapterConfig(), EO.EOAdapterConfig()
    sat = EO.init_adapter(sat_cfg, ac, 0, device="cpu")
    gs = EO.init_adapter(gs_cfg, ac, 1, device="cpu")

    def carry(tree):
        return jax.tree.map(jnp.asarray, bridge.to_numpy(tree))

    eo_cfg = synthetic.EOTaskConfig(image_size=ac.image_size, grid=ac.grid,
                                    num_classes=ac.num_classes)
    images = synthetic.make_dataset("cls", 8, seed=0, cfg=eo_cfg)["images"]
    jax_pkg = types.SimpleNamespace(
        name="jax", Request=JRequest, Core=JEngineCore,
        CoreConfig=JEngineCoreConfig, Engine=JInferenceEngine,
        EngineConfig=JEngineConfig, Overload=JOverloadConfig,
        PRIORITY_URGENT=JPRIORITY_URGENT, TRASH_PAGE=jkv.TRASH_PAGE,
        sat=JTierModel(carry(sat), jsat_cfg), gs=JTierModel(carry(gs), jgs_cfg),
        ac=jac)
    port_pkg = types.SimpleNamespace(
        name="port", Request=Request, Core=EngineCore,
        CoreConfig=EngineCoreConfig, Engine=InferenceEngine,
        EngineConfig=EngineConfig, Overload=OverloadConfig,
        PRIORITY_URGENT=PRIORITY_URGENT, TRASH_PAGE=tkv.TRASH_PAGE,
        sat=TierModel(sat, sat_cfg), gs=TierModel(gs, gs_cfg), ac=ac)
    memo = {}

    def oracle(tier, task, scene, prompt=0):
        """The port's uncontended dense oracle: the greedy answer of
        ``EngineCore.generate`` for (tier, task, scene, prompt)."""
        key = (tier, task, scene, prompt)
        if key not in memo:
            core = EngineCore(getattr(port_pkg, tier), ac,
                              EngineCoreConfig(slots=1,
                                               answer_vocab=ANSWER_VOCAB,
                                               cache_impl="dense"))
            toks, _ = core.generate(
                task, torch.from_numpy(np.asarray(images[scene])[None]),
                torch.tensor([prompt], dtype=torch.int32), ANSWER_VOCAB)
            memo[key] = toks[0].tolist()
        return memo[key]

    return {"jax": jax_pkg, "port": port_pkg, "images": images,
            "oracle": oracle}


def _core(pkg, tier="sat", *, slots=2, queue_cap=8, preempt=True,
          draft=None, **kw):
    return pkg.Core(getattr(pkg, tier), pkg.ac,
                    pkg.CoreConfig(slots=slots, answer_vocab=ANSWER_VOCAB,
                                   overload=pkg.Overload(queue_cap=queue_cap,
                                                         preempt=preempt),
                                   **kw),
                    draft=getattr(pkg, draft) if draft else None)


def _req(pkg, system, rid, task, scene, priority=PRIORITY_BULK, prompt=0,
         deadline_s=None):
    return pkg.Request(task=task, image=system["images"][scene],
                       prompt=prompt, scene_id=scene, request_id=rid,
                       priority=priority, deadline_s=deadline_s)


def _ids(rejected):
    return [(r.request_id, why) for r, why in rejected]


def _drain(core, max_steps=600):
    """Step until idle: (finished ids in order, {id: tokens}, late
    rejections)."""
    order, done, rejected = [], {}, _ids(core.take_rejected())
    for _ in range(max_steps):
        for r, t in core.step():
            order.append(r.request_id)
            done[r.request_id] = np.asarray(t).tolist()
        rejected += _ids(core.take_rejected())
        if core.active_count() == 0 and core.queue_depth() == 0:
            return order, done, rejected
    raise AssertionError("engine did not drain")


def _overload_counts(core):
    """``scheduler_stats()["overload"]`` without its milliseconds."""
    ol = dict(core.scheduler_stats()["overload"])
    ol["readmit_wait_ms"] = ol["readmit_wait_ms"]["n"]
    ol["ttft_by_priority"] = {p: v["n"]
                              for p, v in ol["ttft_by_priority"].items()}
    return ol


def _state(core):
    """The counters, overload counts and (paged) pages of a core."""
    out = {key: core.stats[key] for key in COUNTERS}
    out["overload"] = _overload_counts(core)
    out["steps"] = core.stats["sched"]["steps"]
    out["fused_steps"] = core.stats["sched"]["fused_steps"]
    if core.cache_impl == "paged":
        kv = core.kv_stats()
        out.update({key: kv[key] for key in PAGES})
    return out


def _assert_drained_pool(core):
    st = core._prefix.stats()
    assert st["entries_in_use"] == 0
    assert core._pool.pages_in_use == st["shared_pages"]
    for e in core._prefix._entries.values():
        assert all(core._pool.refcount(p) == 1 for p in e.pages)
    assert (core._bt_np == tkv.TRASH_PAGE).all()


def _both(system, script):
    """Run ``script(pkg)`` on both packages; (port result, JAX result)."""
    return script(system["port"]), script(system["jax"])


# ---------------------------------------------------------------------------
# the admission queue and its config
# ---------------------------------------------------------------------------

def test_admission_module_copies_the_vocabulary():
    for name in ("ADMITTED", "QUEUED", "REJECTED", "REASON_QUEUE_FULL",
                 "REASON_EXPIRED", "REASON_INFEASIBLE"):
        assert getattr(tadm, name) == getattr(jadm, name), name
    assert (PRIORITY_BULK, PRIORITY_NORMAL, PRIORITY_URGENT) == (0, 1, 2)
    for mod in (tadm, jadm):
        with pytest.raises(ValueError):
            mod.OverloadConfig(queue_cap=0)
        with pytest.raises(ValueError):
            mod.AdmissionQueue(0)
        with pytest.raises(dataclasses.FrozenInstanceError):
            mod.OverloadConfig().queue_cap = 3
    assert OverloadConfig() == OverloadConfig(queue_cap=64, preempt=True)


def test_admission_queue_matches_jax_hypothesis():
    """Random push / pop / peek / expire sequences on both packages'
    queues: the same rejected entries, pops, expiries, order and
    ``depth_peak`` after every operation."""
    hyp = pytest.importorskip("hypothesis")
    st = pytest.importorskip("hypothesis.strategies")

    op = st.one_of(
        st.tuples(st.just("push"), st.integers(0, 2),
                  st.sampled_from([None, 0.5, 2.0, 5.0]),
                  st.integers(0, 6)),
        st.tuples(st.just("pop")), st.tuples(st.just("peek")),
        st.tuples(st.just("expire"), st.integers(0, 12)))

    @hyp.given(st.integers(1, 5), st.lists(op, max_size=60))
    @hyp.settings(deadline=None, max_examples=80)
    def run(cap, ops):
        queues = [(mod, mod.AdmissionQueue(cap)) for mod in (tadm, jadm)]
        req_cls = {tadm: Request, jadm: JRequest}
        img = np.zeros((8, 8, 3), np.float32)
        for seq, o in enumerate(ops):
            seen = []
            for mod, q in queues:
                if o[0] == "push":
                    _, prio, deadline, t = o
                    e = mod.QueueEntry(
                        request=req_cls[mod](task="cls", image=img, prompt=0,
                                             request_id=seq, priority=prio,
                                             deadline_s=deadline),
                        seq=seq, t_submit=float(t))
                    got = q.push(e)
                    got = None if got is None else (got.request.request_id,
                                                    got is e)
                elif o[0] == "pop":
                    got = q.pop().request.request_id if len(q) else None
                elif o[0] == "peek":
                    e = q.peek()
                    got = None if e is None else e.request.request_id
                else:
                    got = [e.request.request_id
                           for e in q.expire(float(o[1]))]
                seen.append((got, [e.request.request_id for e in q],
                             [e.sort_key for e in q], q.depth_peak, len(q)))
            assert seen[0] == seen[1], o
            assert len(queues[0][1]) <= cap

    run()


def test_submit_many_requires_overload_config(system):
    for pkg in (system["port"], system["jax"]):
        core = pkg.Core(pkg.sat, pkg.ac,
                        pkg.CoreConfig(slots=2, answer_vocab=ANSWER_VOCAB))
        with pytest.raises(ValueError, match="overload"):
            core.submit_many([_req(pkg, system, 0, "cls", 0)])
        assert core.queue_depth() == 0 and core.take_rejected() == []


# ---------------------------------------------------------------------------
# the pool's overload state machine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_dtype", [None, "int8", "fp8"])
def test_overload_state_machine_hypothesis(kv_dtype):
    """Randomised admit / preempt / re-admit / reject / finish interleavings
    over the port's pool and prefix cache under the overload layer's
    check-then-commit discipline (an admission runs only when the headroom
    probe ``free + evictable_pages(protect)`` says it fits; a rejection
    touches nothing; preemption frees the private pages, releases the
    prefix and parks the scene), run in lockstep with the JAX package's
    pool and cache.  After every action: pages_in_use == private + shared,
    per-scene users match the model, shared pages hold 1 + users
    references, the trash page is never handed out, and both packages hold
    the same pages and entries.  The pool is sized from one byte budget
    through the port's ``page_nbytes`` (equal to JAX's): an 8-bit pool
    runs the same machine on the ~3.5x pages the same bytes buy."""
    hyp = pytest.importorskip("hypothesis")
    st = pytest.importorskip("hypothesis.strategies")
    PRIV, SHARED, SLOTS, CAP = 2, 3, 3, 3
    budget = 17 * tkv.page_nbytes(4, 2, 32)         # 17 f32 pages' worth
    per_page = tkv.page_nbytes(4, 2, 32, kv_dtype=kv_dtype)
    assert per_page == jkv.page_nbytes(4, 2, 32, kv_dtype=kv_dtype)
    n_pages = budget // per_page
    assert n_pages == 17 if kv_dtype is None else n_pages >= 2 * 17

    @hyp.given(st.lists(st.tuples(
        st.sampled_from(["admit", "preempt", "readmit", "finish"]),
        st.integers(0, 11)), max_size=80))
    @hyp.settings(deadline=None, max_examples=60)
    def run(ops):
        sides = []
        for mod in (tkv, jkv):
            pool = mod.KVPagePool(n_pages=n_pages, page_size=4)
            sides.append((pool, mod.PrefixCache(pool, capacity=CAP)))
        active = []                     # (scene, [private pages by side])
        parked = []                     # queued / preempted scenes

        def fits(pool, cache, scene):
            if len(active) >= SLOTS:
                return False
            protect = {s for s, _ in active} | {scene}
            new = 0 if scene in cache else 1
            if pool.free_pages + cache.evictable_pages(protect) \
                    < PRIV + new * SHARED:
                return False
            resident = len(cache) - cache.evictable_entries(protect)
            return resident + new <= cache.capacity

        def admit(scene):
            """The commit phase: by construction of ``fits`` it cannot
            raise (admission atomicity at the allocator layer)."""
            ok = [fits(pool, cache, scene) for pool, cache in sides]
            assert ok[0] == ok[1]
            if not ok[0]:
                return False
            protect = {s for s, _ in active} | {scene}
            priv = []
            for pool, cache in sides:
                new = 0 if scene in cache else 1
                cache.evict_for(PRIV + new * SHARED, need_entries=new,
                                protect=protect)
                if scene not in cache:
                    cache.put(scene, pool.alloc(SHARED), None)
                cache.acquire(scene)
                priv.append(pool.alloc(PRIV))
            active.append((scene, priv))
            return True

        def free(scene, priv):
            for (pool, cache), pages in zip(sides, priv):
                pool.free(pages)
                cache.release(scene)

        for op, arg in ops:
            if op == "admit":
                scene = f"s{arg % 5}"
                if not admit(scene):            # rejection: a pure no-op
                    parked.append(scene)
            elif op == "preempt" and active:
                s_, priv = active.pop(arg % len(active))
                free(s_, priv)
                parked.append(s_)
            elif op == "readmit" and parked:
                s_ = parked.pop(arg % len(parked))
                if not admit(s_):
                    parked.append(s_)
            elif op == "finish" and active:
                s_, priv = active.pop(arg % len(active))
                free(s_, priv)
            users = {}
            for s_, _ in active:
                users[s_] = users.get(s_, 0) + 1
            for side, (pool, cache) in enumerate(sides):
                priv = sum(len(p[side]) for _, p in active)
                shared = cache.stats()["shared_pages"]
                assert pool.pages_in_use == priv + shared
                assert {s_: e.users for s_, e in cache._entries.items()
                        if e.users} == users
                for s_, e in cache._entries.items():
                    for p in e.pages:
                        assert p != tkv.TRASH_PAGE
                        assert pool.refcount(p) == 1 + e.users
            (tp, tc), (jp, jc) = sides
            assert (tp.free_pages, tp.pages_in_use) == (jp.free_pages,
                                                        jp.pages_in_use)
            assert tc.stats() == jc.stats()
            assert list(tc._entries) == list(jc._entries)
        # drain: the pool returns to the cache-only state
        for s_, priv in active:
            free(s_, priv)
        for pool, cache in sides:
            assert pool.pages_in_use == cache.stats()["shared_pages"]
            assert cache.stats()["entries_in_use"] == 0

    run()


# ---------------------------------------------------------------------------
# the ports of the JAX package's engine tests, run on both packages
# ---------------------------------------------------------------------------

def test_bounded_queue_rejects_overflow_with_reason(system):
    """Sustained submission past capacity: the slots fill, the queue
    fills, and the overflow gets an explicit ``rejected`` outcome."""
    def script(pkg):
        core = _core(pkg, slots=2, queue_cap=2)
        reqs = [_req(pkg, system, 10 + i, "det", i) for i in range(6)]
        out = core.submit_many(reqs)
        first = ([out[r.request_id] for r in reqs], core.queue_depth(),
                 _ids(core.take_rejected()))
        order, done, late = _drain(core)
        _assert_drained_pool(core)
        return first, order, done, late, _state(core)

    got, want = _both(system, script)
    assert got == want
    (outcomes, depth, rejected), _, done, late, state = got
    assert outcomes == [ADMITTED, ADMITTED, QUEUED, QUEUED, REJECTED,
                        REJECTED]
    assert depth == 2 and late == []
    assert rejected == [(14, "queue_full"), (15, "queue_full")]
    assert sorted(done) == [10, 11, 12, 13]
    assert state["overload"]["rejections"]["queue_full"] == 2
    assert state["overload"]["admissions_deferred"] == 2


def test_urgent_displaces_queued_bulk_when_full(system):
    def script(pkg):
        core = _core(pkg, slots=1, queue_cap=1)
        bulk = [_req(pkg, system, 20 + i, "det", i) for i in range(2)]
        urgent = _req(pkg, system, 22, "vqa", 2, PRIORITY_URGENT)
        out = core.submit_many(bulk)
        out2 = core.submit_many([urgent])
        rejected = _ids(core.take_rejected())
        order, done, late = _drain(core)
        return ([out[r.request_id] for r in bulk], out2[22], rejected,
                order, done, late, _state(core))

    got, want = _both(system, script)
    assert got == want
    bulk_out, urgent_out, rejected, _, done, _, _ = got
    assert bulk_out == [ADMITTED, QUEUED]
    assert (21, "queue_full") in rejected
    assert urgent_out in (ADMITTED, QUEUED) and 22 in done


def test_page_pressure_defers_instead_of_memoryerror(system):
    """A pool sized for one slot's worst case: the second distinct-scene
    request parks (a slot free, no pages) and completes after the first
    drains; the unconditional path raises ``MemoryError`` on the same
    sizing."""
    def script(pkg):
        probe = _core(pkg, slots=2)
        floor = 1 + probe._pages_per_slot
        core = _core(pkg, slots=2, queue_cap=4, pool_pages=floor)
        reqs = [_req(pkg, system, 30 + i, "cls", i) for i in range(2)]
        out = core.submit_many(reqs)
        active = core.active_count()
        order, done, rejected = _drain(core)
        _assert_drained_pool(core)
        legacy = pkg.Core(pkg.sat, pkg.ac,
                          pkg.CoreConfig(slots=2, answer_vocab=ANSWER_VOCAB,
                                         pool_pages=floor))
        with pytest.raises(MemoryError):
            legacy.admit_many([_req(pkg, system, 40 + i, "cls", 2 + i)
                               for i in range(2)])
        return ([out[r.request_id] for r in reqs], active, order, done,
                rejected, _state(core), floor)

    got, want = _both(system, script)
    assert got == want
    outcomes, active, _, done, rejected, state, _ = got
    assert outcomes == [ADMITTED, QUEUED] and active == 1
    assert sorted(done) == [30, 31] and rejected == []
    assert state["overload"]["admissions_deferred"] >= 1


def test_urgent_preempts_bulk_and_all_tokens_match_oracle(system):
    """A saturated engine preempts bulk work for an urgent arrival, the
    victim re-admits later, and every completed request, the
    preempted-then-resumed one included, equals the uncontended dense
    oracle token for token."""
    def script(pkg):
        core = _core(pkg, slots=2, queue_cap=8)
        bulk = [_req(pkg, system, 50 + i, "det", i) for i in range(3)]
        out = core.submit_many(bulk)
        for _ in range(2):
            core.step()
        urgent = _req(pkg, system, 53, "vqa", 5, PRIORITY_URGENT)
        out2 = core.submit_many([urgent])
        preempts = core.scheduler_stats()["overload"]["preemptions"]
        order, done, rejected = _drain(core)
        _assert_drained_pool(core)
        return ([out[r.request_id] for r in bulk], out2[53], preempts,
                order, done, rejected, _state(core))

    got, want = _both(system, script)
    assert got == want
    outcomes, urgent_out, preempts, _, done, rejected, state = got
    assert outcomes == [ADMITTED, ADMITTED, QUEUED]
    assert urgent_out == ADMITTED and preempts >= 1 and rejected == []
    assert sorted(done) == [50, 51, 52, 53]
    for rid, task, scene in [(50, "det", 0), (51, "det", 1), (52, "det", 2),
                             (53, "vqa", 5)]:
        assert done[rid] == system["oracle"]("sat", task, scene), rid
    ol = state["overload"]
    assert ol["readmit_wait_ms"] >= 1
    assert set(ol["ttft_by_priority"]) == {PRIORITY_BULK, PRIORITY_URGENT}


def test_no_preemption_when_disabled(system):
    def script(pkg):
        core = _core(pkg, slots=1, queue_cap=4, preempt=False)
        bulk = _req(pkg, system, 60, "det", 0)
        urgent = _req(pkg, system, 61, "vqa", 1, PRIORITY_URGENT)
        outs = (core.submit_many([bulk])[60], core.submit_many([urgent])[61])
        order, done, _ = _drain(core)
        return outs, order, done, _state(core)

    got, want = _both(system, script)
    assert got == want
    outs, order, _, state = got
    assert outs == (ADMITTED, QUEUED) and order == [60, 61]
    assert state["overload"]["preemptions"] == 0


def test_deadline_expires_queued_request_only(system):
    """A stale queued request expires at pump time with an explicit
    rejection; an admitted request always runs to completion."""
    def script(pkg):
        core = _core(pkg, slots=1, queue_cap=4)
        running = _req(pkg, system, 70, "det", 0, deadline_s=0.001)
        stale = _req(pkg, system, 71, "cls", 1, deadline_s=0.5)
        fresh = _req(pkg, system, 72, "cls", 2)
        out = core.submit_many([running, stale], now=0.0)
        out2 = core.submit_many([fresh], now=10.0)
        rejected = _ids(core.take_rejected())
        order, done, late = _drain(core)
        return ((out[70], out[71], out2[72]), rejected, order, done, late,
                _state(core))

    got, want = _both(system, script)
    assert got == want
    outs, rejected, _, done, _, state = got
    assert outs == (ADMITTED, QUEUED, QUEUED)
    assert rejected == [(71, "expired")]
    assert sorted(done) == [70, 72]
    assert state["overload"]["rejections"]["expired"] == 1


def test_infeasible_request_is_rejected_on_an_idle_engine(system):
    """Pages held outside the engine leave an idle pool one page short of a
    request's worst case: it can never be admitted, so the pump rejects it
    as ``"infeasible"`` instead of parking it at the head for good; once
    the pages come back the same request admits."""
    def script(pkg):
        core = _core(pkg, slots=2, queue_cap=4)
        need = core.page_demand(_req(pkg, system, 80, "cls", 0))
        held = core._pool.alloc(core._pool.free_pages - need + 1)
        out = core.submit_many([_req(pkg, system, 80, "cls", 0)])
        rejected = _ids(core.take_rejected())
        core._pool.free(held)
        out2 = core.submit_many([_req(pkg, system, 81, "cls", 0)])
        order, done, _ = _drain(core)
        _assert_drained_pool(core)
        return need, out[80], rejected, out2[81], done, _state(core)

    got, want = _both(system, script)
    assert got == want
    need, out, rejected, out2, done, state = got
    p = system["port"]
    probe = _core(p, slots=2)
    assert need == probe._private_per_slot + probe._n_shared_pages
    assert out == REJECTED and rejected == [(80, "infeasible")]
    assert out2 == ADMITTED and list(done) == [81]
    assert state["overload"]["rejections"]["infeasible"] == 1


def test_engine_serve_overload_matches_dense_oracle(system):
    """``InferenceEngine.serve`` under overload control (priorities mixed,
    a queue deep enough that nothing is rejected) gives the dense engine's
    tokens, and the JAX engine's finished order and counters."""
    def stream(pkg):
        reqs = []
        for s in range(3):
            prio = PRIORITY_URGENT if s == 1 else PRIORITY_BULK
            reqs.append(_req(pkg, system, 90 + 2 * s, "det", s, prio))
            reqs.append(_req(pkg, system, 91 + 2 * s, "vqa", s, prio,
                             prompt=s % 2))
        return reqs

    def script(pkg):
        eng = pkg.Engine(pkg.sat.params, pkg.sat.cfg, pkg.ac,
                         pkg.EngineConfig(slots=2, answer_vocab=ANSWER_VOCAB,
                                          overload=pkg.Overload(
                                              queue_cap=16)),
                         **({"device": "cpu"} if pkg.name == "port" else {}))
        out = eng.serve(stream(pkg))
        _assert_drained_pool(eng.core)
        return ([r.request_id for r in out],
                {r.request_id: np.asarray(r.tokens).tolist() for r in out},
                eng.last_rejected, _state(eng.core))

    got, want = _both(system, script)
    assert got == want
    _, by_id, rejected, state = got
    assert rejected == []
    assert state["overload"]["submitted"] == 6
    assert state["overload"]["rejected_total"] == 0
    dense = InferenceEngine(system["port"].sat.params, system["port"].sat.cfg,
                            system["port"].ac,
                            EngineConfig(slots=2, answer_vocab=ANSWER_VOCAB,
                                         cache_impl="dense"), device="cpu")
    want_d = {r.request_id: np.asarray(r.tokens).tolist()
              for r in dense.serve(stream(system["port"]))}
    assert by_id == want_d


# ---------------------------------------------------------------------------
# the scripted saturation scenario on every slot-path flavour
# ---------------------------------------------------------------------------

FLAVOURS = {"paged": {}, "dense": {"cache_impl": "dense"},
            "chunk4": {"prefill_chunk": 4}, "spec2": {"spec_gamma": 2},
            "int8": {"kv_dtype": "int8"}, "fp8": {"kv_dtype": "fp8"}}


@pytest.mark.parametrize("flavour", list(FLAVOURS))
def test_saturation_scenario_matches_jax(system, flavour):
    """``chip_smoke.overload_saturation`` on both packages (the γ 2 engine
    drafted by the satellite tier): 4 bulk det, then 2 urgent vqa, a bulk
    vqa that expires in the queue and a burst of 5 bulk cls, on 4 slots
    with a queue of 4 and a pool of 1 + 3P + 3S pages."""
    kw = FLAVOURS[flavour]
    got = chip_smoke.overload_saturation(system["port"], system["images"], kw,
                                         ANSWER_VOCAB)
    want = chip_smoke.overload_saturation(system["jax"], system["images"], kw,
                                          ANSWER_VOCAB)
    assert got == want
    assert got["drained"]
    ol = got["state"]["overload"]
    # every submitted request answered or rejected once, none both
    rejected = [rid for batch in got["rejected"] for rid, _ in batch]
    assert len(rejected) == len(set(rejected))
    assert not set(rejected) & set(got["tokens"])
    assert sorted(rejected + list(got["tokens"])) == sorted(got["asked"])
    assert sorted(got["asked"]) == sorted(
        rid for call in got["calls"][:4] for rid in call)
    assert ol["submitted"] == 12 and ol["queue_depth"] == 0
    assert ol["rejected_total"] == len(rejected)
    assert ol["preemptions"] == len(got["preempted"]) >= 1
    assert ol["rejections"]["queue_full"] >= 1
    assert (120, "expired") in got["rejected"][1]
    # a preempted answer re-emits the tokens it had committed
    for rid, toks in got["preempted"]:
        assert got["tokens"][rid][:len(toks)] == toks, rid
    if flavour in ("int8", "fp8"):
        return
    for rid, toks in got["tokens"].items():
        task, scene, prompt = got["asked"][rid]
        assert toks == system["oracle"]("gs", task, scene, prompt), rid
