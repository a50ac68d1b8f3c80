"""The port's sharded serving against the JAX package's.

The reference's bar (``tests/test_sharded_serving.py``): every engine
flavour (plain paged decode, speculative γ 2, chunked prefill 4, int8
pages) at every mesh shape dp×tp ∈ {1×2, 2×1, 2×2} emits the tokens of the
single-device engine, token for token; here the single-device engine is the
JAX package's.  The port runs its model axis SPMD: a tp-2 mesh is two rank
processes (``launch.mesh.spawn_tp``, ``gloo`` on the CPU), and both ranks'
streams must be equal as well.  One world runs every tp-2 case of the
module; each JAX reference engine is built once.  The data-parallel router
(routes, per-shard rows, merged stats, overload outcomes) is held to the
JAX ``ShardedEngineCore`` on a (2, 1) mesh of the test process's virtual CPU
devices.  Weights are made by the port from a seed and handed to JAX as
arrays; float32, matmul precision pinned.

The rank function ``_tp_rank`` runs in spawned processes that import this
module: its top level imports only the port (JAX stays inside fixtures).
"""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.spaceverse_pair import proxy_pair  # noqa: E402
from repro_torch.core import eo_adapter as EO  # noqa: E402
from repro_torch.core.cascade import TierModel  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.distributed import collectives as CO  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.serving import (PRIORITY_URGENT, EngineConfig,  # noqa: E402
                                 EngineCore, EngineCoreConfig,
                                 InferenceEngine, OverloadConfig, Request,
                                 ShardedEngineCore, make_engine_core)
from repro_torch.serving import sharded as port_sharded  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

ANSWER_VOCAB = 9
FLAVOURS = {
    "plain": {},
    "spec": {"spec_gamma": 2},
    "chunked": {"prefill_chunk": 4},
    "int8": {"kv_dtype": "int8"},
}
SHAPES = [(1, 2), (2, 1), (2, 2)]
#: kv_stats fields that are global (the logical pool) on every shape
KV_GLOBAL = ("kv_bytes_total", "kv_scale_bytes", "page_bytes", "n_pages",
             "pages_in_use", "prefix_hit_rate", "prefill_tokens",
             "kv_bytes_per_slot")
#: a deadline no run reaches on the clock; only an explicit ``now`` past it
#: expires the request
FAR = 1e5


def _port_system():
    """The proxy tier (seed 0), its draft (seed 1), the adapter config and
    the request stream of the JAX test: a det and five vqa over six
    scenes."""
    cfg, _ = proxy_pair("small")
    ac = EO.EOAdapterConfig()
    tier = TierModel(EO.init_adapter(cfg, ac, 0, device="cpu"), cfg)
    draft = TierModel(EO.init_adapter(cfg, ac, 1, device="cpu"), cfg)
    eo_cfg = synthetic.EOTaskConfig(image_size=ac.image_size, grid=ac.grid,
                                    num_classes=ac.num_classes)
    data = synthetic.make_dataset("cls", 16, seed=0, cfg=eo_cfg)
    stream = [("det", data["images"][0], 0)]
    stream += [("vqa", data["images"][i], int(data["prompts"][i]) % 2)
               for i in range(1, 6)]
    return {"tier": tier, "draft": draft, "ac": ac, "stream": stream,
            "images": data["images"], "make": make_engine_core,
            "Config": EngineCoreConfig, "Request": Request}


def _requests(cls, stream):
    return [cls(task=t, image=im, prompt=p) for t, im, p in stream]


def _build(pkg, mesh, flavour):
    """``make_engine_core`` of ``pkg`` (the port's or JAX's names) on 4
    slots of the flavour's engine."""
    fl = FLAVOURS[flavour]
    return pkg["make"](pkg["tier"], pkg["ac"], pkg["Config"](
        slots=4, answer_vocab=ANSWER_VOCAB, mesh=mesh, **fl),
        draft=pkg["draft"] if fl.get("spec_gamma") else None)


def _drive(core, reqs):
    """Admit as slots free, step until idle: the tokens in request
    order."""
    core.warmup()
    outs, queue = {}, list(reqs)
    while queue or core.active_count():
        k = min(len(queue), len(core.free_slots()))
        if k:
            core.admit_many(queue[:k])
            queue = queue[k:]
        for req, toks in core.step():
            outs[req.request_id] = np.asarray(toks).tolist()
    return [outs[r.request_id] for r in reqs]


# ---------------------------------------------------------------------------
# the tp-2 world (runs in the rank processes)
# ---------------------------------------------------------------------------

class _ContextCounter:
    """Counts the step bodies run inside a ``tp_context`` (one model call
    of the engine's tier each)."""

    def __init__(self):
        self.entries = 0
        self.orig = CO.tp_context

    def __enter__(self):
        def counted(*a, **kw):
            self.entries += 1
            return self.orig(*a, **kw)
        CO.tp_context = counted
        return self

    def __exit__(self, *exc):
        CO.tp_context = self.orig


def _skewed_overload(sys_, mesh, rank):
    """An overload run whose deadline decision reads the clock: 2 slots,
    2 det, then a vqa with a 0.75 s deadline that waits for a slot.  Rank
    1's clock jumps a second ahead once the vqa is queued; every decision
    must still be rank 0's."""
    core = EngineCore(sys_["tier"], sys_["ac"], EngineCoreConfig(
        slots=2, answer_vocab=ANSWER_VOCAB, mesh=mesh,
        overload=OverloadConfig(queue_cap=4)))
    images = sys_["images"]
    det = [Request(task="det", image=images[i], prompt=0, request_id=500 + i)
           for i in range(2)]
    late = Request(task="vqa", image=images[3], prompt=1, request_id=510,
                   deadline_s=0.75)
    real, skew = time.perf_counter, [0.0]
    if rank == 1:
        time.perf_counter = lambda: real() + skew[0]
    try:
        calls = [core.submit_many(det), core.submit_many([late])]
        skew[0] = 1.0
        finished, rejected = [], []
        while core.active_count() or core.queue_depth():
            for r, t in core.step():
                finished.append((r.request_id, np.asarray(t).tolist()))
            rejected += [(r.request_id, why)
                         for r, why in core.take_rejected()]
    finally:
        time.perf_counter = real
    return {"calls": calls, "finished": finished, "rejected": rejected}


def _tp_rank(rank, shapes):
    """One rank of the tp-2 world: every flavour at every (dp, 2) shape in
    ``shapes``, then the skewed-clock overload run."""
    torch.set_float32_matmul_precision("highest")
    sys_ = _port_system()
    layers = sys_["tier"].cfg.num_layers
    out = {"rank": rank, "runs": {}}
    for dp, flavour in shapes:
        mesh = M.make_host_mesh(model=2, data=dp, devices=["cpu"] * 2 * dp)
        core = _build(sys_, mesh, flavour)
        CO.reset_all_reduce_counts()
        with _ContextCounter() as ctx:
            toks = _drive(core, _requests(Request, sys_["stream"]))
        shards = core.shards if dp > 1 else [core]
        ks = core.kv_stats()
        out["runs"][(dp, flavour)] = {
            "core": type(core).__name__,
            "tokens": toks, "all_reduces": CO.all_reduce_counts(),
            "model_calls": ctx.entries, "layers": layers,
            "pool_kv_heads": sorted({leaf.shape[3] for sh in shards
                                     for layer in sh._slot_cache
                                     for name, leaf in layer.items()
                                     if name in ("k", "v")}),
            "kv": {k: ks[k] for k in KV_GLOBAL + (
                "kv_bytes_per_slot_device", "kv_bytes_total_device", "mesh")
                if k in ks},
            "tp_kv_shards": [sh.kv_stats()["tp_kv_shards"]
                             for sh in shards]}
    out["skewed_overload"] = _skewed_overload(
        sys_, M.make_host_mesh(model=2, data=1, devices=["cpu"] * 2), rank)
    return out


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def system():
    sys_ = _port_system()
    import jax
    import jax.numpy as jnp
    from repro.configs.spaceverse_pair import proxy_pair as jproxy_pair
    from repro.core import eo_adapter as JEO
    from repro.core.cascade import TierModel as JTierModel
    from repro.launch.mesh import make_host_mesh as jmake_host_mesh
    from repro.serving import EngineCoreConfig as JEngineCoreConfig
    from repro.serving import Request as JRequest
    from repro.serving import sharded as jsharded

    def carry(tree):
        return jax.tree.map(jnp.asarray, bridge.to_numpy(tree))

    jcfg, _ = jproxy_pair("small")
    sys_["jax"] = {"tier": JTierModel(carry(sys_["tier"].params), jcfg),
                   "draft": JTierModel(carry(sys_["draft"].params), jcfg),
                   "ac": JEO.EOAdapterConfig(), "Request": JRequest,
                   "Config": JEngineCoreConfig,
                   "make": jsharded.make_engine_core,
                   "sharded": jsharded, "make_mesh": jmake_host_mesh}
    return sys_


@pytest.fixture(scope="module")
def jax_reference(system):
    """The JAX single-device engine per flavour, built once each: tokens
    in request order and its kv_stats."""
    j, memo = system["jax"], {}

    def get(flavour):
        if flavour not in memo:
            core = _build(j, None, flavour)
            toks = _drive(core, _requests(j["Request"], system["stream"]))
            memo[flavour] = (toks, core.kv_stats())
        return memo[flavour]
    return get


@pytest.fixture(scope="module")
def tp_world():
    """Both ranks' results of the one tp-2 world of the module."""
    t0 = time.perf_counter()
    ranks = M.spawn_tp(_tp_rank, 2, [(dp, f) for dp in (1, 2)
                                     for f in FLAVOURS],
                       backend="gloo", timeout_s=120)
    return {"ranks": ranks, "seconds": time.perf_counter() - t0}


@pytest.fixture(scope="module")
def dp2_runs(system):
    """The port's (2, 1) engines per flavour, built once each."""
    memo = {}

    def get(flavour):
        if flavour not in memo:
            mesh = M.make_host_mesh(model=1, data=2, devices=["cpu"] * 2)
            core = _build(system, mesh, flavour)
            memo[flavour] = (core, _drive(core, _requests(
                Request, system["stream"])))
        return memo[flavour]
    return get


# ---------------------------------------------------------------------------
# token parity, every flavour at every shape
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flavour", sorted(FLAVOURS))
@pytest.mark.parametrize("dp,tp", SHAPES,
                         ids=[f"dp{d}tp{t}" for d, t in SHAPES])
def test_sharded_matches_single_device(system, jax_reference, tp_world,
                                       dp2_runs, flavour, dp, tp):
    want, jkv = jax_reference(flavour)
    if tp == 1:
        core, got = dp2_runs(flavour)
        assert isinstance(core, ShardedEngineCore)
        assert got == want
        per = core.kv_stats()["per_shard"]
        assert len(per) == dp and sum(r["slots"] for r in per) == 4
        assert sum(r["routed"] for r in per) == len(system["stream"])
        assert core.scheduler_stats()["per_shard"] == per
        return
    r0, r1 = (r["runs"][(dp, flavour)] for r in tp_world["ranks"])
    # make_engine_core: a pure-TP mesh is EngineCore's, data > 1 not
    assert r0["core"] == ("ShardedEngineCore" if dp > 1 else "EngineCore")
    assert r0["tokens"] == want
    assert r1["tokens"] == r0["tokens"]
    for r in (r0, r1):
        # each rank's pools hold its KV-head block; two all-reduces a layer
        # per model call; per-device bytes are the global ones over tp
        assert r["pool_kv_heads"] == [system["tier"].cfg.num_kv_heads // tp]
        assert r["model_calls"] > 0
        assert r["all_reduces"] == {"attn": r["layers"] * r["model_calls"],
                                    "mlp": r["layers"] * r["model_calls"]}
        assert r["tp_kv_shards"] == [tp] * dp
        assert r["kv"]["kv_bytes_per_slot_device"] * tp \
            == r["kv"]["kv_bytes_per_slot"]
        assert r["kv"]["mesh"] == {"data": dp, "model": tp}
    if dp == 1:
        # the global accounting is the single-device engine's
        assert {k: r0["kv"][k] for k in KV_GLOBAL} \
            == {k: jkv[k] for k in KV_GLOBAL}
        assert r0["kv"]["kv_bytes_total_device"] * tp \
            == jkv["kv_bytes_total"]


def test_tp_world_ranks_agree_under_a_skewed_clock(tp_world):
    """Rank 1's clock jumps a second ahead: without rank 0's clock on both
    ranks the deadline would expire on rank 1 alone and the ranks would
    call different collectives."""
    a, b = (r["skewed_overload"] for r in tp_world["ranks"])
    assert a == b
    assert len(a["finished"]) + len(a["rejected"]) == 3
    assert tp_world["seconds"] < 120


# ---------------------------------------------------------------------------
# the plan and the shard rules
# ---------------------------------------------------------------------------

def _plan_configs():
    sat, gs = proxy_pair("small")
    return {"proxy-sat": sat, "proxy-gs": gs,
            "qwen2-vl-2b": get_config("qwen2-vl-2b"),
            "qwen2-vl-7b": get_config("qwen2-vl-7b"),
            "xlstm-125m": get_config("xlstm-125m")}


def _jax_config(name):
    from repro.configs import get_config as jget_config
    from repro.configs.spaceverse_pair import proxy_pair as jproxy_pair
    if name.startswith("proxy"):
        sat, gs = jproxy_pair("small")
        return sat if name == "proxy-sat" else gs
    return jget_config(name)


def _grid(dp, tp):
    return M.Mesh(np.full((dp, tp), torch.device("cpu"), dtype=object))


@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("name", sorted(_plan_configs()))
def test_tp_serving_plan_matches_jax(name, tp):
    from repro.distributed import sharding as JSH
    from repro.launch.mesh import make_host_mesh as jmake_host_mesh
    plan = SH.tp_serving_plan(_plan_configs()[name], _grid(1, tp))
    want = JSH.tp_serving_plan(_jax_config(name),
                               jmake_host_mesh(model=tp, data=1))
    assert (plan.tp, plan.attn, plan.mlp) == (want.tp, want.attn, want.mlp)
    for field in ("num_heads", "num_kv_heads", "d_ff", "resolved_head_dim",
                  "head_dim"):
        assert getattr(plan.cfg_local, field) \
            == getattr(want.cfg_local, field), field


@pytest.mark.parametrize("rank", [0, 1])
def test_shard_backbone_matches_jax_device_put(system, rank):
    """Each leaf of rank ``rank``'s backbone is byte-equal to the JAX
    backbone's shard on the model axis's device ``rank``."""
    import jax
    from repro.distributed import sharding as JSH
    from repro.launch.mesh import make_host_mesh as jmake_host_mesh
    jmesh = jmake_host_mesh(model=2, data=1)
    jbb = system["jax"]["tier"].params["backbone"]
    jplan = JSH.tp_serving_plan(system["jax"]["tier"].cfg, jmesh)
    put = jax.device_put(jbb, JSH.named(jmesh, JSH.serving_param_specs(
        jplan, jax.eval_shape(lambda: jbb))))
    plan = SH.tp_serving_plan(system["tier"].cfg, _grid(1, 2))
    got = SH.shard_backbone(system["tier"].params["backbone"], plan, rank)
    dev = jmesh.devices[0, rank]
    want = jax.tree.map(
        lambda x: np.asarray(next(s.data for s in x.addressable_shards
                                  if s.device == dev)), put)
    flat_got = jax.tree_util.tree_leaves(bridge.to_numpy(got))
    flat_want = jax.tree_util.tree_leaves(want)
    assert len(flat_got) == len(flat_want)
    for g, w in zip(flat_got, flat_want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert g.tobytes() == w.tobytes()
    dims = [d for d in jax.tree_util.tree_leaves(
        SH.split_dims(plan, system["tier"].params["backbone"]),
        is_leaf=lambda x: x is None) if d is not None]
    assert len(dims) == 7 * len(system["tier"].cfg.block_pattern)
    h = system["tier"].cfg.num_kv_heads // 2
    assert SH.kv_head_block(plan, rank) == slice(rank * h, (rank + 1) * h)


# ---------------------------------------------------------------------------
# the data-parallel router against JAX's ShardedEngineCore
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_dp2(system):
    j, memo = system["jax"], {}

    def get(flavour):
        if flavour not in memo:
            core = _build(j, j["make_mesh"](model=1, data=2), flavour)
            memo[flavour] = (core, _drive(core, _requests(
                j["Request"], system["stream"])))
        return memo[flavour]
    return get


def _scheduler(core):
    """``scheduler_stats()`` without what one package has alone."""
    out = dict(core.scheduler_stats())
    out.pop("steady_recompiles", None)
    return out


@pytest.mark.parametrize("flavour", sorted(FLAVOURS))
def test_dp2_router_and_stats_match_jax(jax_dp2, dp2_runs, flavour):
    jcore, jtoks = jax_dp2(flavour)
    core, toks = dp2_runs(flavour)
    assert type(jcore).__name__ == type(core).__name__ == "ShardedEngineCore"
    assert toks == jtoks
    assert core._routed == jcore._routed
    assert core.free_slots() == jcore.free_slots()
    jkv, kv = jcore.kv_stats(), core.kv_stats()
    assert kv["per_shard"] == jkv["per_shard"]
    assert kv == {k: v for k, v in jkv.items() if k in kv}
    assert set(jkv) - set(kv) == set()
    assert _scheduler(core) == _scheduler(jcore)
    assert core.spec_stats() == jcore.spec_stats()
    for key in ("admitted", "finished", "prefix_hits", "prefix_misses",
                "prefill_tokens", "prefill_by_kind", "mid_stream_refills"):
        assert core.stats[key] == jcore.stats[key], key


def _saturate(core, Request_, urgent, images):
    def req(rid, task, scene, prompt=0, priority=0, deadline_s=None):
        return Request_(task=task, image=images[scene], prompt=prompt,
                        scene_id=scene, request_id=rid, priority=priority,
                        deadline_s=deadline_s)

    def took():
        return [(r.request_id, why) for r, why in core.take_rejected()]

    t0 = 1000.0
    calls = [core.submit_many([req(100 + i, "det", i // 2, i % 2)
                               for i in range(4)], now=t0)]
    finished, tokens, rejected = [], {}, []

    def step():
        for r, t in core.step():
            finished.append(r.request_id)
            tokens[r.request_id] = np.asarray(t).tolist()
        rejected.append(took())

    for _ in range(6):
        step()
    calls += [core.submit_many([req(110 + i, "vqa", 2, i, urgent)
                                for i in range(2)], now=t0 + 1),
              core.submit_many([req(120, "vqa", 4, deadline_s=FAR)],
                               now=t0 + 1),
              core.submit_many([req(130 + i, "cls", 3, i % 3)
                                for i in range(5)], now=t0 + 1)]
    rejected.append(took())
    for sh in core.shards:            # 120 expires wherever it waits
        calls.append(sh.submit_many([], now=t0 + 1 + 2 * FAR))
    rejected.append(took())
    for _ in range(2000):
        step()
        if core.active_count() == 0 and core.queue_depth() == 0:
            break
    else:
        raise AssertionError("the sharded engine did not drain")
    ol = dict(core.scheduler_stats()["overload"])
    ol["per_shard"] = [{k: v for k, v in o.items()
                        if k not in ("readmit_wait_ms", "ttft_by_priority")}
                       for o in ol["per_shard"]]
    return {"calls": calls, "rejected": rejected, "finished": finished,
            "tokens": tokens, "overload": ol,
            "per_shard": core.kv_stats()["per_shard"],
            "routed": list(core._routed)}


@pytest.mark.parametrize("flavour", ["plain", "chunked"])
def test_dp2_overload_matches_jax(system, flavour):
    """``submit_many`` outcomes, ``take_rejected``, finished order and
    tokens, the merged overload counts and the per-shard rows of a
    saturated (2, 1) engine equal the JAX ``ShardedEngineCore``'s."""
    from repro.serving import PRIORITY_URGENT as JURGENT
    j = system["jax"]
    kw = FLAVOURS[flavour]
    probe = EngineCore(system["tier"], system["ac"], EngineCoreConfig(
        slots=4, answer_vocab=ANSWER_VOCAB, **kw))
    pool = 1 + 3 * probe._private_per_slot + 3 * probe._n_shared_pages
    cfg = dict(slots=4, answer_vocab=ANSWER_VOCAB, pool_pages=pool, **kw)
    core = make_engine_core(system["tier"], system["ac"], EngineCoreConfig(
        mesh=M.make_host_mesh(model=1, data=2, devices=["cpu"] * 2),
        overload=OverloadConfig(queue_cap=2), **cfg))
    from repro.serving import EngineCoreConfig as JEngineCoreConfig
    from repro.serving import OverloadConfig as JOverloadConfig
    jcore = j["sharded"].make_engine_core(
        j["tier"], j["ac"], JEngineCoreConfig(
            mesh=j["make_mesh"](model=1, data=2),
            overload=JOverloadConfig(queue_cap=2), **cfg))
    got = _saturate(core, Request, PRIORITY_URGENT, system["images"])
    want = _saturate(jcore, j["Request"], JURGENT, system["images"])
    assert got == want
    ol = got["overload"]
    assert ol["preemptions"] >= 1 and ol["rejected_total"] >= 2


def _merge_values():
    from hypothesis import strategies as st
    scalar = st.one_of(st.integers(-5, 5), st.floats(-4, 4, width=32),
                       st.booleans(), st.sampled_from(["a", "b"]),
                       st.none())
    leaf = st.one_of(scalar, st.lists(st.integers(0, 3), max_size=3))
    keys = st.sampled_from(["x", "y", "z"])
    tree = st.recursive(leaf, lambda kids: st.dictionaries(keys, kids,
                                                           max_size=3),
                        max_leaves=8)
    return st.lists(st.dictionaries(keys, tree, max_size=3), max_size=4)


def test_merge_stats_matches_jax_hypothesis():
    """``_merge_stats`` equals JAX's on drawn nested dicts (ints and floats
    sum, dicts merge, lists concatenate, anything else keeps the first)
    where JAX's returns, and the same error where it raises."""
    hypothesis = pytest.importorskip("hypothesis")
    from repro.serving import sharded as jsharded

    @hypothesis.settings(max_examples=150, deadline=None)
    @hypothesis.given(_merge_values())
    def check(dicts):
        try:
            want = jsharded._merge_stats(dicts)
        except (TypeError, AttributeError) as e:   # mixed kinds, one key
            with pytest.raises(type(e)):
                port_sharded._merge_stats(dicts)
            return
        assert port_sharded._merge_stats(dicts) == want

    check()


# ---------------------------------------------------------------------------
# ports of the reference's other sharded-serving tests
# ---------------------------------------------------------------------------

def test_per_shard_pools_disjoint(system):
    """DP shards own private page allocators: churn on one shard never
    moves the other's pages."""
    core = make_engine_core(system["tier"], system["ac"], EngineCoreConfig(
        slots=4, answer_vocab=ANSWER_VOCAB,
        mesh=M.make_host_mesh(model=1, data=2, devices=["cpu"] * 2)))
    a, b = core.shards
    assert a._pool is not b._pool
    assert a._prefix is not b._prefix
    core.warmup()
    core.admit_many(_requests(Request, system["stream"][:2]))
    used_a, used_b = a._pool.pages_in_use, b._pool.pages_in_use
    assert used_a > 0 and used_b > 0
    while a.active_count():
        core.step()
    assert b._pool.pages_in_use == used_b or b.active_count() == 0
    total = a._pool.pages_in_use + b._pool.pages_in_use
    assert total <= used_a + used_b


def test_scene_affinity_routing(system):
    """Fan-out over one scene routes to the shard already holding its
    prefix pages: the prefix-cache hit rate survives the DP split."""
    core = make_engine_core(system["tier"], system["ac"], EngineCoreConfig(
        slots=4, answer_vocab=ANSWER_VOCAB,
        mesh=M.make_host_mesh(model=1, data=2, devices=["cpu"] * 2)))
    core.warmup()
    img = system["stream"][1][1]
    for p in range(4):
        assert len(_drive(core, [Request(task="vqa", image=img,
                                         prompt=p % 2)])) == 1
    ks = core.kv_stats()
    assert ks["prefix_hit_rate"] == pytest.approx(0.75)
    assert max(r["routed"] for r in ks["per_shard"]) == 4


def test_mesh_validation_errors(system):
    tier, ac = system["tier"], system["ac"]
    mesh = M.make_host_mesh(model=1, data=2, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="'data' axis"):
        EngineCore(tier, ac, EngineCoreConfig(slots=4, mesh=mesh))
    with pytest.raises(ValueError, match="mesh"):
        ShardedEngineCore(tier, ac, EngineCoreConfig(slots=4))
    with pytest.raises(ValueError, match="slots"):
        ShardedEngineCore(tier, ac, EngineCoreConfig(slots=1, mesh=mesh))
    one = M.make_host_mesh(model=1, data=1, devices=["cpu"])
    with pytest.raises(ValueError, match="batched paged engine"):
        EngineCore(tier, ac, EngineCoreConfig(cache_impl="dense", mesh=one))
    with pytest.raises(ValueError, match="data axis is 1"):
        ShardedEngineCore(tier, ac, EngineCoreConfig(mesh=one))
    xcfg = get_config("xlstm-125m", reduced=True)
    xtier = TierModel({"backbone": None, "patch_proj": torch.zeros(1)}, xcfg)
    with pytest.raises(ValueError, match="attention-only"):
        EngineCore(xtier, ac, EngineCoreConfig(mesh=one))


def test_factory_picks_engine(system):
    tier, ac = system["tier"], system["ac"]

    def build(mesh):
        return make_engine_core(tier, ac, EngineCoreConfig(slots=4,
                                                           mesh=mesh))
    assert type(build(None)) is EngineCore
    assert type(build(M.make_host_mesh(model=1, data=1,
                                       devices=["cpu"]))) is EngineCore
    assert isinstance(build(M.make_host_mesh(model=1, data=2,
                                             devices=["cpu"] * 2)),
                      ShardedEngineCore)
    eng = InferenceEngine(tier.params, tier.cfg, ac, EngineConfig(
        slots=4, answer_vocab=ANSWER_VOCAB,
        mesh=M.make_host_mesh(model=1, data=2, devices=["cpu"] * 2)),
        device="cpu")
    assert isinstance(eng.core, ShardedEngineCore)
    out = eng.serve(_requests(Request, system["stream"]))
    assert len(out) == len(system["stream"])


def test_make_host_mesh_rules_match_jax():
    """The shape rules and ``parse_mesh_shape`` of the JAX launcher; the
    model axis's group is checked against its size."""
    from repro.launch import mesh as JM
    cpu8 = ["cpu"] * 8
    for data in (0, 3, 8):
        assert M.make_host_mesh(model=1, data=data, devices=cpu8).shape \
            == dict(JM.make_host_mesh(model=1, data=data).shape)
    for kw, match in [({"model": 0}, ">= 1"), ({"model": 9}, "exceeds"),
                      ({"model": 2, "data": 5}, "needs 10 devices"),
                      ({"model": 1, "data": -1}, ">= 1")]:
        with pytest.raises(ValueError, match=match):
            M.make_host_mesh(devices=cpu8, **kw)
        with pytest.raises(ValueError, match=match):
            JM.make_host_mesh(**kw)
    with pytest.raises(ValueError, match="process group"):
        M.make_host_mesh(model=2, data=1, devices=cpu8)
    for spec in ["dp2,tp4", "tp2", "dp4", "tp2xdp2", "", "DP3"]:
        assert M.parse_mesh_shape(spec) == JM.parse_mesh_shape(spec)
    for spec in ["pp2", "dp0"]:
        with pytest.raises(ValueError):
            M.parse_mesh_shape(spec)
    grid = M.make_host_mesh(model=1, data=4, devices=cpu8)
    assert grid.shape == {"data": 4, "model": 1} and grid.group is None
    assert port_sharded._submesh(grid, 2).shape == {"data": 1, "model": 1}


def _diverge(rank):
    import torch.distributed as dist
    x = torch.ones(4)
    dist.all_reduce(x)
    if rank == 1:
        dist.all_reduce(x)          # rank 0 never joins this one
    return float(x[0])


def _die(rank):
    import os
    if rank == 1:
        os._exit(3)
    import torch.distributed as dist
    x = torch.ones(4)
    dist.all_reduce(x)
    return float(x[0])


@pytest.mark.parametrize("fn,match", [(_diverge, "rank 1 failed"),
                                      (_die, "died|rank 0 failed")],
                         ids=["diverged", "dead_rank"])
def test_spawn_tp_fails_a_broken_world_within_its_timeout(fn, match):
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match=match):
        M.spawn_tp(fn, 2, backend="gloo", timeout_s=8)
    assert time.perf_counter() - t0 < 8 + 30


def test_spawn_tp_returns_results_in_rank_order():
    assert M.spawn_tp(_diverge_free, 2, 5, backend="gloo",
                      timeout_s=30) == [(0, 10.0), (1, 10.0)]


def _diverge_free(rank, k):
    import torch.distributed as dist
    x = torch.full((2,), float(k))
    dist.all_reduce(x)
    return rank, float(x[0])


def _chip_smoke():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_dp2_phase_13_stream_routes_as_jax(system):
    """``chip_smoke.py`` phase 13 (a)'s traffic on the small proxies: the
    20 cls/vqa requests of phase 6's stream (4 scenes, cls and 4 vqa each)
    through ``InferenceEngine.serve`` on 8 slots over 2 shards.  Routing
    reads scene keys, free slots and pages, never the model, so the prefix
    misses/hits the phase asserts on the card (``SHARD_DP_MISSES`` /
    ``SHARD_DP_HITS``: scene A's fifth request overflows its 4-slot shard)
    are the JAX router's here, as are the routes and the tokens."""
    from repro.serving import EngineConfig as JEngineConfig
    from repro.serving import InferenceEngine as JInferenceEngine
    smoke, j = _chip_smoke(), system["jax"]
    ac = system["ac"]
    stream = smoke.scene_stream(["det", "cls", "vqa", "vqa", "vqa", "vqa"],
                                4, ac.image_size, ac.grid, seed=300)
    kept = [r for r in stream if r.task != "det"]
    cfg = dict(slots=8, page_size=8, answer_vocab=ANSWER_VOCAB)
    eng = InferenceEngine(system["tier"].params, system["tier"].cfg, ac,
                          EngineConfig(mesh=M.make_host_mesh(
                              model=1, data=2, devices=["cpu"] * 2), **cfg),
                          device="cpu")
    jeng = JInferenceEngine(j["tier"].params, j["tier"].cfg, j["ac"],
                            JEngineConfig(mesh=j["make_mesh"](model=1,
                                                              data=2),
                                          **cfg))
    got = eng.serve(smoke.clone_requests(kept))
    want = jeng.serve([j["Request"](task=r.task, image=r.image,
                                    prompt=r.prompt, scene_id=r.scene_id)
                       for r in kept])
    assert [g.tokens.tolist() for g in got] \
        == [np.asarray(w.tokens).tolist() for w in want]
    st, jst = eng.core.stats, jeng.core.stats
    assert (st["prefix_misses"], st["prefix_hits"]) \
        == (jst["prefix_misses"], jst["prefix_hits"]) \
        == (smoke.SHARD_DP_MISSES, smoke.SHARD_DP_HITS)
    assert eng.core.kv_stats()["per_shard"] \
        == jeng.core.kv_stats()["per_shard"]
