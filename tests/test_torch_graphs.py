"""The slot path's compiled-step contract on the CPU.

- Admission buckets: the port pads every admission-time model call to the
  JAX engine's power-of-two buckets (``_admit_pad``), and bucketed
  admissions (paged, dense, chunked, γ 2, int8) give the JAX engines'
  tokens, prefix hits/misses and pages.
- The port's ``CompileGuard``: the cases ``tests/test_lint.py`` holds the
  JAX package's guard to, on a family's ``captures()``, and its wiring in
  the engine (armed by ``warmup``, checked after each step).
- Capture safety: every step body (plain, vmap, fused, both speculative
  variants, int8 and fp8 pools, the paged admission step, the drafter
  feed, every admission bucket) runs under a dispatch mode that fails on
  the ops behind a host sync or a host-made tensor (``.item()``,
  ``nonzero``, ``torch.tensor(list)``), which a CUDA graph cannot capture;
  and the tensors a captured step reads stay at their addresses across
  steps, admissions, releases and a preemption.

Proxy weights (``proxy_pair("small")``), float32, four slots.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: pytest's workers share the cores, and torch's
# default of a thread a core in each worker oversubscribes them
torch.set_num_threads(1)

import jax  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.configs.spaceverse_pair import proxy_pair as jproxy_pair  # noqa: E402
from repro.core import eo_adapter as JEO  # noqa: E402
from repro.core.cascade import TierModel as JTierModel  # noqa: E402
from repro.serving import EngineCore as JEngineCore  # noqa: E402
from repro.serving import EngineCoreConfig as JEngineCoreConfig  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.analysis.compile_guard import (CompileGuard,  # noqa: E402
                                                SteadyStateRecompile)
from repro_torch.configs.spaceverse_pair import proxy_pair  # noqa: E402
from repro_torch.core import eo_adapter as EO  # noqa: E402
from repro_torch.core.cascade import TierModel  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.serving import (EngineCore, EngineCoreConfig,  # noqa: E402
                                 OverloadConfig, Request)
from repro_torch.serving import engine_core as EC  # noqa: E402
from repro_torch.serving.graphs import StagedInput  # noqa: E402
from repro_torch.serving.request import PRIORITY_URGENT  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

ANSWER_VOCAB = 9
SLOTS = 4
#: (task, scene) in arrival order; admitted in waves of 1, 3 (three new
#: scenes: bucket 4, one padding row) and then as slots free
STREAM = [("det", 0), ("vqa", 1), ("cls", 2), ("det", 3), ("vqa", 0),
          ("vqa", 1), ("cls", 4), ("vqa", 2), ("vqa", 4)]
WAVES = (1, 3)
FLAVOURS = {"paged": {}, "dense": {"cache_impl": "dense"},
            "chunked": {"prefill_chunk": 8}, "spec_gamma_2": {"spec_gamma": 2},
            "int8": {"kv_dtype": "int8"}}


@pytest.fixture(scope="module")
def system():
    jsat_cfg, jgs_cfg = jproxy_pair("small")
    sat_cfg, gs_cfg = proxy_pair("small")
    jac, ac = JEO.EOAdapterConfig(), EO.EOAdapterConfig()
    jsat = JEO.init_adapter(jax.random.PRNGKey(0), jsat_cfg, jac)
    jgs = JEO.init_adapter(jax.random.PRNGKey(1), jgs_cfg, jac)

    def carry(tree):
        return bridge.from_numpy(jax.tree.map(np.asarray, tree),
                                 device="cpu")

    stream = []
    for i, (task, scene) in enumerate(STREAM):
        data = synthetic.make_dataset(task, 1, seed=scene)
        stream.append((task, data["images"][0], int(data["prompts"][0]),
                       scene))
    return {"jsat": JTierModel(jsat, jsat_cfg),
            "jgs": JTierModel(jgs, jgs_cfg),
            "sat": TierModel(carry(jsat), sat_cfg),
            "gs": TierModel(carry(jgs), gs_cfg), "jac": jac, "ac": ac,
            "stream": stream}


def _core(system, jax_side=False, **kw):
    cfg = dict(slots=SLOTS, answer_vocab=ANSWER_VOCAB, **kw)
    if jax_side:
        draft = system["jsat"] if kw.get("spec_gamma") else None
        return JEngineCore(system["jgs"], system["jac"],
                           JEngineCoreConfig(**cfg), draft=draft)
    draft = system["sat"] if kw.get("spec_gamma") else None
    return EngineCore(system["gs"], system["ac"], EngineCoreConfig(**cfg),
                      draft=draft)


def _drive(core, reqs, waves=WAVES, max_steps=400):
    """Admit ``reqs`` in waves of the given sizes (then as slots free),
    stepping until all finish; returns tokens by stream position."""
    queue, out, pos = list(reqs), {}, {r.request_id: i
                                       for i, r in enumerate(reqs)}
    waves = list(waves)
    for _ in range(max_steps):
        free = len(core.free_slots())
        n = min(waves.pop(0) if waves else free, free, len(queue))
        if n:
            core.admit_many(queue[:n])
            del queue[:n]
        for r, t in core.step():
            out[pos[r.request_id]] = np.asarray(t).tolist()
        if not queue and core.active_count() == 0:
            break
    return [out[i] for i in range(len(reqs))]


def _requests(cls, system):
    return [cls(task=t, image=im, prompt=p, scene_id=s)
            for t, im, p, s in system["stream"]]


# ---------------------------------------------------------------------------
# admission buckets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("slots", [1, 2, 3, 4, 5, 6, 7, 8, 9, 16])
def test_bucket_sizes_equal_jax_admit_pad(slots):
    for k in range(1, slots + 1):
        assert EC._admit_pad(k, slots) == JEngineCore._admit_pad(k, slots)
        assert EC._admit_pad(k, slots) >= k
    # the JAX warmup's bucket set: the powers of two <= slots, and slots
    sizes, b = {slots}, 1
    while b <= slots:
        sizes.add(b)
        b *= 2
    assert EC.bucket_sizes(slots) == sorted(sizes)


@pytest.mark.parametrize("flavour", sorted(FLAVOURS))
def test_bucketed_admissions_match_jax(system, flavour):
    kw = FLAVOURS[flavour]
    core = _core(system, **kw)
    calls = []
    run = core._graphs.run

    def record(name, key, body):
        calls.append((name, key))
        run(name, key, body)

    core._graphs.run = record
    toks = _drive(core, _requests(Request, system))
    jcore = _core(system, jax_side=True, **kw)
    jtoks = _drive(jcore, _requests(JRequest, system))
    assert toks == jtoks
    for key in ("prefix_hits", "prefix_misses", "prefill_tokens",
                "prefill_by_kind", "admitted", "finished"):
        assert core.stats[key] == jcore.stats[key], key
    if core.cache_impl == "paged":
        pk, jk = core.kv_stats(), jcore.kv_stats()
        for key in ("pages_in_use", "n_pages", "prefix_entries",
                    "prefix_shared_pages"):
            assert pk[key] == jk[key], key
    buckets = {(n, k) for n, k in calls if k is not None}
    assert buckets and all(k in EC.bucket_sizes(SLOTS) for _, k in buckets)
    # the wave of three ran at the bucket of four
    want = {"paged": "prefix_prefill", "int8": "prefix_prefill",
            "spec_gamma_2": "draft_prefill", "dense": "dense_admit",
            "chunked": "region_embed"}[flavour]
    assert (want, 4) in buckets, sorted(buckets)


# ---------------------------------------------------------------------------
# the compile guard (tests/test_lint.py's cases, on captures())
# ---------------------------------------------------------------------------

class FakeFamily:
    def __init__(self):
        self.n = 0

    def captures(self):
        return self.n


def test_guard_raises_on_steady_state_recompile():
    fam = FakeFamily()
    guard = CompileGuard({"step": fam}, mode="raise")
    fam.n = 3            # warmup captures
    guard.arm()
    guard.check("step")  # stable -> fine
    fam.n = 4
    with pytest.raises(SteadyStateRecompile, match="step: 3 -> 4"):
        guard.check("step")


def test_guard_counts_in_production_mode_each_compile_once():
    fam = FakeFamily()
    guard = CompileGuard({"step": fam}, mode="count")
    guard.arm()
    fam.n = 2
    assert guard.check() == 2
    assert guard.check() == 0           # already accounted
    fam.n = 3
    guard.check()
    assert guard.steady_recompiles == 3


def test_guard_unarmed_and_off_are_noops():
    fam = FakeFamily()
    guard = CompileGuard({"step": fam}, mode="raise")
    fam.n = 5
    assert guard.check() == 0           # never armed
    guard.arm()
    fam.n = 9
    off = CompileGuard({"step": fam}, mode="off")
    off.arm()
    fam.n = 12
    assert off.check() == 0


def test_guard_skips_objects_without_captures():
    guard = CompileGuard(mode="count")
    guard.register("plain", lambda x: x)   # silently ignored
    guard.arm()
    assert guard.check() == 0


def test_guard_mode_from_environment(monkeypatch):
    monkeypatch.setenv("SPACELINT_COMPILE_GUARD", "count")
    assert CompileGuard().mode == "count"
    monkeypatch.delenv("SPACELINT_COMPILE_GUARD")
    assert CompileGuard().mode == "raise"   # under pytest


def test_engine_arms_the_guard_in_warmup_and_checks_each_step(system):
    """The engine registers every step family, ``warmup`` arms the guard,
    and a capture after it (faked here: the CPU captures nothing) raises
    at the next step under pytest."""
    core = _core(system)
    assert not core._compile_guard.armed
    core.warmup()
    assert core._compile_guard.armed
    assert core.graph_stats()["graphs"] == 0       # the CPU runs eagerly
    core.admit_many(_requests(Request, system)[:2])
    core.step()
    assert core.scheduler_stats()["steady_recompiles"] == 0
    core._graphs.families["slot_step"].graphs["late"] = None
    with pytest.raises(SteadyStateRecompile, match="slot_step: 0 -> 1"):
        core.step()


# ---------------------------------------------------------------------------
# capture safety
# ---------------------------------------------------------------------------

#: the ops behind ``.item()`` / ``int()`` / ``bool()`` on a tensor (the
#: mode sees ``item``, or ``_local_scalar_dense`` below it), ``nonzero``,
#: and ``torch.tensor(list)``
BANNED = ("item", "_local_scalar_dense", "nonzero", "lift_fresh")
#: indexing ops whose boolean index runs a ``nonzero`` inside the kernel
INDEXING = ("index", "index_put", "index_put_", "_index_put_impl_")


class NoHostSync(TorchDispatchMode):
    """Fails on a host sync or a host-made tensor.  ``allow_scalar`` lets a
    0-dim tensor made on the host pass (a scale a kernel takes by value,
    as a CPU scalar, which a capture records)."""

    def __init__(self, allow_scalar: bool = False):
        super().__init__()
        self.allow_scalar = allow_scalar

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in BANNED and not (self.allow_scalar and name == "lift_fresh"
                                   and args[0].dim() == 0):
            raise AssertionError(f"a step body ran aten.{name}")
        if name in INDEXING and any(
                isinstance(i, torch.Tensor) and i.dtype == torch.bool
                for i in (args[1] if len(args) > 1 else ())
                if i is not None):
            raise AssertionError(f"a step body ran aten.{name} with a "
                                 "boolean index (a nonzero inside)")
        return func(*args, **(kwargs or {}))


def test_the_dispatch_check_sees_host_syncs():
    """The check itself: each banned pattern fails it."""
    x = torch.arange(4, dtype=torch.int32)
    for bad in (lambda: int(x[0]), lambda: bool(x[1] > 0), x.nonzero,
                lambda: torch.tensor([1, 2]), lambda: x[x > 1],
                lambda: x.index_put_((x > 1,), x[:1])):
        with pytest.raises(AssertionError, match="a step body ran"):
            with NoHostSync():
                bad()
    with NoHostSync():                      # device-only work passes
        torch.where(x > 1, x, 0) + x.index_select(0, x[:1].long())


SAFETY = {"paged": ({}, {"slot_step", "paged_admit", "prefix_prefill"}),
          "dense": ({"cache_impl": "dense"}, {"slot_step", "dense_admit"}),
          "vmap": ({"step_impl": "vmap"}, {"slot_step", "dense_admit"}),
          "chunked": ({"prefill_chunk": 8},
                      {"fused_step", "slot_step", "region_embed"}),
          "chunked_spec": ({"prefill_chunk": 8, "spec_gamma": 2},
                           {"fused_step", "draft_feed", "draft_prefill",
                            "spec_step", "spec_verify", "region_embed"}),
          "spec_gamma_2": ({"spec_gamma": 2},
                           {"spec_step", "spec_verify", "paged_admit",
                            "prefix_prefill", "draft_prefill"}),
          "int8": ({"kv_dtype": "int8"},
                   {"slot_step", "paged_admit", "prefix_prefill"}),
          "fp8": ({"kv_dtype": "fp8"},
                  {"slot_step", "paged_admit", "prefix_prefill"})}


@pytest.mark.parametrize("flavour", sorted(SAFETY))
def test_step_bodies_are_capture_safe(system, flavour):
    kw, families = SAFETY[flavour]
    core = _core(system, **kw)
    ran = set()
    graphs = core._graphs

    def guarded(name, key, body):
        ran.add((name, key))
        with NoHostSync():
            body()

    graphs.run = graphs.warm = guarded
    core.warmup()
    warmed = {n for n, _ in ran}
    assert families <= warmed, sorted(families - warmed)
    assert {k for n, k in ran if n in ("prefix_prefill", "dense_admit",
                                       "draft_prefill", "region_embed")} \
        == set(EC.bucket_sizes(SLOTS))
    reqs = _requests(Request, system)
    if kw.get("spec_gamma"):
        # the first request's drafts cover it: a verify-only step runs
        reqs[0] = Request(task="det", image=reqs[0].image, prompt=0,
                          scene_id=0,
                          draft_tokens=np.zeros((16,), np.int32))
    ran.clear()
    _drive(core, reqs)
    served = {n for n, _ in ran}
    assert served <= families | {"slot_step"}
    assert "slot_step" in served or "spec_step" in served


def _addresses(core):
    """The address of every tensor a captured step may read or write."""
    out = {}
    for name, v in vars(core).items():
        if isinstance(v, torch.Tensor):
            out[name] = v.data_ptr()
        elif isinstance(v, StagedInput):
            out[name] = v.dev.data_ptr()
    for i, c in enumerate(core._slot_cache + (core._draft_cache or ())):
        for k, leaf in c.items():
            out[f"cache{i}.{k}"] = leaf.data_ptr()
    for kp, b in core._buckets.items():
        for k, s in b.items():
            out[f"bucket{kp}.{k}"] = s.dev.data_ptr()
    return out


@pytest.mark.parametrize("flavour", ["paged", "spec_gamma_2"])
def test_persistent_buffers_stay_put(system, flavour):
    """20 steps with admissions, releases and a preemption (an urgent
    request on a full table) move no tensor a captured step reads."""
    core = _core(system, overload=OverloadConfig(queue_cap=16),
                 **FLAVOURS[flavour])
    core.warmup()
    before = _addresses(core)
    reqs = _requests(Request, system)
    dets = [Request(task="det", image=r.image, prompt=r.prompt,
                    scene_id=r.scene_id) for r in reqs[:SLOTS]]
    core.submit_many(dets)
    for _ in range(3):
        core.step()
    urgent = Request(task="vqa", image=reqs[5].image, prompt=1,
                     scene_id=9, priority=PRIORITY_URGENT)
    core.submit_many([urgent] + reqs[SLOTS:])
    finished = []
    for _ in range(17):
        finished += core.step()
    assert core.stats["overload"]["preemptions"] >= 1
    assert finished and core.stats["admitted"] > SLOTS
    assert _addresses(core) == before
    assert core.scheduler_stats()["steady_recompiles"] == 0
