"""The port's engines over recurrent (xLSTM) tiers against the JAX package's.

Two tiers, each built once from bridged weights (made by the port from a
seed and handed to JAX as arrays): the reduced xlstm-125m (mLSTM and sLSTM
blocks, no attention) and the ``mixed`` stack of ``tests/test_torch_xlstm.py``
(attention, mLSTM, sLSTM), both with the vision frontend, so a scene's
region tokens are a prefix that the paged engine prefills once and whose
final recurrent states it snapshots.  The same request stream (det, vqa
and cls queries over two scenes, two slots, so slots refill mid-stream and
scenes hit the prefix cache) runs through both packages' engines: paged,
paged on int8 pools, dense and the vmap oracle; the batch path
(``EngineCore.generate``); and an overload run whose preemption evicts the
victim's scene, so its re-admission prefills the prefix and its snapshot
again.  Tokens, finishing order, counters, ``prefill_by_kind``, prefix
hits and misses, pages and ``kv_stats()`` must be equal.  The port's own
checks: ``warmup()`` with active slots leaves every state leaf bit-equal,
the step bodies of a recurrent tier run no host sync (capture safety), and
``pool_bytes`` refuses a stack without attention KV.  float32 throughout,
matmul precision pinned.
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

from repro import configs as jconfigs  # noqa: E402
from repro.configs.base import BlockSpec as JBlockSpec  # noqa: E402
from repro.core import eo_adapter as JEO  # noqa: E402
from repro.core.cascade import TierModel as JTierModel  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import EngineCore as JEngineCore  # noqa: E402
from repro.serving import EngineCoreConfig as JEngineCoreConfig  # noqa: E402
from repro.serving import InferenceEngine as JInferenceEngine  # noqa: E402
from repro.serving import OverloadConfig as JOverloadConfig  # noqa: E402
from repro.serving import PRIORITY_URGENT as JPRIORITY_URGENT  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import eo_adapter as EO  # noqa: E402
from repro_torch.core.cascade import TierModel  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving import (PRIORITY_URGENT, EngineConfig,  # noqa: E402
                                 EngineCore, EngineCoreConfig,
                                 InferenceEngine, OverloadConfig, Request)
from test_torch_graphs import NoHostSync  # noqa: E402

#: ``chip_smoke.py`` as a module: its phase 3 tiers (``SMALL_RECURRENT``,
#: ``recurrent_cfg``) are the ones held here against JAX
_SMOKE = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
_spec = importlib.util.spec_from_file_location("chip_smoke", _SMOKE)
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

ANSWER_VOCAB = 9
SLOTS = 2
#: (task, scene, prompt) in arrival order
STREAM = [("det", 0, 0), ("vqa", 1, 2), ("cls", 0, 0), ("vqa", 0, 5),
          ("det", 1, 1), ("vqa", 1, 3)]
COUNTERS = ("prefix_hits", "prefix_misses", "prefill_tokens",
            "prefill_by_kind", "mid_stream_refills", "admitted", "finished")
FLAVOURS = {"paged": {}, "int8": {"kv_dtype": "int8"},
            "dense": {"cache_impl": "dense"}, "vmap": {"step_impl": "vmap"}}


def _cfgs(variant):
    """JAX's and the port's config of ``chip_smoke.SMALL_RECURRENT[variant]``
    (the port's from ``chip_smoke.recurrent_cfg``)."""
    cfg = chip_smoke.recurrent_cfg(variant)
    over = dict(chip_smoke.SMALL_RECURRENT[variant], frontend="vision")
    if "block_pattern" in over:
        over["block_pattern"] = tuple(JBlockSpec(kind=k)
                                      for k in over["block_pattern"])
    jcfg = jconfigs.reduced_config(jconfigs.get_config("xlstm-125m"), **over)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    return jcfg, cfg


@pytest.fixture(scope="module", params=list(chip_smoke.SMALL_RECURRENT))
def system(request):
    return _system(request.param)


def _system(variant):
    jcfg, cfg = _cfgs(variant)
    jac, ac = JEO.EOAdapterConfig(), EO.EOAdapterConfig()
    params = EO.init_adapter(cfg, ac, 3, device="cpu")
    jparams = jax.tree.map(jnp.asarray, bridge.to_numpy(params))
    images = synthetic.make_dataset("cls", 5, seed=7, cfg=synthetic.EOTaskConfig(
        image_size=ac.image_size, grid=ac.grid))["images"]
    return {
        "variant": variant, "images": images, "runs": {},
        "jax": types.SimpleNamespace(
            name="jax", Request=JRequest, Core=JEngineCore,
            CoreConfig=JEngineCoreConfig, Engine=JInferenceEngine,
            EngineConfig=JEngineConfig, Overload=JOverloadConfig,
            PRIORITY_URGENT=JPRIORITY_URGENT, gs=JTierModel(jparams, jcfg),
            ac=jac, images=images),
        "port": types.SimpleNamespace(
            name="port", Request=Request, Core=EngineCore,
            CoreConfig=EngineCoreConfig, Engine=InferenceEngine,
            EngineConfig=EngineConfig, Overload=OverloadConfig,
            PRIORITY_URGENT=PRIORITY_URGENT, gs=TierModel(params, cfg),
            ac=ac, images=images),
    }


def _requests(pkg):
    return [pkg.Request(task=t, image=pkg.images[s], prompt=p, scene_id=s)
            for t, s, p in STREAM]


def _serve(system, side, flavour):
    """``InferenceEngine.serve`` of the stream on ``side`` ("port" or
    "jax"), once per module: (engine, the answers in finishing order as
    (stream position, tokens))."""
    key = (side, flavour)
    if key not in system["runs"]:
        pkg = system[side]
        extra = {"device": "cpu"} if side == "port" else {}
        eng = pkg.Engine(pkg.gs.params, pkg.gs.cfg, pkg.ac,
                         pkg.EngineConfig(slots=SLOTS,
                                          answer_vocab=ANSWER_VOCAB,
                                          **FLAVOURS[flavour]), **extra)
        reqs = _requests(pkg)
        pos = {r.request_id: i for i, r in enumerate(reqs)}
        out = eng.serve(reqs)
        system["runs"][key] = (eng, [(pos[r.request_id],
                                      np.asarray(r.tokens).tolist())
                                     for r in out])
    return system["runs"][key]


def _state_shapes(cfg, cache):
    """Each recurrent-state leaf's shape, ``None`` at attention positions."""
    return T.map_cache_kinds(cfg, [cache], kv=lambda _t: None,
                             state=lambda t: {k: tuple(x.shape)
                                              for k, x in t.items()})


@pytest.mark.parametrize("flavour", list(FLAVOURS))
def test_slot_path_matches_jax(system, flavour):
    """Tokens in finishing order, counters, the scheduler's token counts,
    pages and ``kv_stats()``: the port's engine equals JAX's.  A paged
    engine's prefix entries hold one snapshot row per scene."""
    eng, got = _serve(system, "port", flavour)
    jeng, want = _serve(system, "jax", flavour)
    assert got == want
    assert sorted(i for i, _ in got) == list(range(len(STREAM)))
    core, jcore = eng.core, jeng.core
    for key in COUNTERS:
        assert core.stats[key] == jcore.stats[key], key
    assert core.stats["mid_stream_refills"] > 0
    sched, jsched = core.scheduler_stats(), jcore.scheduler_stats()
    for key in ("steps", "decode_tokens", "prompt_tokens", "tokens_per_step",
                "prefill_by_kind"):
        assert sched[key] == jsched[key], key
    assert sched["steady_recompiles"] == 0
    assert core.cache_impl == jcore.cache_impl
    assert core.kv_stats() == jcore.kv_stats()
    if system["variant"] == "xlstm":
        assert core.kv_stats()["kv_bytes_total"] == 0
    if core.cache_impl == "paged":
        assert core.stats["prefix_hits"] == len(STREAM) - 2
        cfg = core.tier.cfg
        row = T.map_cache_kinds(
            cfg, [_state_shapes(cfg, core._slot_cache)], kv=lambda _t: None,
            state=lambda t: {k: (x[0], 1) + x[2:] for k, x in t.items()})
        for e in core._prefix._entries.values():
            assert _state_shapes(cfg, e.state) == row


def test_batch_path_matches_jax(system):
    """``EngineCore.generate`` (prefill + one decode chunk) equals JAX's:
    on vqa and cls queries, tokens and probabilities (within 1e-5); on the
    stream's det queries, the tokens of JAX's dense slot engine, which are
    JAX's ``generate`` answers."""
    got, want = [], []
    for side, out in (("port", got), ("jax", want)):
        pkg = system[side]
        core = pkg.Core(pkg.gs, pkg.ac,
                        pkg.CoreConfig(slots=1, answer_vocab=ANSWER_VOCAB,
                                       cache_impl="dense"))
        arr = torch.from_numpy if side == "port" else jnp.asarray
        for task, scene, prompt in (("vqa", 1, 2), ("cls", 0, 0)):
            toks, probs = core.generate(
                task, arr(np.asarray(pkg.images[scene:scene + 1])),
                arr(np.asarray([prompt], np.int32)), ANSWER_VOCAB)
            out.append((np.asarray(toks), np.asarray(probs)))
    for (t, p), (jt, jp) in zip(got, want):
        np.testing.assert_array_equal(t, jt)
        np.testing.assert_allclose(p, jp, atol=1e-5)
    pkg = system["port"]
    core = EngineCore(pkg.gs, pkg.ac,
                      EngineCoreConfig(slots=1, answer_vocab=ANSWER_VOCAB,
                                       cache_impl="dense"))
    jdense = dict(_serve(system, "jax", "dense")[1])
    for i, (task, scene, prompt) in enumerate(STREAM):
        if task != "det":
            continue
        toks, _ = core.generate(task, torch.from_numpy(
            np.asarray(pkg.images[scene:scene + 1])),
            torch.tensor([prompt], dtype=torch.int32), ANSWER_VOCAB)
        assert toks.shape == (1, pkg.ac.n_regions)
        assert toks[0].tolist() == jdense[i], i


def _overload(pkg):
    """Two slots, a resident-scene budget of the active slots' only
    (``prefix_cache_scenes=0``): three bulk det queries on scenes 0-2 (the
    third queued), two steps, then an urgent vqa on scene 3, which
    preempts slot 0's det and evicts its scene; the victim re-admits once
    the urgent answer is done, prefilling scene 0 again.  Returns the
    outcomes, the finishing order and tokens, the preempted request's
    tokens at its release, the overload counts, the counters and pages."""
    core = pkg.Core(pkg.gs, pkg.ac, pkg.CoreConfig(
        slots=SLOTS, answer_vocab=ANSWER_VOCAB, prefix_cache_scenes=0,
        overload=pkg.Overload(queue_cap=8)))
    preempted, release = [], core._release_slot

    def release_and_record(i):
        sl = core._slots[i]
        if sl.active and len(sl.tokens) < sl.l_ans:
            preempted.append((sl.request.request_id, list(sl.tokens)))
        release(i)

    core._release_slot = release_and_record

    def req(rid, task, scene, priority=0):
        return pkg.Request(task=task, image=pkg.images[scene], prompt=0,
                           scene_id=scene, request_id=rid, priority=priority)

    t0 = 1000.0
    calls = [core.submit_many([req(50 + i, "det", i) for i in range(3)],
                              now=t0)]
    order, tokens = [], {}

    def step():
        for r, t in core.step():
            order.append(r.request_id)
            tokens[r.request_id] = np.asarray(t).tolist()

    for _ in range(2):
        step()
    calls.append(core.submit_many([req(53, "vqa", 3, pkg.PRIORITY_URGENT)],
                                  now=t0 + 1))
    for _ in range(200):
        if core.active_count() == 0 and core.queue_depth() == 0:
            break
        step()
    ol = dict(core.scheduler_stats()["overload"])
    ol["readmit_wait_ms"] = ol["readmit_wait_ms"]["n"]
    ol["ttft_by_priority"] = {p: v["n"]
                              for p, v in ol["ttft_by_priority"].items()}
    kv = core.kv_stats()
    return {"calls": calls, "order": order, "tokens": tokens,
            "preempted": preempted, "overload": ol,
            "counters": {k: core.stats[k] for k in COUNTERS},
            "rejected": [(r.request_id, why)
                         for r, why in core.take_rejected()],
            "pages": {k: kv[k] for k in ("pages_in_use", "n_pages",
                                         "prefix_entries",
                                         "prefix_entries_in_use",
                                         "prefix_shared_pages",
                                         "kv_bytes_total")}}


def test_overload_with_preemption_and_eviction_matches_jax(system):
    """Overload control with a preemption whose victim's prefix is evicted
    and prefilled again (snapshot included) before it re-admits: every
    outcome, the finishing order, the tokens, the overload counts, counters
    and pages equal JAX's; the victim re-emits the tokens it had committed
    and gives the uncontended engine's answer."""
    got = _overload(system["port"])
    want = _overload(system["jax"])
    assert got == want
    assert got["overload"]["preemptions"] == 1 and got["rejected"] == []
    assert sorted(got["order"]) == [50, 51, 52, 53]
    (rid, toks), = got["preempted"]
    assert rid == 50 and toks and got["tokens"][rid][:len(toks)] == toks
    # scenes 0-3, and scene 0 again after its eviction
    assert got["counters"]["prefix_misses"] == 5
    uncontended = dict(_serve(system, "port", "paged")[1])
    assert got["tokens"][50] == uncontended[0]


def test_warmup_keeps_every_state_with_active_slots(system):
    """``warmup()`` runs the slot step over the whole table, which advances
    every row's recurrent state in place: with two slots mid-answer it
    must leave every state leaf, the logits and the index bit-equal, and
    the answers those of an engine never warmed mid-stream."""
    pkg = system["port"]
    answers = []
    for warm_midway in (False, True):
        core = EngineCore(pkg.gs, pkg.ac,
                          EngineCoreConfig(slots=SLOTS,
                                           answer_vocab=ANSWER_VOCAB))
        core.admit_many(_requests(pkg)[:2])
        core.step()
        if warm_midway:
            before = [x.clone() for x in core._state_leaves]
            logits = core._slot_logits.clone()
            index = core._slot_index.clone()
            core.warmup()
            assert before and len(before) == len(core._state_leaves)
            for a, b in zip(core._state_leaves, before):
                assert torch.equal(a, b)
            assert torch.equal(core._slot_logits, logits)
            assert torch.equal(core._slot_index, index)
        done = []
        while core.active_count():
            done += [(r.task, t.tolist()) for r, t in core.step()]
        answers.append(done)
    assert answers[0] == answers[1]


@pytest.mark.parametrize("flavour", ["paged", "dense", "vmap"])
def test_recurrent_step_bodies_are_capture_safe(system, flavour):
    """Every body a recurrent tier's engine warms and serves (the prefix
    prefill with its snapshot copy, the paged admission with its state
    merge, the slot step) runs no host sync."""
    pkg = system["port"]
    core = EngineCore(pkg.gs, pkg.ac,
                      EngineCoreConfig(slots=SLOTS, answer_vocab=ANSWER_VOCAB,
                                       **FLAVOURS[flavour]))
    ran = set()

    def guarded(name, key, body):
        ran.add(name)
        with NoHostSync(allow_scalar=True):
            body()

    core._graphs.run = core._graphs.warm = guarded
    core.warmup()
    reqs = _requests(pkg)
    core.admit_many(reqs[:2])
    while core.active_count():
        core.step()
    want = ({"slot_step", "prefix_prefill", "paged_admit"}
            if flavour == "paged" else {"slot_step", "dense_admit"})
    assert ran == want


def test_pool_bytes_needs_attention_kv(system):
    """A stack with no attention layer keeps no KV in its pages, so a byte
    budget buys no pages: ``pool_bytes`` raises a ValueError naming the
    cause (the JAX engine divides by zero there)."""
    pkg = system["port"]
    kw = dict(slots=SLOTS, answer_vocab=ANSWER_VOCAB, pool_bytes=1 << 20)
    if system["variant"] == "xlstm":
        with pytest.raises(ValueError, match="no attention layer"):
            EngineCore(pkg.gs, pkg.ac, EngineCoreConfig(**kw))
        with pytest.raises(ZeroDivisionError):
            JEngineCore(system["jax"].gs, system["jax"].ac,
                        JEngineCoreConfig(**kw))
    else:
        core = EngineCore(pkg.gs, pkg.ac, EngineCoreConfig(**kw))
        jcore = JEngineCore(system["jax"].gs, system["jax"].ac,
                            JEngineCoreConfig(**kw))
        assert core._n_pages == jcore._n_pages
        assert core._page_nbytes_stack() == jcore._page_nbytes_stack()
