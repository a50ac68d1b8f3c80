"""The port's per-slot oracle ``step_impl="vmap"`` against the JAX package's.

Both packages run the same bridged random-init proxy weights
(``proxy_pair("small")``) on the same request stream (vqa/cls/det queries
over three shared scenes, three slots, so slots refill mid-stream).  The
port's vmap engine must give the JAX vmap engine's tokens, in the same
finishing order, and its counters; its tokens must also be the port's
batched engines' (paged greedy and the γ 2 speculative engine, whose
committed stream is the greedy one).  The JAX engine refuses vmap with
chunked prefill, 8-bit pools, speculative decoding and a mesh; the port
raises the same exception types.  float32 throughout, matmul precision
pinned.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: pytest's workers share the cores, and torch's
# default of a thread a core in each worker oversubscribes them
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.configs.spaceverse_pair import proxy_pair as jproxy_pair  # noqa: E402
from repro.core import eo_adapter as JEO  # noqa: E402
from repro.core.cascade import TierModel as JTierModel  # noqa: E402
from repro.launch.mesh import make_host_mesh as jmake_host_mesh  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import EngineCore as JEngineCore  # noqa: E402
from repro.serving import EngineCoreConfig as JEngineCoreConfig  # noqa: E402
from repro.serving import InferenceEngine as JInferenceEngine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.spaceverse_pair import proxy_pair  # noqa: E402
from repro_torch.core import eo_adapter as EO  # noqa: E402
from repro_torch.core.cascade import TierModel  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.serving import (EngineConfig, EngineCore,  # noqa: E402
                                 EngineCoreConfig, InferenceEngine, Request)

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

ANSWER_VOCAB = 9
SLOTS = 3
TASKS = ["det", "vqa", "cls", "vqa", "det", "vqa", "cls", "vqa", "det"]
COUNTERS = ("prefix_hits", "prefix_misses", "prefill_tokens",
            "prefill_by_kind", "mid_stream_refills", "admitted", "finished")


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
    for i, task in enumerate(TASKS):
        data = synthetic.make_dataset(task, 1, seed=i % 3)
        stream.append((task, data["images"][0], int(data["prompts"][0]),
                       i % 3))
    return {"jsat": JTierModel(jsat, jsat_cfg),
            "jgs": JTierModel(jgs, jgs_cfg),
            "sat": TierModel(carry(jsat), sat_cfg),
            "gs": TierModel(carry(jgs), gs_cfg), "jac": jac, "ac": ac,
            "stream": stream}


def _requests(cls, stream):
    return [cls(task=t, image=im, prompt=p, scene_id=s)
            for t, im, p, s in stream]


def _serve(system, jax_side, **kw):
    if jax_side:
        draft = system["jsat"] if kw.get("spec_gamma") else None
        eng = JInferenceEngine(system["jgs"].params, system["jgs"].cfg,
                               system["jac"],
                               JEngineConfig(slots=SLOTS,
                                             answer_vocab=ANSWER_VOCAB, **kw),
                               draft=draft)
        reqs = _requests(JRequest, system["stream"])
    else:
        draft = system["sat"] if kw.get("spec_gamma") else None
        eng = InferenceEngine(system["gs"].params, system["gs"].cfg,
                              system["ac"],
                              EngineConfig(slots=SLOTS,
                                           answer_vocab=ANSWER_VOCAB, **kw),
                              draft=draft, device="cpu")
        reqs = _requests(Request, system["stream"])
    out = eng.serve(reqs)
    by_id = {r.request_id: np.asarray(r.tokens).tolist() for r in out}
    return eng, out, [by_id[r.request_id] for r in reqs]


@pytest.fixture(scope="module")
def vmap_runs(system):
    return _serve(system, False, step_impl="vmap"), _serve(
        system, True, step_impl="vmap")


def test_vmap_engine_matches_jax_vmap_engine(vmap_runs):
    (eng, out, toks), (jeng, jout, jtoks) = vmap_runs
    assert len(out) == len(jout) == len(TASKS)
    for g, w in zip(out, jout):              # the same finishing order
        np.testing.assert_array_equal(g.tokens, w.tokens)
    assert toks == jtoks
    for key in COUNTERS:
        assert eng.core.stats[key] == jeng.core.stats[key], key
    assert eng.core.stats["mid_stream_refills"] > 0
    sched, jsched = eng.core.scheduler_stats(), jeng.core.scheduler_stats()
    for key in ("steps", "decode_tokens", "tokens_per_step"):
        assert sched[key] == jsched[key], key
    assert sched["steady_recompiles"] == 0
    # the oracle steps the dense layout, as the JAX engine's does
    assert eng.core.cache_impl == jeng.core.cache_impl == "dense"
    assert eng.core.kv_stats()["kv_bytes_total"] == \
        jeng.core.kv_stats()["kv_bytes_total"]


@pytest.mark.parametrize("flavour", ["paged", "spec_gamma_2"])
def test_vmap_oracle_equals_the_batched_engines(system, vmap_runs, flavour):
    """The port's batched engines give the oracle's tokens: the paged
    greedy engine, and the γ 2 speculative engine (local drafting), whose
    committed stream is the greedy one."""
    want = vmap_runs[0][2]
    kw = {"spec_gamma": 2} if flavour == "spec_gamma_2" else {}
    eng, _, toks = _serve(system, False, **kw)
    assert toks == want
    if kw:
        assert eng.core.spec_stats()["accepted"] > 0


@pytest.mark.parametrize("bad", [
    {"prefill_chunk": 8}, {"kv_dtype": "int8"}, {"kv_dtype": "fp8"},
    {"spec_gamma": 2}, {"mesh": True}])
def test_vmap_refusals_match_jax(system, bad):
    """JAX's refusals of the oracle, matched with their exception types."""
    def attempt(jax_side):
        kw = dict(bad)
        if kw.get("mesh"):
            kw["mesh"] = (jmake_host_mesh(model=1, data=1) if jax_side
                          else make_host_mesh(model=1, data=1,
                                              devices=["cpu"]))
        if jax_side:
            draft = system["jsat"] if kw.get("spec_gamma") else None
            JEngineCore(system["jgs"], system["jac"],
                        JEngineCoreConfig(step_impl="vmap", **kw),
                        draft=draft)
        else:
            draft = system["sat"] if kw.get("spec_gamma") else None
            EngineCore(system["gs"], system["ac"],
                       EngineCoreConfig(step_impl="vmap", **kw),
                       draft=draft)

    errors = []
    for jax_side in (True, False):
        with pytest.raises(Exception) as info:
            attempt(jax_side)
        errors.append(info.type)
    assert errors[0] is errors[1] is ValueError
    # InferenceEngine's config refuses chunked vmap as it is made
    if "prefill_chunk" in bad:
        with pytest.raises(ValueError, match="batched paged"):
            EngineConfig(step_impl="vmap", **bad)
