"""The port's continuous-batching engines against the JAX package's.

Both packages run the same bridged random-init proxy weights
(``proxy_pair("small")``: the satellite tier drafts, the ground tier
serves and verifies) on the same request stream: vqa/cls/det queries
fanning out over shared scenes, on three slots, so slots refill mid-stream
and scenes hit the prefix cache.  Tokens must be equal, and so must the
engines' counters (prefix hits/misses, prefilled tokens, mid-stream
refills, pages in use, and the speculative engine's ``spec_stats()``).
float32 throughout, matmul precision pinned.
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
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import InferenceEngine as JInferenceEngine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.spaceverse_pair import proxy_pair  # noqa: E402
from repro_torch.core import eo_adapter as EO  # noqa: E402
from repro_torch.core.cascade import TierModel  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.serving import (EngineConfig, EngineCore,  # noqa: E402
                                 EngineCoreConfig, InferenceEngine, Request)

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

ANSWER_VOCAB = 9
SLOTS = 3
COUNTERS = ("prefix_hits", "prefix_misses", "prefill_tokens",
            "mid_stream_refills", "admitted", "finished")
SPEC_COUNTERS = ("steps", "verify_only_steps", "slot_steps", "drafted",
                 "accepted", "committed", "emitted", "piggybacked")
TASKS = ["det", "vqa", "cls", "vqa", "det", "vqa", "cls", "vqa", "det",
         "vqa"]


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

    stream = []                      # (task, image, prompt, scene)
    for i, task in enumerate(TASKS):
        scene = i % 3
        data = synthetic.make_dataset(task, 1, seed=scene)
        stream.append((task, data["images"][0], int(data["prompts"][0]),
                       scene))
    return {"jsat": JTierModel(jsat, jsat_cfg), "jgs": JTierModel(jgs,
                                                                  jgs_cfg),
            "sat": TierModel(carry(jsat), sat_cfg),
            "gs": TierModel(carry(jgs), gs_cfg), "jac": jac, "ac": ac,
            "stream": stream}


def _requests(cls, stream, drafts=None):
    return [cls(task=t, image=im, prompt=p, scene_id=s,
                draft_tokens=None if drafts is None else drafts[i])
            for i, (t, im, p, s) in enumerate(stream)]


def _port_engine(system, **kw):
    draft = system["sat"] if kw.get("spec_gamma") else None
    return InferenceEngine(system["gs"].params, system["gs"].cfg,
                           system["ac"],
                           EngineConfig(slots=SLOTS,
                                        answer_vocab=ANSWER_VOCAB, **kw),
                           draft=draft, device="cpu")


def _jax_engine(system, **kw):
    draft = system["jsat"] if kw.get("spec_gamma") else None
    return JInferenceEngine(system["jgs"].params, system["jgs"].cfg,
                            system["jac"],
                            JEngineConfig(slots=SLOTS,
                                          answer_vocab=ANSWER_VOCAB, **kw),
                            draft=draft)


def _tokens(responses):
    return {r.request_id: r.tokens for r in responses}


@pytest.fixture(scope="module")
def greedy(system):
    """The non-speculative paged engines of both packages on the stream:
    (port responses, port engine, JAX responses, JAX engine, the port's
    tokens in stream order)."""
    port = _port_engine(system)
    reqs = _requests(Request, system["stream"])
    got = port.serve(reqs)
    jeng = _jax_engine(system)
    want = jeng.serve(_requests(JRequest, system["stream"]))
    by_id = _tokens(got)
    return got, port, want, jeng, [by_id[r.request_id] for r in reqs]


def test_paged_serve_matches_jax_tokens_and_counters(greedy):
    got, port, want, jeng, _ = greedy
    assert len(got) == len(want) == len(TASKS)
    for g, w in zip(got, want):           # the same finishing order
        np.testing.assert_array_equal(g.tokens, w.tokens)
        assert g.tier == w.tier == "satellite"
    for key in COUNTERS:
        assert port.core.stats[key] == jeng.core.stats[key], key
    assert port.core.stats["mid_stream_refills"] > 0
    assert port.core.stats["prefix_hits"] > 0
    assert port.core.stats["prefill_by_kind"] == \
        jeng.core.stats["prefill_by_kind"]
    pk, jk = port.core.kv_stats(), jeng.core.kv_stats()
    for key in ("pages_in_use", "n_pages", "page_size", "prefix_entries",
                "prefix_shared_pages", "prefix_hit_rate", "kv_bytes_total",
                "kv_bytes_per_slot"):
        assert pk[key] == jk[key], key
    # drained: only the resident prefixes hold pages
    assert pk["pages_in_use"] == pk["prefix_shared_pages"]
    sched, jsched = port.core.scheduler_stats(), jeng.core.scheduler_stats()
    for key in ("steps", "decode_tokens", "tokens_per_step"):
        assert sched[key] == jsched[key], key


def test_paged_equals_dense_in_the_port(system, greedy):
    got = greedy[0]
    dense = _port_engine(system, cache_impl="dense")
    out = dense.serve(_requests(Request, system["stream"]))
    for g, d in zip(got, out):
        np.testing.assert_array_equal(g.tokens, d.tokens)
    assert dense.core.kv_stats()["cache_impl"] == "dense"
    assert dense.core.stats["prefill_tokens"] == \
        len(TASKS) * (system["ac"].n_regions + 1)


def _drafts(kind, greedy_tokens):
    if kind == "local":
        return None
    if kind == "perfect":
        return list(greedy_tokens)
    return [(t + 1) % ANSWER_VOCAB for t in greedy_tokens]   # adversarial


@pytest.mark.parametrize("gamma", [1, 3])
def test_spec_engine_matches_greedy_and_jax_spec_stats(system, greedy,
                                                       gamma):
    """One stream per γ mixing perfect piggybacked drafts (the first slots'
    worth, so verify-only steps happen), local drafting and adversarially
    wrong piggybacked drafts: tokens equal the greedy engine's and the
    counters equal the JAX spec engine's."""
    greedy_toks = greedy[-1]
    kinds = ["perfect"] * SLOTS + ["local", "adversarial"] * len(TASKS)
    drafts = [_drafts(kinds[i], t) for i, t in enumerate(greedy_toks)]
    port = _port_engine(system, spec_gamma=gamma)
    reqs = _requests(Request, system["stream"], drafts)
    out = _tokens(port.serve(reqs))
    for r, want in zip(reqs, greedy_toks):
        np.testing.assert_array_equal(out[r.request_id], want)
    jeng = _jax_engine(system, spec_gamma=gamma)
    jreqs = _requests(JRequest, system["stream"], drafts)
    jout = _tokens(jeng.serve(jreqs))
    for r, want in zip(jreqs, greedy_toks):
        np.testing.assert_array_equal(jout[r.request_id], want)
    ps, js = port.core.spec_stats(), jeng.core.spec_stats()
    for key in SPEC_COUNTERS:
        assert ps[key] == js[key], key
    assert ps["verify_only_steps"] > 0
    assert 0 < ps["accepted"] < ps["drafted"]
    for key in COUNTERS:
        assert port.core.stats[key] == jeng.core.stats[key], key


def test_shared_prefix_pages_unchanged_by_spec_steps(system):
    """The scene's shared pages are byte-equal before and after speculative
    steps (verify chunks start past N_r, so they never write them)."""
    stream = system["stream"]
    core = EngineCore(system["gs"], system["ac"],
                      EngineCoreConfig(slots=SLOTS, spec_gamma=3,
                                       answer_vocab=ANSWER_VOCAB),
                      draft=system["sat"])
    reqs = _requests(Request, [s for s in stream if s[3] == 0][:SLOTS])
    core.admit_many(reqs)
    entry = core._prefix.get(0)
    pages = torch.tensor(entry.pages)
    before = [{k: v[:, pages].clone() for k, v in d.items()}
              for d in core._slot_cache]
    done = []
    while core.active_count():
        done += core.step()
    assert len(done) == len(reqs)
    assert core.spec_stats()["steps"] > 0
    for b, d in zip(before, core._slot_cache):
        for k in b:
            assert torch.equal(b[k], d[k][:, pages]), k


def test_generate_spec_honours_generate(system):
    """``generate_spec`` gives ``generate``'s tokens and the distributions
    they were argmaxed from (5e-5: the verifier's f32 logits are computed
    in another batch shape)."""
    core = EngineCore(system["gs"], system["ac"],
                      EngineCoreConfig(slots=SLOTS, spec_gamma=2,
                                       answer_vocab=ANSWER_VOCAB),
                      draft=system["sat"])
    for task, image, prompt, _ in system["stream"][:3]:
        images = torch.from_numpy(image[None])
        prompts = torch.tensor([prompt], dtype=torch.int32)
        toks, probs = core.generate_spec(task, images, prompts, ANSWER_VOCAB)
        want_t, want_p = core.generate(task, images, prompts, ANSWER_VOCAB)
        np.testing.assert_array_equal(toks.numpy(), want_t.numpy())
        np.testing.assert_allclose(probs.numpy(), want_p.numpy(), rtol=0,
                                   atol=5e-5)


def test_engine_config_refuses_what_is_not_ported(system):
    # a mesh is taken (item 13); the JAX engine's rules refuse it off the
    # batched paged engine
    from repro_torch.launch.mesh import make_host_mesh
    one = make_host_mesh(model=1, data=1, devices=["cpu"])
    assert EngineConfig(mesh=one).mesh is one
    with pytest.raises(ValueError, match="batched paged engine"):
        EngineCore(system["gs"], system["ac"],
                   EngineCoreConfig(cache_impl="dense", mesh=one))
    with pytest.raises(ValueError, match="draft"):
        EngineCore(system["gs"], system["ac"],
                   EngineCoreConfig(spec_gamma=2))
    with pytest.raises(ValueError, match="paged"):
        EngineCore(system["gs"], system["ac"],
                   EngineCoreConfig(spec_gamma=2, cache_impl="dense"),
                   draft=system["sat"])
    core = EngineCore(system["gs"], system["ac"],
                      EngineCoreConfig(slots=1, page_size=5))
    assert core._page_size == 1              # gcd(5, N_r = 16)
    core.admit(_requests(Request, system["stream"][:1])[0])
    with pytest.raises(RuntimeError, match="no free slot"):
        core.admit(_requests(Request, system["stream"][:1])[0])


def test_engine_defaults_to_the_card(system):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(system["gs"].params, system["gs"].cfg, system["ac"])
