"""The dense attention configs in the port against the JAX package's.

codeqwen1.5-7b, glm4-9b, gemma2-27b and gemma3-1b: attention blocks with a
dense FFN.  The port's copies of their configs equal JAX's, full and
reduced.  At the reduced size, with the windows cut to 8 so that they bite
on 20-token prompts and 16-region scenes, and with the overrides that give
the full models' attention shapes (group 1: codeqwen at 4/4 heads; group
16: glm4 at 16/1; head dim 256: gemma3), the same weights (made by JAX from
a seed, carried across by ``bridge``) give the same logits through
``prefill`` and greedy ``decode_step`` (float32, within 1e-4), and the
vision-frontend engines (paged, paged on int8 pools, dense, and chunked at
hd 256) serve the same stream to the same tokens, finishing order,
counters, pages and ``kv_stats()`` as JAX's.  gemma3-1b's serving tier is
cut to one local and one global layer: JAX's engine compiles the
13-layer reduced stack for 10-15 s a run.  float32 throughout, matmul
precision pinned.
"""
import dataclasses
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
from repro.models import transformer as JT  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import InferenceEngine as JInferenceEngine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro_torch import bridge, configs  # noqa: E402
from repro_torch.configs.base import BlockSpec  # noqa: E402
from repro_torch.core import eo_adapter as EO  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving import (EngineConfig, InferenceEngine,  # noqa: E402
                                 Request)

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

NAMES = ("codeqwen1.5-7b", "glm4-9b", "gemma2-27b", "gemma3-1b")
TOL = 1e-4
WINDOW = 8
PROMPT, N_DECODE = 20, 6
ANSWER_VOCAB = 9
SLOTS = 2
#: (task, scene, prompt) in arrival order: slots refill mid-stream and
#: scenes hit the prefix cache
STREAM = [("det", 0, 0), ("vqa", 1, 2), ("cls", 0, 0), ("vqa", 0, 5),
          ("det", 1, 1), ("vqa", 1, 3)]
COUNTERS = ("prefix_hits", "prefix_misses", "prefill_tokens",
            "prefill_by_kind", "mid_stream_refills", "admitted", "finished")
#: the reduced configs, each with the override that gives its full
#: model's attention shape, and the windows cut to ``WINDOW``
VARIANTS = {
    "codeqwen-g1": ("codeqwen1.5-7b", {"num_kv_heads": 4}),
    "glm4-g16": ("glm4-9b", {"num_heads": 16, "num_kv_heads": 1}),
    "gemma2": ("gemma2-27b", {}),
    "gemma3-hd256": ("gemma3-1b", {"head_dim": 256}),
}
#: the serving tiers: gemma3-1b cut to one local and one global layer
SERVE_TIERS = dict(VARIANTS, **{
    "gemma3-hd256": ("gemma3-1b", {"head_dim": 256, "num_layers": 2,
                                   "block_pattern": ("local", "global")})})
FLAVOURS = {"paged": {}, "int8": {"kv_dtype": "int8"},
            "dense": {"cache_impl": "dense"}, "chunked": {"prefill_chunk": 8}}
#: every tier paged; the 8-bit pools at groups 16 and 4 (hd 256), the
#: dense cache under gemma2's softcaps and at hd 256, chunked at hd 256
SERVE_CASES = ([(t, "paged") for t in SERVE_TIERS]
               + [("glm4-g16", "int8"), ("gemma3-hd256", "int8"),
                  ("gemma2", "dense"), ("gemma3-hd256", "dense"),
                  ("gemma3-hd256", "chunked")])


def _pattern(pattern, spec_cls, block_spec):
    """The config's pattern with every window cut to ``WINDOW``; a pattern
    of "local"/"global" names is built as windowed / full blocks."""
    if pattern and isinstance(pattern[0], str):
        return tuple(spec_cls(kind="attn", window=WINDOW if p == "local"
                              else 0) for p in pattern)
    return tuple(dataclasses.replace(b, window=min(b.window, WINDOW))
                 if b.window > 0 else b for b in block_spec)


def _cfgs(name, over, **extra):
    """JAX's and the port's reduced config of ``name`` with ``over`` (and
    ``extra``) applied, windows cut; their ``asdict`` must be equal."""
    out = []
    for reg, spec_cls in ((jconfigs, JBlockSpec), (configs, BlockSpec)):
        base = reg.get_config(name, reduced=True)
        kw = dict(over, **extra)
        kw["block_pattern"] = _pattern(kw.get("block_pattern"), spec_cls,
                                       base.block_pattern)
        out.append(dataclasses.replace(base, **kw))
    assert dataclasses.asdict(out[0]) == dataclasses.asdict(out[1])
    return out


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_config_equals_jax(name, reduced):
    got = configs.get_config(name, reduced=reduced)
    assert dataclasses.asdict(got) == dataclasses.asdict(
        jconfigs.get_config(name, reduced=reduced))
    assert name in configs.list_configs()


def test_full_configs_shapes():
    """The attention shapes the full models give the kernels: groups 1, 16,
    2 and 4, head dims 128 and 256, gemma2's softcaps and gemma3's
    512-token window."""
    shape = {n: (c.num_heads // c.num_kv_heads, c.resolved_head_dim)
             for n in NAMES for c in [configs.get_config(n)]}
    assert shape == {"codeqwen1.5-7b": (1, 128), "glm4-9b": (16, 128),
                     "gemma2-27b": (2, 128), "gemma3-1b": (4, 256)}
    g2, g3 = configs.get_config("gemma2-27b"), configs.get_config("gemma3-1b")
    assert (g2.attn_softcap, g2.final_softcap) == (50.0, 30.0)
    assert {b.window for b in g3.block_pattern} == {0, 512}


_jprefill = jax.jit(JT.prefill, static_argnums=(1, 3))
_jdecode = jax.jit(JT.decode_step, static_argnums=(1,))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_prefill_and_greedy_decode_match_jax(variant):
    """``prefill`` over a 20-token prompt, then 6 greedy ``decode_step``s:
    logits within 1e-4 at every step, the same greedy tokens."""
    name, over = VARIANTS[variant]
    jcfg, cfg = _cfgs(name, over)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(5))
    tp = bridge.from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, PROMPT)).astype(np.int32)
    max_len = PROMPT + N_DECODE
    jlog, jcache, jidx = _jprefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                                   max_len)
    tlog, tcache, tidx = T.prefill(tp, cfg, {"tokens": torch.from_numpy(toks)},
                                   max_len)
    assert int(jidx) == tidx == PROMPT
    for step in range(N_DECODE + 1):
        jl, tl = np.asarray(jlog), tlog.numpy()
        np.testing.assert_allclose(tl, jl, rtol=0, atol=TOL,
                                   err_msg=f"{variant} step {step}")
        nxt = jl.argmax(-1).astype(np.int32)[:, None]
        np.testing.assert_array_equal(tl.argmax(-1), nxt[:, 0])
        if step == N_DECODE:
            break
        jlog, jcache = _jdecode(jp, jcfg, jcache, {"tokens": jnp.asarray(nxt)},
                                jnp.int32(tidx + step))
        tlog, tcache = T.decode_step(tp, cfg, tcache,
                                     {"tokens": torch.from_numpy(nxt)},
                                     tidx + step)


@pytest.fixture(scope="module")
def systems():
    """The serving tiers built so far in this module, by name."""
    return {}


def _system(systems, tier):
    """Both packages' serving tier ``tier`` (vision frontend), the port's
    weights from a seed handed to JAX, built once per module."""
    if tier not in systems:
        name, over = SERVE_TIERS[tier]
        jcfg, cfg = _cfgs(name, over, frontend="vision")
        ac, jac = EO.EOAdapterConfig(), JEO.EOAdapterConfig()
        params = EO.init_adapter(cfg, ac, 3, device="cpu")
        jparams = jax.tree.map(jnp.asarray, bridge.to_numpy(params))
        images = synthetic.make_dataset(
            "cls", 5, seed=7, cfg=synthetic.EOTaskConfig(
                image_size=ac.image_size, grid=ac.grid))["images"]
        systems[tier] = {
            "jax": types.SimpleNamespace(
                Request=JRequest, Engine=JInferenceEngine,
                EngineConfig=JEngineConfig, params=jparams, cfg=jcfg,
                ac=jac, images=images, extra={}),
            "port": types.SimpleNamespace(
                Request=Request, Engine=InferenceEngine,
                EngineConfig=EngineConfig, params=params, cfg=cfg, ac=ac,
                images=images, extra={"device": "cpu"})}
    return systems[tier]


def _serve(pkg, flavour):
    """``InferenceEngine.serve`` of the stream: (engine, the answers in
    finishing order as (stream position, tokens))."""
    eng = pkg.Engine(pkg.params, pkg.cfg, pkg.ac, pkg.EngineConfig(
        slots=SLOTS, answer_vocab=ANSWER_VOCAB, **FLAVOURS[flavour]),
        **pkg.extra)
    reqs = [pkg.Request(task=t, image=pkg.images[s], prompt=p, scene_id=s)
            for t, s, p in STREAM]
    pos = {r.request_id: i for i, r in enumerate(reqs)}
    out = eng.serve(reqs)
    return eng, [(pos[r.request_id], np.asarray(r.tokens).tolist())
                 for r in out]


@pytest.mark.parametrize("tier,flavour", SERVE_CASES)
def test_serving_matches_jax(systems, tier, flavour):
    """Tokens in finishing order, counters, the scheduler's token counts,
    pages and ``kv_stats()``: the port's engine equals JAX's, windows
    biting on the 16-region prefix."""
    system = _system(systems, tier)
    eng, got = _serve(system["port"], flavour)
    jeng, want = _serve(system["jax"], flavour)
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
    if core.cache_impl == "paged":
        assert core.stats["prefix_hits"] == len(STREAM) - 2
    if flavour == "chunked":
        assert sched["fused_steps"] == jsched["fused_steps"] > 0
