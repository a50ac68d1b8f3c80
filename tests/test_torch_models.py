"""The port's model stack against the JAX package's on bridged weights.

JAX random-init proxy weights (``proxy_pair``, ``EO.init_adapter``; no
training) cross through ``repro_torch.bridge`` to CPU tensors.  The same
numpy images and prompts then run through ``EO.prefill_tokens`` and greedy
``decode_step``s in both packages: logits within 1e-4 (float32, sums in
another order), equal argmax over the answer vocabulary.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: pytest's workers share the cores, and torch's
# default of a thread a core in each worker oversubscribes them
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.spaceverse_pair import proxy_pair as jproxy_pair  # noqa: E402
from repro.core import confidence as JC  # noqa: E402
from repro.core import eo_adapter as JEO  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.spaceverse_pair import proxy_pair  # noqa: E402
from repro_torch.core import eo_adapter as EO  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

TOL = 1e-4
ANSWER_VOCAB = 9
N_DECODE = 8

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

# jitted once per config: eager lax.scan would retrace every step
_jprefill = jax.jit(JEO.prefill_prompt, static_argnums=(1, 2, 3, 6))
_jdecode = jax.jit(JT.decode_step, static_argnums=(1,))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=["small", "example"])
def bridged(request):
    jsat, jgs = jproxy_pair(request.param)
    sat, gs = proxy_pair(request.param)
    for a, b in ((jsat, sat), (jgs, gs)):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    ac = JEO.EOAdapterConfig()
    out = []
    for i, (jcfg, cfg) in enumerate(((jsat, sat), (jgs, gs))):
        jp = JEO.init_adapter(jax.random.PRNGKey(i), jcfg, ac)
        tp = bridge.from_numpy(_np_tree(jp), device="cpu")
        out.append((jcfg, cfg, jp, tp))
    return ac, out


def _inputs(ac, b=2, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal(
        (b, ac.image_size, ac.image_size, ac.channels)).astype(np.float32)
    prompts = np.array([3, 5], np.int32)[:b]
    return images, prompts


def test_prefill_and_greedy_decode_match_jax(bridged):
    ac, tiers = bridged
    tac = EO.EOAdapterConfig()
    images, prompts = _inputs(ac)
    for jcfg, cfg, jp, tp in tiers:
        l_ans = 10
        jlog, jcache, jidx = _jprefill(
            jp, jcfg, ac, "vqa", jnp.asarray(images), jnp.asarray(prompts),
            l_ans)
        tlog, tcache, tidx = EO.prefill_prompt(
            tp, cfg, tac, "vqa", torch.from_numpy(images),
            torch.from_numpy(prompts), l_ans)
        assert int(jidx) == tidx
        for step in range(N_DECODE + 1):
            jl, tl = np.asarray(jlog), tlog.numpy()
            np.testing.assert_allclose(tl, jl, rtol=0, atol=TOL,
                                       err_msg=f"{cfg.name} step {step}")
            jarg = jl[:, :ANSWER_VOCAB].argmax(-1)
            np.testing.assert_array_equal(
                tl[:, :ANSWER_VOCAB].argmax(-1), jarg)
            if step == N_DECODE:
                break
            nxt = jarg.astype(np.int32)[:, None]
            jlog, jcache = _jdecode(jp["backbone"], jcfg, jcache,
                                          {"tokens": jnp.asarray(nxt)},
                                          jnp.int32(tidx + step))
            tlog, tcache = T.decode_step(tp["backbone"], cfg, tcache,
                                         {"tokens": torch.from_numpy(nxt)},
                                         tidx + step)


def test_ragged_index_decode_matches_scalar(bridged):
    """A (B,) index tensor gives each row its own position; with equal
    positions it must reproduce the scalar-index step."""
    ac, tiers = bridged
    tac = EO.EOAdapterConfig()
    images, prompts = _inputs(ac)
    _, cfg, _, tp = tiers[0]
    outs = []
    for index in (None, "vector"):
        log, cache, idx = EO.prefill_prompt(
            tp, cfg, tac, "vqa", torch.from_numpy(images),
            torch.from_numpy(prompts), 4)
        at = idx if index is None else torch.full((2,), idx)
        tok = torch.tensor([[1], [0]], dtype=torch.int32)
        outs.append(T.decode_step(tp["backbone"], cfg, cache,
                                  {"tokens": tok}, at)[0])
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


def _assert_bytes_equal(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.shape == y.shape and x.dtype == y.dtype
        assert x.tobytes() == y.tobytes()


def test_bridge_round_trip_is_byte_equal(bridged):
    ac, tiers = bridged
    jcfg, _, jp, _ = tiers[0]
    conf = JC.init_confidence(jax.random.PRNGKey(3), jcfg.d_model,
                              jcfg.d_model, hidden=64, num_stages=2)
    for tree in (jp, jp["backbone"], conf):
        np_tree = _np_tree(tree)
        back = bridge.to_numpy(bridge.from_numpy(np_tree, device="cpu"))
        _assert_bytes_equal(np_tree, back)
        assert bridge.kind_of(back) == bridge.kind_of(np_tree)


def test_bridge_carries_bfloat16_and_casts():
    tree = {"projs": [{"w": np.asarray(jnp.arange(6, dtype=jnp.bfloat16))}],
            "trunk": {"w1": np.ones((2, 2), np.float32)}}
    t = bridge.from_numpy(tree, device="cpu")
    assert t["projs"][0]["w"].dtype == torch.bfloat16
    _assert_bytes_equal(tree, bridge.to_numpy(t))
    cast = bridge.from_numpy(tree, device="cpu", dtype=torch.bfloat16)
    assert cast["trunk"]["w1"].dtype == torch.bfloat16
    with pytest.raises(ValueError):
        bridge.from_numpy({"w": np.zeros(2)}, device="cpu")


def test_port_init_keeps_the_jax_tree_structure():
    sat, _ = proxy_pair("small")
    jp = JT.init_params(jproxy_pair("small")[0], jax.random.PRNGKey(0))
    tp = T.init_params(sat, seed=0, device="cpu")
    jshapes = jax.tree.map(lambda x: tuple(x.shape), jp)
    tshapes = jax.tree.map(lambda x: tuple(x.shape), bridge.to_numpy(tp))
    assert jax.tree.structure(jshapes) == jax.tree.structure(tshapes)
    assert jax.tree.leaves(jshapes) == jax.tree.leaves(tshapes)
