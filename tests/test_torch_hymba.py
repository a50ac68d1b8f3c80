"""The port's Hymba slice against the JAX package, on the CPU.

The Mamba mixer, Hymba's hybrid mixer (attention ‖ Mamba on one input),
their stacks and the engines that serve them, held against the live JAX
package on the same numpy inputs or on bridged weights (JAX's random init
carried over by ``repro_torch.bridge``, or the port's handed to JAX as
arrays), float32 with matmul precision pinned.  Two configurations:

- the reduced hymba-1.5b (16 layers: one global layer, then 15 with the
  1024-token window, as the full model's period), and a ``(MAMBA,
  HYBRID)`` stack beside it;
- ``chip_smoke.hybrid_cfg()``, the two-layer tier phase 3 serves on the
  card: a global and a local hybrid layer, window 8, vision frontend, so
  the window binds inside the 16-region scene prefix.

Tolerances: a layer's output and state ``TOL_SSM`` 3e-4 (the scans' own
kernel-parity bound, ``tests/test_torch_xlstm.py``); logits 1e-4; cache
leaves 1e-4 + 1e-4·|want|, the Mamba states ``TOL_SSM`` + ``TOL_SSM``·|want|
(their chunked scans sum in another order); the vector-index decode
against per-row decodes 1e-5 (the JAX package's own bound,
``tests/test_batched_decode.py``).  The engines must give equal tokens,
counters, prefix hits, pages, ``kv_stats()`` and ``pool_bytes``.
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
from repro.kernels import ops as jops  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import EngineCore as JEngineCore  # noqa: E402
from repro.serving import EngineCoreConfig as JEngineCoreConfig  # noqa: E402
from repro.serving import InferenceEngine as JInferenceEngine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import HYBRID, MAMBA, BlockSpec  # noqa: E402
from repro_torch.core import eo_adapter as EO  # noqa: E402
from repro_torch.core.cascade import TierModel  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving import (EngineConfig, EngineCore,  # noqa: E402
                                 EngineCoreConfig, InferenceEngine, Request)

#: ``chip_smoke.py`` as a module: its phase 3 hybrid tier
#: (``hybrid_cfg``) is the one held here against JAX
_SMOKE = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
_spec = importlib.util.spec_from_file_location("chip_smoke", _SMOKE)
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

TOL_SSM = 3e-4
TOL = 1e-4
#: logits and f32 cache leaves over int8 pools (``test_paged_decode``)
TOL_INT8 = 2e-3
N_DECODE = 6

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

_jprefill = jax.jit(JT.prefill, static_argnums=(1, 3))
_jdecode = jax.jit(JT.decode_step, static_argnums=(1,))


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    """A tensor that owns a copy: the port writes caches in place, and
    must not write into a JAX array's buffer."""
    return torch.from_numpy(np.array(a, dtype=np.asarray(a).dtype))


def _close(got, want, tol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32),
                               np.asarray(want, dtype=np.float32),
                               rtol=rtol, atol=tol)


# ---------------------------------------------------------------------------
# configurations
# ---------------------------------------------------------------------------

def _hymba(**over):
    """JAX's and the port's reduced hymba-1.5b with ``over`` (block kinds
    as (kind, window) pairs under ``"block_pattern"``)."""
    kinds = over.pop("block_pattern", None)
    jover, tover = dict(over), dict(over)
    if kinds:
        jover["block_pattern"] = tuple(JBlockSpec(kind=k, window=w)
                                       for k, w in kinds)
        tover["block_pattern"] = tuple(BlockSpec(kind=k, window=w)
                                       for k, w in kinds)
    jcfg = jconfigs.reduced_config(jconfigs.get_config("hymba-1.5b"),
                                   **jover)
    cfg = configs.reduced_config(configs.get_config("hymba-1.5b"), **tover)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    return jcfg, cfg


VARIANTS = {
    "reduced": {},
    "mamba": {"num_layers": 2,
              "block_pattern": ((MAMBA, 0), (HYBRID, 4))},
}


def _tier_cfgs():
    """Phase 3's two-layer hybrid tier (``chip_smoke.hybrid_cfg``) and
    JAX's config of it."""
    cfg = chip_smoke.hybrid_cfg()
    jcfg = jconfigs.reduced_config(
        jconfigs.get_config("hymba-1.5b"), num_layers=cfg.num_layers,
        frontend=cfg.frontend,
        block_pattern=tuple(JBlockSpec(kind=s.kind, window=s.window)
                            for s in cfg.block_pattern))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    return jcfg, cfg


def test_hymba_config_matches_jax():
    for reduced in (False, True):
        assert (dataclasses.asdict(configs.get_config("hymba-1.5b", reduced))
                == dataclasses.asdict(jconfigs.get_config("hymba-1.5b",
                                                          reduced)))
    cfg = configs.get_config("hymba-1.5b")
    assert cfg.num_layers == 32 and cfg.n_super == 2
    assert [s.window for s in cfg.block_pattern] == [0] + [1024] * 15
    red = configs.get_config("hymba-1.5b", reduced=True)
    assert red.num_layers == 16 and red.n_super == 1


# ---------------------------------------------------------------------------
# the Mamba and hybrid layers
# ---------------------------------------------------------------------------

def _layer_params(tree):
    """A mixer's JAX params as the port's tensors (the bridge takes whole
    backbone trees: the mixer rides under "blocks")."""
    return bridge.from_numpy({"embed": {}, "blocks": jax.tree.map(
        np.asarray, tree), "final_norm": np.zeros(1)},
        device="cpu")["blocks"]


def _layer_case(rng, jcfg, kind, mode, s_cache=24, b=2):
    """Inputs of one layer call: x, a carried cache (random Mamba state;
    random KV below the decode position), cos/sin, the cache index."""
    s = 1 if mode == "decode" else 16
    x = _rand(rng, b, s, jcfg.d_model)
    cache = {"state": _rand(rng, *JL.init_mamba_cache(jcfg, b)["state"]
                            .shape) * 0.5}
    idx = 11 if mode == "decode" else 0
    if kind == "hybrid":
        kv = JL.init_attn_cache(jcfg, b, s_cache, jnp.float32)
        kv = {k: _rand(rng, *v.shape) for k, v in kv.items()}
        cache = {"attn": kv, "mamba": cache}
    pos = np.broadcast_to(np.arange(idx, idx + s), (b, s))
    return x, cache, pos, idx


@pytest.mark.parametrize("mode", ["prefill", "decode"])
@pytest.mark.parametrize("kind", ["mamba", "hybrid"])
def test_mamba_and_hybrid_layers_match_jax(kind, mode):
    """Each mixer alone on bridged params and a carried cache, against the
    JAX layer under ``ref`` and the interpret-mode Pallas kernels: the
    output and every new cache leaf (the Mamba state, the hybrid's KV)
    within ``TOL_SSM``; the port writes the cache it was given."""
    jcfg, cfg = _hymba()
    rng = np.random.default_rng(20 + len(kind) + len(mode))
    key = jax.random.PRNGKey(5)
    jinit, jlayer = ((JL.init_mamba, JL.mamba) if kind == "mamba"
                     else (JL.init_hybrid, JL.hybrid))
    jp = jinit(key, jcfg)
    tp = _layer_params(jp)
    x, np_cache, pos, idx = _layer_case(rng, jcfg, kind, mode)
    jcache = jax.tree.map(jnp.asarray, np_cache)
    tcache = jax.tree.map(_t, np_cache)
    kw, tkw = {}, {}
    if kind == "hybrid":
        window = 8
        jcos, jsin = JL.rope_angles(jnp.asarray(pos), jcfg.resolved_head_dim,
                                    jcfg.rope_theta)
        tcos, tsin = L.rope_angles(torch.from_numpy(pos.copy()),
                                   cfg.resolved_head_dim, cfg.rope_theta)
        kw = dict(window=window, cos=jcos, sin=jsin, cache_index=idx)
        tkw = dict(window=window, cos=tcos, sin=tsin, cache_index=idx)
    tlayer = L.mamba if kind == "mamba" else L.hybrid
    out, tnew = tlayer(tp, _t(x), cfg=cfg, cache=tcache, mode=mode, **tkw)
    assert tnew is tcache
    for impl in ("ref", "pallas_interpret"):
        prev = jops.set_default_impl(impl)
        try:
            jout, jnew = jlayer(jp, jnp.asarray(x), cfg=jcfg, cache=jcache,
                                mode=mode, **kw)
        finally:
            jops.set_default_impl(prev)
        _close(out, jout, TOL_SSM)
        jl, tl = jax.tree.leaves(jnew), jax.tree.leaves(
            bridge.to_numpy(tnew))
        assert len(jl) == len(tl) == (1 if kind == "mamba" else 3)
        for a, w in zip(tl, jl):
            _close(a, w, TOL_SSM, rtol=TOL_SSM)


def _f32(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _record(monkeypatch, module, names):
    """Wrap ``module``'s functions ``names`` so each call's arguments are
    kept (the last call of each, tensors copied; their strides under
    ``name + " strides"``)."""
    got = {}
    for name in names:
        def call(*args, _fn=getattr(module, name), _name=name, **kw):
            got[_name] = tuple(a.clone() if torch.is_tensor(a) else a
                               for a in args)
            got[_name + " strides"] = [a.stride() for a in args
                                       if torch.is_tensor(a)]
            return _fn(*args, **kw)
        monkeypatch.setattr(module, name, call)
    return got


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_bf16_mamba_hands_its_scan_the_jax_operands(mode, monkeypatch):
    """The Mamba layer in bfloat16 on bridged params and a carried state:
    the operands of ``ssm_scan`` / ``ssm_decode_step`` equal the JAX
    layer's (``impl="ref"``): C and B bf16 bit-equal in at least 99.9% of
    elements and never more than one bf16 ulp apart (the matmul may sum in
    another order), v = x_in · dt likewise, the f32 log decay and state
    within 1e-5 relative; C and B reach the scan as the strided halves of
    one (B, S, H, 2n) buffer, as in JAX.  The output within 2^-6 of its
    largest magnitude (``tests/test_torch_xlstm.py``'s bf16 layer
    bound)."""
    jcfg, cfg = (dataclasses.replace(c, dtype="bfloat16") for c in _hymba())
    rng = np.random.default_rng(30)
    name = "ssm_decode_step" if mode == "decode" else "ssm_scan"
    jgot = _record(monkeypatch, jops, [name])
    tgot = _record(monkeypatch, ops, [name])
    jp = JL.init_mamba(jax.random.PRNGKey(6), jcfg)
    tp = _layer_params(jp)
    s = 1 if mode == "decode" else 32
    xj = jnp.asarray(_rand(rng, 2, s, cfg.d_model)).astype(jnp.bfloat16)
    xt = _t(_f32(xj)).to(torch.bfloat16)
    st = _rand(rng, *JL.init_mamba_cache(jcfg, 2)["state"].shape) * 0.5
    prev = jops.set_default_impl("ref")
    try:
        jout, _ = JL.mamba(jp, xj, cfg=jcfg, cache={"state": jnp.asarray(st)},
                           mode=mode)
    finally:
        jops.set_default_impl(prev)
    out, _ = L.mamba(tp, xt, cfg=cfg, cache={"state": _t(st)}, mode=mode)
    got, want = tgot[name], jgot[name]
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        a, b = _f32(g), _f32(w)
        assert a.shape == b.shape
        if str(w.dtype) == "bfloat16":
            assert (a == b).mean() >= 0.999
            _close(a, b, 0.0, rtol=2.0 ** -7)
        else:
            _close(a, b, 1e-6, rtol=1e-5)
    if mode == "prefill":
        n = L._ssm_state_dim(cfg)
        strides = tgot[name + " strides"]
        assert strides[0][-2] == strides[1][-2] == 2 * n
    assert out.dtype == torch.bfloat16
    a, b = _f32(out), _f32(jout)
    assert np.abs(a - b).max() <= 2.0 ** -6 * np.abs(b).max()


# ---------------------------------------------------------------------------
# the model stack on bridged weights
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=list(VARIANTS))
def model(request):
    jcfg, cfg = _hymba(**VARIANTS[request.param])
    jp = JT.init_params(jcfg, jax.random.PRNGKey(1))
    tp = bridge.from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, cfg, jp, tp


def _is_state(path) -> bool:
    return jax.tree_util.keystr(path).endswith("['state']")


def _cache_close(tcache, jcache, tol_kv=TOL, tol_state=TOL_SSM):
    """Every leaf: shapes and dtypes equal; KV within ``tol_kv`` (absolute
    and relative), Mamba states within ``tol_state``; int8 codes at most
    one step apart, at most 1% of the written ones."""
    jl = jax.tree.leaves_with_path(list(jcache))
    tl = jax.tree.leaves(bridge.to_numpy(list(tcache)))
    assert len(jl) == len(tl)
    for a, (path, w) in zip(tl, jl):
        assert a.shape == w.shape and a.dtype == w.dtype
        tol = tol_state if _is_state(path) else tol_kv
        if a.dtype == np.int8:
            # a code may round the other way where the f32 K/V differ in
            # their last bits
            w = np.asarray(w).astype(np.int32)
            d = np.abs(a.astype(np.int32) - w)
            assert d.max() <= 1 and (d > 0).sum() <= 0.01 * (w != 0).sum()
        else:
            _close(a, w, tol, rtol=tol)


def test_init_params_and_caches_keep_the_jax_tree_structure(model):
    """``init_params``, ``init_cache`` and ``init_paged_cache`` (fp and
    int8 pools) build JAX's trees (shapes, dtypes, all zero caches), and
    ``map_cache_kinds`` gives JAX's kinds: a hybrid layer's
    ``{"attn": kv, "mamba": state}``."""
    jcfg, cfg, jp, _ = model

    def meta(tree):
        return jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)), tree)

    tp = bridge.to_numpy(T.init_params(cfg, seed=0, device="cpu"))
    assert jax.tree.structure(meta(jp)) == jax.tree.structure(meta(tp))
    assert jax.tree.leaves(meta(jp)) == jax.tree.leaves(meta(tp))
    for jc, tc in (
            (JT.init_cache(jcfg, 3, 40), T.init_cache(cfg, 3, 40, "cpu")),
            (JT.init_paged_cache(jcfg, 3, 9, 8),
             T.init_paged_cache(cfg, 3, 9, 8, "cpu")),
            (JT.init_paged_cache(jcfg, 3, 9, 8, kv_dtype="int8"),
             T.init_paged_cache(cfg, 3, 9, 8, "cpu", kv_dtype="int8"))):
        tnp = bridge.to_numpy(list(tc))
        assert jax.tree.structure(meta(list(jc))) == jax.tree.structure(
            meta(tnp))
        assert jax.tree.leaves(meta(list(jc))) == jax.tree.leaves(meta(tnp))
        assert all(not a.any() for a in jax.tree.leaves(tnp))
        kinds = dict(kv=lambda *c: "kv", state=lambda *c: "state")
        got = T.map_cache_kinds(cfg, [tc, tc], **kinds)
        assert got == JT.map_cache_kinds(jcfg, [jc, jc], **kinds)
        assert {"kv": "kv", "state": "state"} != got[-1]
        assert got[-1] == {"attn": "kv", "mamba": "state"}


def test_prefill_and_greedy_decode_match_jax(model):
    """Logits within 1e-4, equal greedy tokens, every cache leaf after the
    prefill and after the greedy decode steps."""
    jcfg, cfg, jp, tp = model
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    jlog, jcache, _ = _jprefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                                16 + N_DECODE)
    tlog, tcache, tidx = T.prefill(tp, cfg, {"tokens": _t(toks)},
                                   16 + N_DECODE)
    assert tidx == 16
    _cache_close(tcache, jcache)
    for step in range(N_DECODE + 1):
        jl = np.asarray(jlog)
        _close(tlog, jl, TOL)
        nxt = jl.argmax(-1).astype(np.int32)[:, None]
        np.testing.assert_array_equal(tlog.numpy().argmax(-1), nxt[:, 0])
        if step == N_DECODE:
            break
        jlog, jcache = _jdecode(jp, jcfg, jcache,
                                {"tokens": jnp.asarray(nxt)},
                                jnp.int32(tidx + step))
        tlog, tcache = T.decode_step(tp, cfg, tcache, {"tokens": _t(nxt)},
                                     tidx + step)
    _cache_close(tcache, jcache)


def test_vector_index_decode_matches_per_row_and_jax(model):
    """A (B,) index decode at ragged positions equals B batch-1 decodes of
    the port within 1e-5 (the JAX package's own check of this stack,
    ``tests/test_batched_decode.py``), and JAX's vector-index decode
    within the logit and cache tolerances."""
    jcfg, cfg, jp, tp = model
    rng = np.random.default_rng(12)
    b, max_len = 4, 32
    toks = rng.integers(0, cfg.vocab_size, (b, 8)).astype(np.int32)
    tlog, tcache, _ = T.prefill(tp, cfg, {"tokens": _t(toks)}, max_len)
    jlog, jcache, _ = _jprefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                                max_len)
    vec = np.asarray([8, 12, 9, 8], np.int32)
    nxt = np.asarray(jlog)[:, :64].argmax(-1).astype(np.int32)[:, None]
    rows = [T.decode_step(tp, cfg, jax.tree.map(
        lambda x: x[:, r:r + 1].clone(), tcache),
        {"tokens": _t(nxt[r:r + 1])}, int(vec[r])) for r in range(b)]
    vlog, vcache = T.decode_step(tp, cfg, tcache, {"tokens": _t(nxt)},
                                 _t(vec))
    _close(vlog, torch.cat([lg for lg, _ in rows]), 1e-5, rtol=1e-5)
    for r, (_, rc) in enumerate(rows):
        for (path, a), w in zip(jax.tree.leaves_with_path(vcache),
                                jax.tree.leaves(rc)):
            # a Mamba state sums the products of every layer, each of which
            # a batch-1 matmul rounds apart from the batched one (JAX's
            # vmapped rows run the batched arithmetic itself): 1e-4
            tol = TOL if _is_state(path) else 1e-5
            _close(a[:, r:r + 1], w, tol, rtol=tol)
    jlog, jcache = _jdecode(jp, jcfg, jcache, {"tokens": jnp.asarray(nxt)},
                            jnp.asarray(vec))
    _close(vlog, jlog, TOL)
    _cache_close(vcache, jcache)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_paged_decode_matches_jax(model, kv_dtype):
    """Greedy decode through a block table over page pools (fp or int8),
    from zero pools and a carried random Mamba state, rows at ragged
    positions that share their first page: the logits, the greedy tokens
    and every cache leaf (pools, scales, states) equal JAX's after each
    step.  On int8 pools a code may round the other way where the f32 K/V
    differ in their last bits (``_cache_close``); one step is 1/127 of its
    row's largest |K/V|, so there the logits and f32 leaves are held to
    ``TOL_INT8`` (readings: a few codes flipped a step, logits within
    8.8e-4)."""
    jcfg, cfg, jp, tp = model
    rng = np.random.default_rng(13)
    b, page, n_pages = 3, 4, 12
    jc = JT.init_paged_cache(jcfg, b, n_pages, page, kv_dtype=kv_dtype)
    np_cache = JT.map_cache_kinds(
        jcfg, [jax.tree.map(np.asarray, jc)], kv=lambda t: t,
        state=lambda t: {"state": _rand(rng, *t["state"].shape) * 0.5})
    jc = jax.tree.map(jnp.asarray, np_cache)
    # copies: the port writes its pools in place, JAX's arrays may alias
    # the numpy buffers
    tc = bridge.cache_from_numpy(jax.tree.map(np.copy, list(np_cache)),
                                 device="cpu")
    table = np.array([[1, 2, 3], [1, 4, 5], [1, 6, 7]], np.int32)
    index = np.array([0, 3, 5], np.int32)
    toks = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
    for step in range(4):
        jl, jc = _jdecode(jp, jcfg, jc, {"tokens": jnp.asarray(toks)},
                          jnp.asarray(index + step),
                          block_table=jnp.asarray(table))
        tl, tc = T.decode_step(tp, cfg, tc, {"tokens": _t(toks)},
                               _t(index + step), block_table=_t(table))
        tol = TOL if kv_dtype is None else TOL_INT8
        _close(tl, jl, tol)
        np.testing.assert_array_equal(tl.numpy().argmax(-1),
                                      np.asarray(jl).argmax(-1))
        _cache_close(tc, jc, tol_kv=tol, tol_state=max(tol, TOL_SSM))
        toks = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]


def test_bridge_round_trips_a_bf16_hymba_tree():
    """The hybrid params sit inside the backbone tree: no new bridge kind;
    a round trip of a bf16 tree (f32 Mamba leaves beside bf16 weights) is
    byte-equal, both ways."""
    jcfg, _ = _hymba()
    jcfg = dataclasses.replace(jcfg, dtype="bfloat16")
    np_tree = jax.tree.map(np.asarray,
                           JT.init_params(jcfg, jax.random.PRNGKey(4)))
    assert bridge.kind_of(np_tree) == "backbone"
    dtypes = {a.dtype.name for a in jax.tree.leaves(np_tree)}
    assert dtypes == {"float32", "bfloat16"}
    back = bridge.to_numpy(bridge.from_numpy(np_tree, device="cpu"))
    for a, b in zip(jax.tree.leaves(np_tree), jax.tree.leaves(back)):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert a.tobytes() == b.tobytes()
    _, cfg = _hymba()
    tp = T.init_params(dataclasses.replace(cfg, dtype="bfloat16"), seed=2,
                       device="cpu")
    again = bridge.from_numpy(bridge.to_numpy(tp), device="cpu")
    for a, b in zip(jax.tree.leaves(tp), jax.tree.leaves(again)):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------------------
# the engines on the two-layer tier
# ---------------------------------------------------------------------------

ANSWER_VOCAB = 9
SLOTS = 2
#: (task, scene, prompt) in arrival order: two scenes, two slots, so slots
#: refill mid-stream and scenes hit the prefix cache
STREAM = [("det", 0, 0), ("vqa", 1, 2), ("cls", 0, 0), ("vqa", 0, 5),
          ("det", 1, 1), ("vqa", 1, 3)]
COUNTERS = ("prefix_hits", "prefix_misses", "prefill_tokens",
            "prefill_by_kind", "mid_stream_refills", "admitted", "finished")
FLAVOURS = {"paged": {}, "int8": {"kv_dtype": "int8"},
            "dense": {"cache_impl": "dense"}, "vmap": {"step_impl": "vmap"}}


@pytest.fixture(scope="module")
def system():
    jcfg, cfg = _tier_cfgs()
    jac, ac = JEO.EOAdapterConfig(), EO.EOAdapterConfig()
    assert ac.n_regions == cfg.num_patches
    params = EO.init_adapter(cfg, ac, 3, device="cpu")
    jparams = jax.tree.map(jnp.asarray, bridge.to_numpy(params))
    images = synthetic.make_dataset("cls", 2, seed=7, cfg=synthetic.EOTaskConfig(
        image_size=ac.image_size, grid=ac.grid))["images"]
    return {
        "images": images, "runs": {},
        "jax": types.SimpleNamespace(
            Request=JRequest, Core=JEngineCore, CoreConfig=JEngineCoreConfig,
            Engine=JInferenceEngine, EngineConfig=JEngineConfig,
            gs=JTierModel(jparams, jcfg), ac=jac),
        "port": types.SimpleNamespace(
            Request=Request, Core=EngineCore, CoreConfig=EngineCoreConfig,
            Engine=InferenceEngine, EngineConfig=EngineConfig,
            gs=TierModel(params, cfg), ac=ac),
    }


def _requests(system, pkg):
    return [pkg.Request(task=t, image=system["images"][s], prompt=p,
                        scene_id=s) for t, s, p in STREAM]


def _serve(system, side, flavour):
    """``InferenceEngine.serve`` of the stream on ``side``, once per
    module: (engine, the answers in finishing order as (stream position,
    tokens))."""
    key = (side, flavour)
    if key not in system["runs"]:
        pkg = system[side]
        extra = {"device": "cpu"} if side == "port" else {}
        eng = pkg.Engine(pkg.gs.params, pkg.gs.cfg, pkg.ac,
                         pkg.EngineConfig(slots=SLOTS,
                                          answer_vocab=ANSWER_VOCAB,
                                          **FLAVOURS[flavour]), **extra)
        reqs = _requests(system, pkg)
        pos = {r.request_id: i for i, r in enumerate(reqs)}
        out = eng.serve(reqs)
        system["runs"][key] = (eng, [(pos[r.request_id],
                                      np.asarray(r.tokens).tolist())
                                     for r in out])
    return system["runs"][key]


@pytest.mark.parametrize("flavour", list(FLAVOURS))
def test_engine_matches_jax(system, flavour):
    """Tokens in finishing order, counters, the scheduler's token counts,
    pages and ``kv_stats()`` (the attention halves' pools only) equal
    JAX's; a paged engine's prefix entries hold one Mamba-state row per
    scene beside no KV."""
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
    kv = core.kv_stats()
    assert kv == jcore.kv_stats()
    assert kv["kv_bytes_total"] > 0
    cfg = core.tier.cfg
    assert len(core._state_leaves) == len(cfg.block_pattern)
    if core.cache_impl == "paged":
        assert core.stats["prefix_hits"] == len(STREAM) - 2
        for e in core._prefix._entries.values():
            assert [sorted(t) for t in e.state] == [["attn", "mamba"]] * 2
            assert all(t["attn"] is None and t["mamba"]["state"].shape[1] == 1
                       for t in e.state)


def test_batch_path_matches_jax(system):
    """``EngineCore.generate`` (prefill + one decode chunk): tokens equal
    and probabilities within 1e-5 of JAX's on vqa and cls queries; the det
    answer equals that of JAX's dense slot engine (JAX's ``generate``
    answer, as ``tests/test_torch_recurrent_serving.py`` holds it)."""
    got, want = [], []
    for side, out in (("port", got), ("jax", want)):
        pkg = system[side]
        core = pkg.Core(pkg.gs, pkg.ac,
                        pkg.CoreConfig(slots=1, answer_vocab=ANSWER_VOCAB,
                                       cache_impl="dense"))
        arr = torch.from_numpy if side == "port" else jnp.asarray
        tasks = (("vqa", 1, 2), ("cls", 0, 0))
        if side == "port":
            tasks += (("det", 1, 1),)
        for task, scene, prompt in tasks:
            toks, probs = core.generate(
                task, arr(np.asarray(system["images"][scene:scene + 1])),
                arr(np.asarray([prompt], np.int32)), ANSWER_VOCAB)
            out.append((np.asarray(toks), np.asarray(probs)))
    for (t, p), (jt, jp) in zip(got, want):
        np.testing.assert_array_equal(t, jt)
        np.testing.assert_allclose(p, jp, atol=1e-5)
    jdense = dict(_serve(system, "jax", "dense")[1])
    assert got[2][0].shape == (1, system["port"].ac.n_regions)
    assert got[2][0][0].tolist() == jdense[4]


def test_pool_bytes_counts_the_hybrid_layers(system):
    """A byte budget buys JAX's pages: each hybrid layer's attention half
    keeps K+V pools (and an int8 pool's scales)."""
    pkg, jpkg = system["port"], system["jax"]
    for kv_dtype in (None, "int8"):
        kw = dict(slots=SLOTS, answer_vocab=ANSWER_VOCAB, pool_bytes=1 << 20,
                  kv_dtype=kv_dtype)
        core = EngineCore(pkg.gs, pkg.ac, EngineCoreConfig(**kw))
        jcore = JEngineCore(jpkg.gs, jpkg.ac, JEngineCoreConfig(**kw))
        assert core._page_nbytes_stack() == jcore._page_nbytes_stack() > 0
        assert core._n_pages == jcore._n_pages
        assert core.kv_stats() == jcore.kv_stats()


@pytest.mark.parametrize("kw", [
    pytest.param({"prefill_chunk": 8}, id="prefill_chunk"),
    pytest.param({"spec_gamma": 1}, id="spec_gamma"),
    pytest.param({"mesh": True}, id="mesh"),
])
def test_engine_core_refuses_a_hymba_tier(system, kw):
    """Chunked prefill, speculative decoding and a mesh refuse a Hymba tier
    with the JAX engine's ValueError, in both packages."""
    from repro_torch.launch.mesh import make_host_mesh
    for side in ("port", "jax"):
        pkg = system[side]
        draft = pkg.gs if kw.get("spec_gamma") else None
        args = dict(kw)
        if args.get("mesh"):
            args["mesh"] = (make_host_mesh(model=1, data=1, devices=["cpu"])
                            if side == "port" else jax.sharding.Mesh(
                                np.asarray(jax.devices()[:1]).reshape(1, 1),
                                ("data", "model")))
        with pytest.raises(ValueError, match="attention-only stacks"):
            pkg.Core(pkg.gs, pkg.ac, pkg.CoreConfig(**args), draft=draft)
