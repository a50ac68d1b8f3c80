"""The port's paged KV path against the JAX package: kernels, pool, model.

Same numpy inputs through both packages, float32, on the CPU (the port's
``ops`` take the plain versions there; the JAX side runs its oracle and its
Pallas kernel in interpret mode).  Tolerances: attention 5e-5 absolute
(float32 sums taken in another order); model logits 1e-4 absolute and
relative (four layers of float32 matmuls); written KV 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: pytest's workers share the cores, and torch's
# default of a thread a core in each worker oversubscribes them
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.spaceverse_pair import proxy_pair as jproxy_pair  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import frontends as JF  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving import kv_pool as jkv  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.spaceverse_pair import proxy_pair  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import frontends as TF  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serving import kv_pool as tkv  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

TOL = 5e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def paged_inputs(rng, *, b, kh, group, hd, page, q_len, lens,
                 shared_tokens=16, width_tokens=48):
    """Pools with a trash page 0, shared prefix pages mapped into every row
    that reaches them, private pages after, trash entries past each row's
    length."""
    width = -(-width_tokens // page)
    n_sh = shared_tokens // page
    need = [-(-n // page) for n in lens]
    n_pages = 1 + n_sh + sum(max(n - n_sh, 0) for n in need)
    table = np.zeros((b, width), np.int32)
    nxt = 1 + n_sh
    for r, n in enumerate(need):
        for j in range(n):
            if j < n_sh:
                table[r, j] = 1 + j
            else:
                table[r, j] = nxt
                nxt += 1
    kp = rng.standard_normal((n_pages, page, kh, hd)).astype(np.float32)
    vp = rng.standard_normal((n_pages, page, kh, hd)).astype(np.float32)
    q = rng.standard_normal((b, q_len, kh * group, hd)).astype(np.float32)
    return q, kp, vp, table, np.asarray(lens, np.int32)


PAGED_CASES = [(page, group, q_len, 0, None)
               for page in (1, 4, 8) for group in (1, 3) for q_len in (1, 3)]
PAGED_CASES += [(8, 3, 3, 5, None), (4, 1, 1, 0, 2.5), (1, 3, 3, 7, 3.0)]


@pytest.mark.parametrize("page,group,q_len,window,softcap", PAGED_CASES)
def test_paged_plain_matches_jax(page, group, q_len, window, softcap):
    """cache_len 0 and 0 < cache_len < q_len rows included; shared pages in
    several rows; trash entries past each row's length."""
    rng = np.random.default_rng(page * 100 + group * 10 + q_len + window)
    q, kp, vp, table, lens = paged_inputs(
        rng, b=5, kh=2, group=group, hd=16, page=page, q_len=q_len,
        lens=[0, 1, 2, 30, 47])
    kw = dict(window=window, softcap=softcap)
    jargs = (jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
             jnp.asarray(lens))
    targs = (_t(kp), _t(vp), _t(table), _t(lens))
    if q_len == 1:
        got = tops.paged_decode_attention(_t(q[:, 0]), *targs, **kw)
        want_ref = jref.paged_decode_attention(jnp.asarray(q[:, 0]), *jargs,
                                               **kw)
        want_kernel = jops.paged_decode_attention(
            jnp.asarray(q[:, 0]), *jargs, impl="pallas_interpret", **kw)
    else:
        got = tops.paged_multi_decode_attention(_t(q), *targs, **kw)
        want_ref = jref.paged_multi_decode_attention(jnp.asarray(q), *jargs,
                                                     **kw)
        want_kernel = jops.paged_multi_decode_attention(
            jnp.asarray(q), *jargs, impl="pallas_interpret", **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_kernel), rtol=0,
                               atol=TOL)
    assert float(got[0].abs().max()) == 0.0          # cache_len 0 → zeros


@pytest.mark.parametrize("op,page,group,q_len,window,softcap", [
    ("decode", 8, 4, 1, 0, None), ("decode", 4, 1, 3, 8, None),
    ("decode", 1, 4, 3, 0, 3.0), ("prefill", 8, 4, 4, 8, None),
    ("prefill", 4, 1, 5, 0, 2.5)])
def test_paged_plain_matches_jax_at_hd256(op, page, group, q_len, window,
                                          softcap):
    """gemma3-1b's head dim 256 (groups 4 and 1): the paged decode and
    prefix-append plain versions against JAX's oracle and interpret-mode
    Pallas kernel; rows of length 0, below the chunk and past the window;
    shared pages in several rows."""
    rng = np.random.default_rng(page * 100 + group * 10 + q_len + window)
    q, kp, vp, table, lens = paged_inputs(
        rng, b=5, kh=1 if group == 4 else 2, group=group, hd=256, page=page,
        q_len=q_len, lens=[0, 1, 2, 30, 47])
    kw = dict(window=window, softcap=softcap)
    jargs = (jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
             jnp.asarray(lens))
    targs = (_t(kp), _t(vp), _t(table), _t(lens))
    if op == "prefill":
        got = tops.paged_prefill_attention(_t(q), *targs, **kw)
        want_ref = jref.paged_prefill_attention(jnp.asarray(q), *jargs, **kw)
        want_kernel = jops.paged_prefill_attention(
            jnp.asarray(q), *jargs, impl="pallas_interpret", **kw)
    elif q_len == 1:
        got = tops.paged_decode_attention(_t(q[:, 0]), *targs, **kw)
        want_ref = jref.paged_decode_attention(jnp.asarray(q[:, 0]), *jargs,
                                               **kw)
        want_kernel = jops.paged_decode_attention(
            jnp.asarray(q[:, 0]), *jargs, impl="pallas_interpret", **kw)
    else:
        got = tops.paged_multi_decode_attention(_t(q), *targs, **kw)
        want_ref = jref.paged_multi_decode_attention(jnp.asarray(q), *jargs,
                                                     **kw)
        want_kernel = jops.paged_multi_decode_attention(
            jnp.asarray(q), *jargs, impl="pallas_interpret", **kw)
    for want in (want_ref, want_kernel):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=TOL)
    assert float(got[0].abs().max()) == 0.0          # cache_len 0 → zeros


def test_gather_pages_matches_jax():
    rng = np.random.default_rng(3)
    pool = rng.standard_normal((9, 4, 2, 5)).astype(np.float32)
    table = rng.integers(0, 9, (3, 6)).astype(np.int32)
    np.testing.assert_array_equal(
        tref.gather_pages(_t(pool), _t(table)).numpy(),
        np.asarray(jref.gather_pages(jnp.asarray(pool), jnp.asarray(table))))


# ---------------------------------------------------------------------------
# the host-side page allocator and prefix cache
# ---------------------------------------------------------------------------

def _pool_state(pool, cache):
    return (pool.free_pages, pool.pages_in_use,
            [pool.refcount(p) for p in range(pool.n_pages)], cache.stats(),
            [(e.scene, e.pages, e.users)
             for e in (cache.get(s) for s in list(cache._entries))])


def _apply(op, draw, pool, cache, held):
    n, sc, pick, need_p, need_e = draw
    try:
        if op == 0:
            return pool.alloc(n)
        if op == 1 and held:
            pool.free(held[-1])
            return "freed"
        if op == 2:
            cache.put(f"s{sc}", pool.alloc(3), None)
            return "put"
        names = list(cache._entries)
        if op == 3 and names:
            return cache.acquire(names[pick % len(names)]).scene
        if op == 4 and names:
            cache.release(names[pick % len(names)])
            return "released"
        cache.evict_for(need_p, need_entries=need_e)
        return "evicted"
    except (MemoryError, ValueError) as e:
        return type(e).__name__


def test_kv_pool_and_prefix_cache_match_jax_on_a_random_op_sequence():
    """One seeded sequence of allocs, frees, puts, acquires, releases and
    evictions (including ones that fail) through both packages' pools:
    the same results, state and errors after every operation."""
    rng = np.random.default_rng(11)
    pools = [m.KVPagePool(40, 8) for m in (jkv, tkv)]
    caches = [m.PrefixCache(p, capacity=5) for m, p in zip((jkv, tkv), pools)]
    held, outcomes = [], set()
    for step in range(400):
        op = int(rng.integers(0, 6))
        draw = (int(rng.integers(0, 6)), int(rng.integers(0, 8)),
                int(rng.integers(0, 100)), int(rng.integers(0, 30)),
                int(rng.integers(0, 3)))
        outs = [_apply(op, draw, pool, cache, held)
                for pool, cache in zip(pools, caches)]
        assert outs[0] == outs[1], (step, outs)
        if isinstance(outs[0], list) and outs[0]:
            held.append(outs[0])
        elif outs[0] == "freed":
            held.pop()
        outcomes.add(outs[0] if isinstance(outs[0], str) else "alloc")
        assert _pool_state(pools[0], caches[0]) == \
            _pool_state(pools[1], caches[1]), step
    # every path was reached, the failing ones included
    assert {"MemoryError", "ValueError", "evicted", "put", "freed",
            "released", "alloc"} <= outcomes, outcomes
    assert tkv.TRASH_PAGE == jkv.TRASH_PAGE == 0
    assert tkv.page_nbytes(8, 2, 16, fp_bytes=2) == \
        jkv.page_nbytes(8, 2, 16, fp_bytes=2)


# ---------------------------------------------------------------------------
# the model: paged decode and verify steps on bridged weights
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gs_model():
    _, jcfg = jproxy_pair("small")
    _, cfg = proxy_pair("small")
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(1))
    params = bridge.from_numpy(jax.tree.map(np.asarray, jparams),
                               device="cpu")
    return jcfg, jparams, cfg, params


def _pools(rng, cfg, n_pages, page):
    shape = (cfg.n_super, n_pages, page, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return [{"k": rng.standard_normal(shape).astype(np.float32),
             "v": rng.standard_normal(shape).astype(np.float32)}
            for _ in cfg.block_pattern]


def _both_caches(np_cache):
    jc = tuple({k: jnp.asarray(v) for k, v in d.items()} for d in np_cache)
    tc = tuple({k: _t(v.copy()) for k, v in d.items()} for d in np_cache)
    return jc, tc


def _close_caches(tc, jc, tol=1e-5):
    for td, jd in zip(tc, jc):
        for k in td:
            np.testing.assert_allclose(td[k].numpy(), np.asarray(jd[k]),
                                       rtol=0, atol=tol)


def _table(rng, b, width, n_pages):
    """Rows share page 1..2 (a prefix) and own distinct pages after."""
    table = np.zeros((b, width), np.int32)
    nxt = 3
    for r in range(b):
        table[r, :2] = [1, 2]
        for j in range(2, width):
            table[r, j] = nxt
            nxt += 1
    assert nxt <= n_pages
    return table


@pytest.mark.parametrize("step", ["decode", "verify"])
def test_paged_steps_match_jax(gs_model, step):
    """``decode_step(block_table=)`` and ``verify_step`` (γ+1 = 4) at
    ragged per-row positions: equal logits and equal pools after the
    in-place writes (positions below each row's index untouched)."""
    jcfg, jparams, cfg, params = gs_model
    rng = np.random.default_rng(5 if step == "decode" else 6)
    b, page, width, n_pages = 3, 4, 8, 40
    t = 1 if step == "decode" else 4
    np_cache = _pools(rng, cfg, n_pages, page)
    table = _table(rng, b, width, n_pages)
    index = np.array([9, 17, 26], np.int32)
    toks = rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    jc, tc = _both_caches(np_cache)
    jfn = JT.decode_step if step == "decode" else JT.verify_step
    tfn = TT.decode_step if step == "decode" else TT.verify_step
    jl, jc2 = jfn(jparams, jcfg, jc, {"tokens": jnp.asarray(toks)},
                  jnp.asarray(index), block_table=jnp.asarray(table))
    tl, tc2 = tfn(params, cfg, tc, {"tokens": _t(toks)}, _t(index),
                  block_table=_t(table))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    assert tc2 is tc                                   # written in place
    _close_caches(tc2, jc2)
    # the shared prefix pages were not written
    for td, d in zip(tc2, np_cache):
        np.testing.assert_array_equal(td["k"][:, 1:3].numpy(),
                                      d["k"][:, 1:3])


def test_dense_verify_matches_jax(gs_model):
    jcfg, jparams, cfg, params = gs_model
    rng = np.random.default_rng(7)
    b, s, t = 3, 40, 3
    shape = (cfg.n_super, b, s, cfg.num_kv_heads, cfg.resolved_head_dim)
    np_cache = [{"k": rng.standard_normal(shape).astype(np.float32),
                 "v": rng.standard_normal(shape).astype(np.float32)}]
    index = np.array([3, 20, 33], np.int32)
    toks = rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    jc, tc = _both_caches(np_cache)
    jl, jc2 = JT.verify_step(jparams, jcfg, jc, {"tokens": jnp.asarray(toks)},
                             jnp.asarray(index))
    tl, tc2 = TT.verify_step(params, cfg, tc, {"tokens": _t(toks)},
                             _t(index))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    _close_caches(tc2, jc2)


def test_chunk_mrope_positions_match_jax(gs_model):
    """A T-token chunk at per-row indices gets the JAX package's M-RoPE
    positions (and a scalar index broadcasts)."""
    jcfg, jparams, cfg, params = gs_model
    toks = np.arange(8, dtype=np.int32).reshape(2, 4)
    for index in (np.array([17, 30], np.int32), np.int32(21)):
        _, jpos = JF.embed_decode(jparams["embed"], jcfg,
                                  {"tokens": jnp.asarray(toks)},
                                  jnp.asarray(index))
        _, tpos = TF.embed_decode(params["embed"], cfg, {"tokens": _t(toks)},
                                  torch.as_tensor(index))
        np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))


def test_paged_cache_layout_matches_jax(gs_model):
    jcfg, _, cfg, _ = gs_model
    jc = JT.init_paged_cache(jcfg, 3, 12, 4)
    tc = TT.init_paged_cache(cfg, 3, 12, 4, "cpu")
    assert [{k: tuple(v.shape) for k, v in d.items()} for d in tc] == \
        [{k: tuple(v.shape) for k, v in d.items()} for d in jc]
    for kind in ("int8", "fp8"):        # the quantized layout is JAX's too
        jq = JT.init_paged_cache(jcfg, 3, 12, 4, kv_dtype=kind)
        tq = TT.init_paged_cache(cfg, 3, 12, 4, "cpu", kv_dtype=kind)
        assert [{k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                 for k, v in d.items()} for d in tq] == \
            [{k: (tuple(v.shape), str(v.dtype)) for k, v in d.items()}
             for d in jq]
    seen = TT.map_cache_kinds(cfg, [tc, tc], kv=lambda a, b: (a is b),
                              state=None)
    assert seen == (True,) * len(cfg.block_pattern)
