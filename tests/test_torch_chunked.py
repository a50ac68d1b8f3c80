"""The port's chunked prefill against the JAX package's.

Kernel, model and engine, on the CPU, float32, matmul precision pinned:
the same numpy inputs (and bridged init-only proxy weights) go through
both packages.  The port's ``ops`` take the plain versions on the CPU; the
JAX side runs its Pallas kernel in interpret mode and its oracle.
Tolerances: attention 5e-5 absolute (float32 sums in another order); model
logits 1e-4 absolute and relative (four layers of float32 matmuls), written
KV 1e-5.  Engine tokens, scheduler and page counters must be equal.
"""
import dataclasses
import functools

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
from repro.kernels import ops as jops  # noqa: E402
from repro.models import frontends as JF  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import EngineCore as JEngineCore  # noqa: E402
from repro.serving import EngineCoreConfig as JEngineCoreConfig  # noqa: E402
from repro.serving import InferenceEngine as JInferenceEngine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.base import MAMBA, BlockSpec  # noqa: E402
from repro_torch.configs.spaceverse_pair import proxy_pair  # noqa: E402
from repro_torch.core import eo_adapter as EO  # noqa: E402
from repro_torch.core.cascade import TierModel  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import frontends as TF  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serving import (EngineConfig, EngineCore,  # noqa: E402
                                 EngineCoreConfig, InferenceEngine, Request)
from repro_torch.serving import kv_pool as tkv  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

TOL = 5e-5
ANSWER_VOCAB = 9
SLOTS = 3
TASKS = ["det", "vqa", "cls", "vqa", "det", "vqa", "cls", "vqa", "det",
         "vqa"]
SCHED = ("steps", "fused_steps", "decode_tokens", "prompt_tokens",
         "chunk_tokens", "scheduled_tokens", "stall_steps", "budget",
         "step_log")
COUNTERS = ("prefix_hits", "prefix_misses", "prefill_tokens",
            "prefill_by_kind", "mid_stream_refills", "admitted", "finished")
PAGES = ("pages_in_use", "n_pages", "prefix_entries", "prefix_shared_pages",
         "prefix_hit_rate", "kv_bytes_per_slot")
SPEC = ("steps", "verify_only_steps", "slot_steps", "drafted", "accepted",
        "committed", "emitted", "piggybacked")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# kernel: paged prefix-append attention
# ---------------------------------------------------------------------------

def _block_tables(rng, b, n_logical, n_pages, n_shared):
    """Tables whose first ``n_shared`` entries alias the same pages (a
    shared prefix) and whose tail pages are row-private."""
    bt = np.zeros((b, n_logical), np.int32)
    perm = rng.permutation(np.arange(1, n_pages))
    bt[:, :n_shared] = perm[:n_shared]
    nxt = n_shared
    for r in range(b):
        for c in range(n_shared, n_logical):
            bt[r, c] = perm[nxt]
            nxt += 1
    return bt


KERNEL_SHAPES = [(64, 8, 2, 32, 8, 0, None),      # plain prefix-append
                 (64, 4, 1, 64, 16, 24, None),    # + sliding window
                 (64, 4, 4, 16, 8, 0, None),      # MHA (group 1)
                 (64, 12, 2, 16, 4, 0, 3.0)]      # group 6, softcap


# the JAX oracle, jitted: one compile per shape instead of one per op
_jax_ref = jax.jit(functools.partial(jops.paged_prefill_attention,
                                     impl="ref"),
                   static_argnames=("window", "softcap"))


def _kernel_case(s, h, kh, hd, page, q_len, seed):
    """Rows: idle (0), shorter than the chunk, the chunk alone (a fresh
    stream), mid-prefill, full; shared prefix pages in every row."""
    rng = np.random.default_rng(seed)
    lens = np.asarray([0, max(q_len - 1, 1), q_len, q_len + s // 2, s],
                      np.int32)
    b, n_logical = len(lens), s // page
    n_pages = 1 + 2 + b * n_logical
    kp = rng.standard_normal((n_pages, page, kh, hd)).astype(np.float32)
    vp = rng.standard_normal((n_pages, page, kh, hd)).astype(np.float32)
    q = rng.standard_normal((b, q_len, h, hd)).astype(np.float32)
    bt = _block_tables(rng, b, n_logical, n_pages, n_shared=2)
    return q, kp, vp, bt, lens


def _port_prefill(q, kp, vp, bt, lens, **kw):
    """The port's op on the CPU; checks the pools are unchanged and the
    idle row is exact zeros."""
    tk, tv = _t(kp), _t(vp)
    got = tops.paged_prefill_attention(_t(q), tk, tv, _t(bt), _t(lens), **kw)
    assert float(got[0].abs().max()) == 0.0          # idle row → zeros
    np.testing.assert_array_equal(tk.numpy(), kp)
    np.testing.assert_array_equal(tv.numpy(), vp)
    return got


@pytest.mark.parametrize("q_len", [1, 6, 16])
@pytest.mark.parametrize("s,h,kh,hd,page,window,softcap", KERNEL_SHAPES)
def test_paged_prefill_plain_matches_jax_oracle(s, h, kh, hd, page, window,
                                                softcap, q_len):
    """The port's plain version equals the JAX oracle, and is the
    chunk-causal function of the verify op under its own name."""
    q, kp, vp, bt, lens = _kernel_case(s, h, kh, hd, page, q_len,
                                       q_len + page + hd)
    kw = dict(window=window, softcap=softcap)
    got = _port_prefill(q, kp, vp, bt, lens, **kw)
    want = _jax_ref(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                    jnp.asarray(bt), jnp.asarray(lens), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)
    np.testing.assert_array_equal(
        got.numpy(), tops.paged_multi_decode_attention(
            _t(q), _t(kp), _t(vp), _t(bt), _t(lens), **kw).numpy())


@pytest.mark.parametrize("shape,q_len,q_blk", [
    (0, 1, 8), (0, 4, 2), (0, 16, 4), (0, 6, 4),     # 6 % 4: a short tail
    (1, 8, 8), (2, 16, 4), (3, 6, 4)])
def test_paged_prefill_plain_matches_jax_kernel(shape, q_len, q_blk):
    """The JAX Pallas kernel in interpret mode, its query-chunk axis tiled
    in q_blk sub-blocks (the function does not depend on the tiling)."""
    s, h, kh, hd, page, window, softcap = KERNEL_SHAPES[shape]
    q, kp, vp, bt, lens = _kernel_case(s, h, kh, hd, page, q_len,
                                       100 + q_len + q_blk)
    kw = dict(window=window, softcap=softcap)
    got = _port_prefill(q, kp, vp, bt, lens, **kw)
    want = jops.paged_prefill_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(lens), q_blk=q_blk, impl="pallas_interpret", **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)


# ---------------------------------------------------------------------------
# model: embed_chunk, prefill_chunk_step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiers():
    """Init-only proxy adapters of both packages, the port's bridged from
    the JAX ones: (JAX satellite, JAX ground, port satellite, port ground,
    JAX adapter config, port adapter config)."""
    jsat_cfg, jgs_cfg = jproxy_pair("small")
    sat_cfg, gs_cfg = proxy_pair("small")
    jac, ac = JEO.EOAdapterConfig(), EO.EOAdapterConfig()
    jsat = JEO.init_adapter(jax.random.PRNGKey(0), jsat_cfg, jac)
    jgs = JEO.init_adapter(jax.random.PRNGKey(1), jgs_cfg, jac)

    def carry(tree):
        return bridge.from_numpy(jax.tree.map(np.asarray, tree),
                                 device="cpu")

    return (JTierModel(jsat, jsat_cfg), JTierModel(jgs, jgs_cfg),
            TierModel(carry(jsat), sat_cfg), TierModel(carry(jgs), gs_cfg),
            jac, ac)


@pytest.mark.parametrize("mask", [None, [True, False, True],
                                  [False, False, False]])
def test_embed_chunk_matches_jax(tiers, mask):
    _, jgs, _, gs, _, _ = tiers
    rng = np.random.default_rng(1)
    b, c, d = 3, 5, gs.cfg.d_model
    toks = rng.integers(0, gs.cfg.vocab_size, (b, c)).astype(np.int32)
    index = np.asarray([0, 11, 16], np.int32)
    jin, tin = {"tokens": jnp.asarray(toks)}, {"tokens": _t(toks)}
    if mask is not None:
        emb = rng.standard_normal((b, c, d)).astype(np.float32)
        jin.update(patch_embeds=jnp.asarray(emb),
                   patch_mask=jnp.asarray(mask))
        tin.update(patch_embeds=_t(emb), patch_mask=torch.tensor(mask))
    jx, jpos = JF.embed_chunk(jgs.params["backbone"]["embed"], jgs.cfg, jin,
                              jnp.asarray(index))
    tx, tpos = TF.embed_chunk(gs.params["backbone"]["embed"], gs.cfg, tin,
                              _t(index))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))


# the JAX step, jitted: its eager op-by-op dispatch would dominate the file
_jax_chunk_step = jax.jit(JT.prefill_chunk_step, static_argnums=(1,))


def _paged_setup(cfg, b, max_len, page=8):
    pages_per = -(-max_len // page)
    n_pages = 1 + b * pages_per
    table = np.arange(1, 1 + b * pages_per).reshape(b, pages_per)
    return n_pages, table.astype(np.int32)


def _leaves(cache):
    return [x for d in cache for _, x in sorted(d.items())]


@pytest.mark.parametrize("chunk", [4, 7, 16])
def test_prefill_chunk_chain_matches_prefill_and_jax(tiers, chunk):
    """[regions | prompt] streamed through C-token steps lands where one
    ``prefill`` lands (logits), and writes the JAX chain's KV."""
    _, jgs, _, gs, jac, ac = tiers
    cfg, bb, jbb = gs.cfg, gs.params["backbone"], jgs.params["backbone"]
    b, r = 2, ac.n_regions
    max_len = r + 1 + 4
    imgs = np.random.default_rng(0).random(
        (b, ac.image_size, ac.image_size, ac.channels)).astype(np.float32)
    ptok = np.asarray([3, 5], np.int32)
    want, _, _ = EO.prefill_tokens(gs.params, cfg, ac, _t(imgs), _t(ptok),
                                   max_len)
    n_pages, table = _paged_setup(cfg, b, max_len)
    tcache = TT.init_paged_cache(cfg, b, n_pages, 8, "cpu")
    jcache = JT.init_paged_cache(jgs.cfg, b, n_pages, 8)
    emb = EO.encode_regions(gs.params, ac, _t(imgs)).numpy()
    steps = []
    for off in range(0, r, chunk):
        c = min(chunk, r - off)
        feed = np.zeros((b, chunk, cfg.d_model), np.float32)
        feed[:, :c] = emb[:, off:off + c]
        steps.append((np.zeros((b, chunk), np.int32), feed, True, off, c))
    toks = np.zeros((b, chunk), np.int32)
    toks[:, 0] = ptok
    steps.append((toks, np.zeros((b, chunk, cfg.d_model), np.float32),
                  False, r, 1))
    for toks, feed, is_patch, off, c in steps:
        index, lens = np.full((b,), off, np.int32), np.full((b,), c,
                                                             np.int32)
        mask = np.full((b,), is_patch)
        logits, tcache = TT.prefill_chunk_step(
            bb, cfg, tcache, {"tokens": _t(toks), "patch_embeds": _t(feed),
                              "patch_mask": _t(mask)},
            _t(index), block_table=_t(table), chunk_lens=_t(lens))
        _, jcache = _jax_chunk_step(
            jbb, jgs.cfg, jcache,
            {"tokens": jnp.asarray(toks), "patch_embeds": jnp.asarray(feed),
             "patch_mask": jnp.asarray(mask)},
            jnp.asarray(index), block_table=jnp.asarray(table),
            chunk_lens=jnp.asarray(lens))
    np.testing.assert_allclose(logits.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)
    # page 0 is the trash page: the port's padding writes land there, the
    # JAX package's are dropped
    for t_leaf, j_leaf in zip(_leaves(tcache), jax.tree.leaves(jcache)):
        np.testing.assert_allclose(t_leaf.numpy()[:, 1:],
                                   np.asarray(j_leaf)[:, 1:], rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("paged", [True, False])
def test_prefill_chunk_ragged_rows_match_jax(tiers, paged):
    """One call with rows of C, 1, a partial chunk and 0 valid tokens, over
    a cache holding a committed prefix: logits at each row's last valid
    token and the written KV equal JAX's, and no padding write lands
    anywhere JAX's does not write (paged: the rows share prefix pages,
    which must stay byte-equal; the port's padding goes to the trash page,
    JAX's out of bounds)."""
    _, jgs, _, gs, _, _ = tiers
    cfg, bb, jbb = gs.cfg, gs.params["backbone"], jgs.params["backbone"]
    rng = np.random.default_rng(11)
    b, c, page, width = 4, 8, 4, 8
    index = np.asarray([8, 16, 9, 0], np.int32)
    lens = np.asarray([c, 1, 5, 0], np.int32)
    toks = rng.integers(0, cfg.vocab_size, (b, c)).astype(np.int32)
    feed = rng.standard_normal((b, c, cfg.d_model)).astype(np.float32)
    mask = np.asarray([True, False, True, False])
    kv_shape = (cfg.num_kv_heads, cfg.resolved_head_dim)
    if paged:
        n_pages = 1 + 2 + b * (width - 2)
        table = np.zeros((b, width), np.int32)
        table[:, :2] = [1, 2]                          # shared prefix pages
        table[:, 2:] = 3 + np.arange(b * (width - 2)).reshape(b, -1)
        shape = (cfg.n_super, n_pages, page) + kv_shape
    else:
        table = None
        shape = (cfg.n_super, b, page * width) + kv_shape
    np_cache = [{"k": rng.standard_normal(shape).astype(np.float32),
                 "v": rng.standard_normal(shape).astype(np.float32)}
                for _ in cfg.block_pattern]
    tcache = tuple({k: _t(v.copy()) for k, v in d.items()} for d in np_cache)
    jcache = tuple({k: jnp.asarray(v) for k, v in d.items()}
                   for d in np_cache)
    kw_t = {"block_table": _t(table)} if paged else {}
    kw_j = {"block_table": jnp.asarray(table)} if paged else {}
    tl, tcache = TT.prefill_chunk_step(
        bb, cfg, tcache, {"tokens": _t(toks), "patch_embeds": _t(feed),
                          "patch_mask": _t(mask)},
        _t(index), chunk_lens=_t(lens), **kw_t)
    jl, jcache = _jax_chunk_step(
        jbb, jgs.cfg, jcache,
        {"tokens": jnp.asarray(toks), "patch_embeds": jnp.asarray(feed),
         "patch_mask": jnp.asarray(mask)},
        jnp.asarray(index), chunk_lens=jnp.asarray(lens), **kw_j)
    live = lens > 0                     # idle rows' logits are dropped
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                               rtol=1e-4, atol=1e-4)
    keep = slice(1, None) if paged else slice(None)  # the trash page aside
    for t_leaf, j_leaf, np_leaf in zip(_leaves(tcache),
                                       jax.tree.leaves(jcache),
                                       [x for d in np_cache
                                        for _, x in sorted(d.items())]):
        np.testing.assert_allclose(t_leaf.numpy()[:, keep],
                                   np.asarray(j_leaf)[:, keep], rtol=0,
                                   atol=1e-5)
        if paged:
            np.testing.assert_array_equal(t_leaf.numpy()[:, 1:3],
                                          np_leaf[:, 1:3])


def test_prefill_append_refuses_recurrent_blocks(tiers):
    """The model-level backstop of the JAX package: chunk boundaries are
    bit-stable only for attention KV appends."""
    gs = tiers[3]
    with pytest.raises(NotImplementedError, match="prefill_append"):
        TT._check_block(BlockSpec(kind=MAMBA), "prefill_append")
    assert TL.TRASH_PAGE == tkv.TRASH_PAGE
    TT._check_block(gs.cfg.block_pattern[0], "prefill_append")


# ---------------------------------------------------------------------------
# engine: the chunked engines of both packages on one stream
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stream():
    out = []                         # (task, image, prompt, scene)
    for i, task in enumerate(TASKS):
        scene = i % 3
        data = synthetic.make_dataset(task, 1, seed=scene)
        out.append((task, data["images"][0], int(data["prompts"][0]),
                    scene))
    return out


def _requests(cls, stream, drafts=None):
    return [cls(task=t, image=im, prompt=p, scene_id=s,
                draft_tokens=None if drafts is None else drafts[i])
            for i, (t, im, p, s) in enumerate(stream)]


def _serve_both(tiers, stream, drafts=None, **kw):
    """(port engine, port tokens, JAX engine, JAX tokens) by stream order."""
    jsat, jgs, sat, gs, jac, ac = tiers
    spec = kw.get("spec_gamma")
    port = InferenceEngine(gs.params, gs.cfg, ac,
                           EngineConfig(slots=SLOTS,
                                        answer_vocab=ANSWER_VOCAB, **kw),
                           draft=sat if spec else None, device="cpu")
    port.warmup()
    jeng = JInferenceEngine(jgs.params, jgs.cfg, jac,
                            JEngineConfig(slots=SLOTS,
                                          answer_vocab=ANSWER_VOCAB, **kw),
                            draft=jsat if spec else None)
    out = []
    for eng, cls in ((port, Request), (jeng, JRequest)):
        reqs = _requests(cls, stream, drafts)
        by_id = {r.request_id: np.asarray(r.tokens).tolist()
                 for r in eng.serve(reqs)}
        out += [eng, [by_id[r.request_id] for r in reqs]]
    return out


def _assert_same_engine_state(port, jeng):
    pc, jc = port.core, jeng.core
    for key in COUNTERS:
        assert pc.stats[key] == jc.stats[key], key
    for key in SCHED:
        assert pc.stats["sched"][key] == jc.stats["sched"][key], key
    ps, js = pc.scheduler_stats(), jc.scheduler_stats()
    for key in ("budget_utilization", "tokens_per_step", "prefill_by_kind"):
        assert ps[key] == js[key], key
    pk, jk = pc.kv_stats(), jc.kv_stats()
    for key in PAGES:
        assert pk[key] == jk[key], key
    # drained: only the resident prefixes hold pages
    assert pk["pages_in_use"] == pk["prefix_shared_pages"]


@pytest.fixture(scope="module")
def greedy_tokens(tiers, stream):
    """The port's unchunked paged engine on the stream (the oracle)."""
    _, _, _, gs, _, ac = tiers
    eng = InferenceEngine(gs.params, gs.cfg, ac,
                          EngineConfig(slots=SLOTS,
                                       answer_vocab=ANSWER_VOCAB),
                          device="cpu")
    reqs = _requests(Request, stream)
    by_id = {r.request_id: r.tokens.tolist() for r in eng.serve(reqs)}
    return [by_id[r.request_id] for r in reqs], eng.core.stats


@pytest.mark.parametrize("chunk", [8, 32, "full"])
def test_chunked_engine_matches_jax(tiers, stream, greedy_tokens, chunk):
    """Tokens equal the JAX chunked engine's and the unchunked oracle's;
    scheduler, prefix and page counters equal JAX's; the chunk + prompt
    totals equal the oracle's prefix + prompt; no fused step exceeds the
    budget and every decoding slot gets its token in every one."""
    chunk = tiers[5].n_regions if chunk == "full" else chunk
    port, got, jeng, want = _serve_both(tiers, stream, prefill_chunk=chunk)
    assert got == want == greedy_tokens[0]
    _assert_same_engine_state(port, jeng)
    st, base = port.core.stats, greedy_tokens[1]
    assert st["prefill_by_kind"]["chunk"] == base["prefill_by_kind"]["prefix"]
    assert st["prefill_by_kind"]["prompt"] == \
        base["prefill_by_kind"]["prompt"]
    sched = port.core.scheduler_stats()
    assert sched["fused_steps"] > 0 and sched["stall_steps"] == 0
    assert all(sum(e) <= sched["budget"] for e in st["sched"]["step_log"])


@pytest.mark.parametrize("chunk", [8, "full"])
def test_chunked_engine_with_the_tile_plan_matches_jax(tiers, stream,
                                                       greedy_tokens, chunk,
                                                       monkeypatch):
    """Every fused step threads its tile plan to the prefix-append op.
    With the op scoring the plan's row tiles as the tensor-core kernel
    does (each entry's rows through its first row's table row, each row at
    its own cache_len) and leaving the rows in no tile NaN (the padding
    rows the kernel does not write), tokens and every counter still equal
    the JAX chunked engine's and the unchunked oracle's."""
    plain, plans = tops.paged_prefill_attention, []

    def tiled(q, k_pool, v_pool, block_table, cache_len, *, plan=None,
              **kw):
        assert plan is not None and q.shape[1] == 1
        plans.append(plan.clone())
        o = torch.full_like(q, float("nan"))
        for j0, n in plan.T.tolist():
            if n:
                o[j0:j0 + n] = plain(q[j0:j0 + n], k_pool, v_pool,
                                     block_table[j0].expand(n, -1),
                                     cache_len[j0:j0 + n], **kw)
        return o

    monkeypatch.setattr(tops, "paged_prefill_attention", tiled)
    chunk = tiers[5].n_regions if chunk == "full" else chunk
    port, got, jeng, want = _serve_both(tiers, stream, prefill_chunk=chunk)
    assert got == want == greedy_tokens[0]
    _assert_same_engine_state(port, jeng)
    # the streams' chunk runs shared row tiles
    assert plans and max(int(p[1].max()) for p in plans) > 1


def test_chunked_spec_engine_matches_jax(tiers, stream, greedy_tokens):
    """Chunked + γ 3 speculative engines, with perfect piggybacked drafts on
    the first slots' worth of requests: tokens are the greedy ones and
    ``spec_stats()`` and every counter equal JAX's."""
    toks = greedy_tokens[0]
    drafts = [list(t) if i < SLOTS else None for i, t in enumerate(toks)]
    port, got, jeng, want = _serve_both(tiers, stream, drafts,
                                        prefill_chunk=8, spec_gamma=3)
    assert got == want == toks
    _assert_same_engine_state(port, jeng)
    ps, js = port.core.spec_stats(), jeng.core.spec_stats()
    for key in SPEC:
        assert ps[key] == js[key], key
    assert ps["steps"] > 0 and ps["verify_only_steps"] > 0
    assert port.core.stats["prefill_by_kind"]["draft"] > 0


def test_chunked_spec_drafter_tracks_fused_commits(tiers, stream):
    """token_budget 7, γ 2, chunk 4 on two slots: a det request decodes,
    then a second scene streams while it keeps decoding through fused
    steps.  Its committed tokens reach the drafter's cache (no zero-KV
    gap), and tokens and counters equal the JAX engine's."""
    jsat, jgs, sat, gs, jac, ac = tiers
    kw = dict(slots=2, answer_vocab=ANSWER_VOCAB, spec_gamma=2,
              prefill_chunk=4, token_budget=7)
    port = EngineCore(gs, ac, EngineCoreConfig(**kw), draft=sat)
    jcore = JEngineCore(jgs, jac, JEngineCoreConfig(**kw), draft=jsat)
    (t0, im0, p0, _), (t1, im1, p1, _) = stream[0], stream[1]
    logs = []
    for core, cls in ((port, Request), (jcore, JRequest)):
        def busy():
            return any(s.active and s.phase != "decode" for s in core._slots)
        core.admit_many([cls(task="det", image=im0, prompt=p0)])
        while busy():
            core.step()
        core.step()                                  # one spec step
        core.admit_many([cls(task="det", image=im1, prompt=p1)])
        committed = len(core._slots[0].tokens)
        while busy():
            core.step()                              # fused: slot 0 decodes
        assert len(core._slots[0].tokens) > committed
        logs.append([list(s.tokens) for s in core._slots])
    assert logs[0] == logs[1]
    for key in SPEC:
        assert port.spec_stats()[key] == jcore.spec_stats()[key], key
    assert port.stats["sched"]["step_log"] == jcore.stats["sched"]["step_log"]
    kv = port._draft_cache[0]["k"]             # (n_super, B, max_len, ...)
    r = ac.n_regions
    for t in range(len(port._slots[0].tokens)):
        assert float(kv[:, 0, r + 1 + t].abs().max()) > 0, t


def test_chunked_prefix_pages_stay_shared(tiers, stream):
    """Fan-out over one scene: one stream, two hits; the published pages
    stay byte-equal while the queries decode over them."""
    _, _, _, gs, _, ac = tiers
    core = EngineCore(gs, ac, EngineCoreConfig(slots=4, prefill_chunk=8,
                                               answer_vocab=ANSWER_VOCAB))
    _, img, prompt, _ = stream[0]
    core.admit_many([Request(task=t, image=img, prompt=prompt)
                     for t in ("det", "vqa", "cls")])
    assert (core.stats["prefix_misses"], core.stats["prefix_hits"]) == (1, 2)
    assert [s.phase for s in core._slots[:3]] == ["prefill", "wait", "wait"]
    while any(s.active and s.phase != "decode" for s in core._slots):
        core.step()
    pages = torch.tensor(core._prefix.get(core._slots[0].scene).pages)
    before = [{k: v[:, pages].clone() for k, v in d.items()}
              for d in core._slot_cache]
    for _ in range(3):
        core.step()
    for b, d in zip(before, core._slot_cache):
        for k in b:
            assert torch.equal(b[k], d[k][:, pages]), k
    assert core.stats["prefill_by_kind"]["chunk"] == ac.n_regions


def _recurrent(tier):
    cfg = dataclasses.replace(
        tier.cfg, block_pattern=tier.cfg.block_pattern + (BlockSpec(
            kind=MAMBA),))
    return TierModel(tier.params, cfg)


@pytest.mark.parametrize("kw", [
    {"prefill_chunk": 8, "cache_impl": "dense"},
    {"prefill_chunk": 8, "step_impl": "vmap"},
    {"slots": 4, "prefill_chunk": 8, "token_budget": 4},
    {"prefill_chunk": -1},
    {"prefill_chunk": 8, "recurrent": True},
])
def test_chunked_config_validation_matches_jax(tiers, kw):
    """The configs the JAX engine refuses, refused with its exception
    types."""
    jsat, jgs, sat, gs, jac, ac = tiers
    kw = dict(kw)
    recurrent = kw.pop("recurrent", False)
    errors = []
    for tier, core_cls, cfg_cls, adapter in (
            (gs, EngineCore, EngineCoreConfig, ac),
            (jgs, JEngineCore, JEngineCoreConfig, jac)):
        if recurrent:
            tier = _recurrent(tier) if tier is gs else JTierModel(
                tier.params, dataclasses.replace(
                    tier.cfg, block_pattern=tier.cfg.block_pattern
                    + (type(tier.cfg.block_pattern[0])(kind="mamba"),)))
        with pytest.raises(Exception) as info:
            core_cls(tier, adapter, cfg_cls(**kw))
        errors.append(type(info.value))
    assert errors[0] is errors[1] is ValueError


def test_chunked_config_is_ported():
    for cfg_cls in (EngineConfig, EngineCoreConfig):
        cfg = cfg_cls(prefill_chunk=8, token_budget=12)
        assert (cfg.prefill_chunk, cfg.token_budget) == (8, 12)
