"""The port's quantized paged KV (int8 and fp8 e4m3 pools) against the JAX
package's.

Same numpy inputs through both packages, float32, on the CPU.  Four kinds
of check:

- the quantizers: byte-equal to JAX's, values and scales;
- the plain paged versions with scales: within the strategy's ``tol_self``
  (5e-5, float32 sums taken in another order) of JAX's oracle and of its
  interpret-mode Pallas kernel (fp8 with and without the native-fp8 dot),
  and within ``tol_exact`` of the exact fp oracle;
- layout and accounting: cache leaves, ``page_nbytes``, ``pool_bytes``
  sizing and ``kv_stats`` equal to JAX's; the same validation errors;
- the engines (plain paged, speculative γ 3, chunked with chunk 8) at
  int8 and fp8: tokens, counters and ``spec_stats()`` equal to the JAX
  quantized engines'.  The pools after serving: stored values equal or
  one quantization step apart where the two packages' f32 K/V (which
  differ by float32 rounding, as the fp pools' do) straddle a rounding
  boundary; scales within 2^-7 relative of JAX's.  A later layer (and a
  chunked prefill's later chunk) attends to the stored values, so a
  one-step difference upstream moves its K/V, and their row amax, by up to
  about one int8 step of the row amax (1/127); the shares of values one
  step apart and of scales past 1e-5 relative are printed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: pytest's workers share the cores, and torch's
# default of a thread a core in each worker oversubscribes them
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.configs.spaceverse_pair import proxy_pair as jproxy_pair  # noqa: E402
from repro.core import eo_adapter as JEO  # noqa: E402
from repro.core.cascade import TierModel as JTierModel  # noqa: E402
from repro.kernels import kv_quant as jq  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import EngineCore as JEngineCore  # noqa: E402
from repro.serving import EngineCoreConfig as JEngineCoreConfig  # noqa: E402
from repro.serving import InferenceEngine as JInferenceEngine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import kv_pool as jkv  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.spaceverse_pair import proxy_pair  # noqa: E402
from repro_torch.core import eo_adapter as EO  # noqa: E402
from repro_torch.core.cascade import TierModel  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels import kv_quant as tq  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serving import (EngineConfig, EngineCore,  # noqa: E402
                                 EngineCoreConfig, InferenceEngine, Request)
from repro_torch.serving import kv_pool as tkv  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

KV_DTYPES = ("int8", "fp8")
ANSWER_VOCAB = 9
SLOTS = 3
COUNTERS = ("prefix_hits", "prefix_misses", "prefill_tokens",
            "mid_stream_refills", "admitted", "finished")
SPEC_COUNTERS = ("steps", "verify_only_steps", "slot_steps", "drafted",
                 "accepted", "committed", "emitted", "piggybacked")
KV_STATS = ("kv_bytes_total", "kv_scale_bytes", "kv_dtype", "page_bytes",
            "n_pages", "page_size", "pages_in_use", "prefix_entries",
            "prefix_shared_pages", "kv_bytes_per_slot")
TASKS = ["det", "vqa", "cls", "vqa", "det", "vqa", "cls"]
SCALE_RTOL = 2.0 ** -7


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bytes(x):
    """Stored bytes of a quantized leaf (torch or numpy) as uint8."""
    if isinstance(x, torch.Tensor):
        x = bridge.to_numpy(x)
    x = np.asarray(x)
    return x.view(np.uint8) if x.dtype.itemsize == 1 else x


# ---------------------------------------------------------------------------
# the quantizers, byte for byte
# ---------------------------------------------------------------------------

_BASE = np.asarray([[1.0, -0.5, 0.25, 0.125, -1.0, 0.75, 0.3, -0.06]],
                   np.float32)
QUANT_INPUTS = {
    "gaussian": lambda r: r.standard_normal((6, 5, 2, 32)).astype(
        np.float32) * 3,
    "wide_range": lambda r: (r.standard_normal((400, 64)) * np.exp(
        r.standard_normal((400, 1)) * 8)).astype(np.float32),
    "zero_rows": lambda r: np.zeros((3, 8), np.float32),
    "past_448": lambda r: np.asarray(
        [[1e4, -1e4, 3.0, -2.5, 0.5, 1e-3, 7.0, -448.0]], np.float32),
    "tiny": lambda r: _BASE * np.float32(1e-20),
    "subnormal": lambda r: _BASE * np.float32(1e-40),
    "ties": lambda r: np.asarray([[127.0, 0.5, 1.5, -2.5, 63.5, -0.5, 3.5,
                                   100.5]], np.float32),
}


@pytest.mark.parametrize("kind", KV_DTYPES)
@pytest.mark.parametrize("name", sorted(QUANT_INPUTS))
def test_quantizer_bytes_equal_jax(kind, name):
    x = QUANT_INPUTS[name](np.random.default_rng(7))
    jfn = {"int8": jq.quantize_kv, "fp8": jq.quantize_kv_fp8}[kind]
    tfn = {"int8": tq.quantize_kv, "fp8": tq.quantize_kv_fp8}[kind]
    jv, js = jfn(jnp.asarray(x))
    tv, ts = tfn(_t(x))
    np.testing.assert_array_equal(_bytes(tv), _bytes(jv))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32),
                                  np.asarray(js).view(np.uint32))
    back = tq.dequantize_kv(tv, ts).numpy()
    np.testing.assert_array_equal(back, np.asarray(jq.dequantize_kv(jv, js)))
    assert np.isfinite(back).all()


@pytest.mark.parametrize("kind", KV_DTYPES)
def test_quantizer_rows_are_local(kind):
    """Quantizing token by token stores the bytes quantizing the whole
    tensor stores: the property behind chunked == unchunked and free
    speculative rollback."""
    x = _t(np.random.default_rng(3).standard_normal((6, 2, 16)).astype(
        np.float32))
    fn = {"int8": tq.quantize_kv, "fp8": tq.quantize_kv_fp8}[kind]
    q_all, s_all = fn(x)
    for i in range(x.shape[0]):
        q_i, s_i = fn(x[i:i + 1])
        assert torch.equal(q_i.view(torch.uint8), q_all[i:i + 1].view(
            torch.uint8))
        assert torch.equal(s_i, s_all[i:i + 1])


def test_quantize_as_dispatch_and_strategies():
    x = np.random.default_rng(1).standard_normal((4, 2, 16)).astype(
        np.float32)
    for tdt, jdt in ((torch.int8, jnp.int8),
                     (torch.float8_e4m3fn, jq.FP8_DTYPE)):
        tv, ts = tq.quantize_kv_as(_t(x), tdt)
        jv, js = jq.quantize_kv_as(jnp.asarray(x), jdt)
        np.testing.assert_array_equal(_bytes(tv), _bytes(jv))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    with pytest.raises(ValueError, match="no KV quantizer"):
        tq.quantize_kv_as(_t(x), torch.float16)
    assert (tq.Q_MAX, tq.FP8_MAX) == (jq.Q_MAX, jq.FP8_MAX)
    for name, st in jq.STRATEGIES.items():
        mine = tq.get_strategy(name)
        assert (mine.name, mine.kv_dtype, mine.tol_self, mine.tol_exact) == \
            (st.name, st.kv_dtype, st.tol_self, st.tol_exact)
        assert tq.for_kv_dtype(st.kv_dtype).name == name
    for bad in (tq.get_strategy, tq.for_kv_dtype):
        with pytest.raises(ValueError):
            bad("int4")
    pools = tq.get_strategy("fp8").make_pools(torch.ones((2, 4, 1, 8)),
                                              torch.ones((2, 4, 1, 8)))
    assert pools["k"].dtype == torch.float8_e4m3fn
    assert set(tq.get_strategy("fp8").scale_kwargs(pools)) == {"k_scale",
                                                               "v_scale"}
    assert tq.get_strategy("exact").scale_kwargs(
        tq.get_strategy("exact").make_pools(torch.ones(1), torch.ones(1))) \
        == {}


def test_compare_outputs_matches_jax():
    rng = np.random.default_rng(0)
    want = {i: rng.integers(0, 9, 5 + i) for i in range(4)}
    got = {i: t.copy() for i, t in want.items()}
    got[1][2] = (got[1][2] + 1) % 9
    got[3] = got[3][:-1]
    assert tq.compare_outputs(want, got) == jq.compare_outputs(want, got)
    assert tq.compare_outputs(want, want)["match"]


# ---------------------------------------------------------------------------
# the plain paged versions with scales
# ---------------------------------------------------------------------------

def _block_tables(rng, b, n_logical, n_pages, n_shared):
    """Rows whose first ``n_shared`` entries alias the same pages (a shared
    prefix) and whose other entries are private (JAX's fixture)."""
    bt = np.zeros((b, n_logical), np.int32)
    perm = rng.permutation(np.arange(1, n_pages))
    bt[:, :n_shared] = perm[:n_shared]
    nxt = n_shared
    for r in range(b):
        for c in range(n_shared, n_logical):
            bt[r, c] = perm[nxt]
            nxt += 1
    return bt


def _quant_operands(s, kh, hd, page, q_len, seed=0):
    """JAX's ``_quant_operands`` shapes: an empty row, a row shorter than
    the chunk, a chunk-only row and a full row over aliased shared-prefix
    tables."""
    rng = np.random.RandomState(seed)
    clen = np.asarray([0, max(q_len - 1, 1), q_len, s], np.int32)
    b = clen.shape[0]
    n_logical = s // page
    n_pages = 1 + 2 + b * n_logical
    kp = rng.standard_normal((n_pages, page, kh, hd)).astype(np.float32)
    vp = rng.standard_normal((n_pages, page, kh, hd)).astype(np.float32)
    bt = _block_tables(rng, b, n_logical, n_pages, n_shared=2)
    return kp, vp, bt, clen, b, rng


ORACLE_CASES = [("decode", 1, 0), ("decode", 1, 24), ("multi", 4, 0),
                ("multi", 1, 0), ("prefill", 8, 0), ("prefill", 6, 24)]


@pytest.mark.parametrize("kind", KV_DTYPES)
@pytest.mark.parametrize("which,q_len,window", ORACLE_CASES)
def test_paged_plain_with_scales_matches_jax(kind, which, q_len, window):
    s, h, kh, hd, page = 64, 4, 2, 32, 8
    kp, vp, bt, clen, b, rng = _quant_operands(s, kh, hd, page, q_len)
    qshape = (b, h, hd) if which == "decode" else (b, q_len, h, hd)
    q = rng.standard_normal(qshape).astype(np.float32)
    jst, tst = jq.get_strategy(kind), tq.get_strategy(kind)
    jpools = jst.make_pools(jnp.asarray(kp), jnp.asarray(vp))
    tpools = tst.make_pools(_t(kp), _t(vp))
    for name in jpools:                     # the same stored operands
        np.testing.assert_array_equal(_bytes(tpools[name]),
                                      _bytes(jpools[name]))
    got = tst.oracle(which, _t(q), tpools, _t(bt), _t(clen), window=window)
    fn = {"decode": tops.paged_decode_attention,
          "multi": tops.paged_multi_decode_attention,
          "prefill": tops.paged_prefill_attention}[which]
    np.testing.assert_array_equal(
        fn(_t(q), tpools["k"], tpools["v"], _t(bt), _t(clen), window=window,
           **tst.scale_kwargs(tpools)).numpy(), got.numpy())
    jargs = (jnp.asarray(q), jpools, jnp.asarray(bt), jnp.asarray(clen))
    want = jst.oracle(which, *jargs, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=tst.tol_self)
    jfn = {"decode": jops.paged_decode_attention,
           "multi": jops.paged_multi_decode_attention,
           "prefill": lambda *a, **kw: jops.paged_prefill_attention(
               *a, q_blk=4, **kw)}[which]
    for native in ((False, True) if kind == "fp8" else (None,)):
        kern = jfn(jnp.asarray(q), jpools["k"], jpools["v"],
                   jnp.asarray(bt), jnp.asarray(clen), window=window,
                   native_dot=native, impl="pallas_interpret",
                   **jst.scale_kwargs(jpools))
        np.testing.assert_allclose(got.numpy(), np.asarray(kern), rtol=0,
                                   atol=tst.tol_self)
    # the quantization noise against the exact fp oracle: element for
    # element JAX's on the same inputs, and within the strategy's budget
    # wherever JAX's own oracle is
    exact = tq.get_strategy("exact")
    noise = got.numpy() - exact.oracle(
        which, _t(q), exact.make_pools(_t(kp), _t(vp)), _t(bt), _t(clen),
        window=window).numpy()
    jexact = jq.get_strategy("exact")
    jnoise = np.asarray(want) - np.asarray(jexact.oracle(
        which, jnp.asarray(q), jexact.make_pools(jnp.asarray(kp),
                                                 jnp.asarray(vp)),
        jnp.asarray(bt), jnp.asarray(clen), window=window))
    np.testing.assert_allclose(noise, jnp.asarray(jnoise), rtol=0,
                               atol=2 * tst.tol_self)
    assert np.abs(noise).max() <= max(tst.tol_exact,
                                      np.abs(jnoise).max()) + 1e-6
    print(f"{kind} {which} q_len {q_len}: noise {np.abs(noise).max():.4f} "
          f"(JAX {np.abs(jnoise).max():.4f}, budget {tst.tol_exact})")
    assert float(got[0].abs().max()) == 0.0          # empty row → zeros


@pytest.mark.parametrize("kind", KV_DTYPES)
def test_zero_scale_pages_give_zeros(kind):
    """Pages quantized from zeros carry scale 0: finite zero outputs."""
    kp, vp, bt, clen, b, rng = _quant_operands(32, 2, 16, 8, 1, seed=3)
    pools = tq.quantize_pool(torch.zeros(kp.shape), torch.zeros(vp.shape),
                             kind)
    q = _t(rng.standard_normal((b, 4, 16)).astype(np.float32))
    got = tops.paged_decode_attention(q, pools["k"], pools["v"], _t(bt),
                                      _t(clen), k_scale=pools["k_scale"],
                                      v_scale=pools["v_scale"])
    assert torch.equal(got, torch.zeros_like(got))


def test_scales_come_together():
    kp, vp, bt, clen, b, rng = _quant_operands(32, 2, 16, 8, 1)
    pools = tq.quantize_pool(_t(kp), _t(vp), "int8")
    q = _t(rng.standard_normal((b, 4, 16)).astype(np.float32))
    with pytest.raises(ValueError, match="together"):
        tops.paged_decode_attention(q, pools["k"], pools["v"], _t(bt),
                                    _t(clen), k_scale=pools["k_scale"])


# ---------------------------------------------------------------------------
# layout and accounting
# ---------------------------------------------------------------------------

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


@pytest.mark.parametrize("kind", KV_DTYPES)
def test_quantized_cache_layout_matches_jax(system, kind):
    jcfg, cfg = system["jgs"].cfg, system["gs"].cfg
    jc = JT.init_paged_cache(jcfg, 3, 12, 4, kv_dtype=kind)
    tc = TT.init_paged_cache(cfg, 3, 12, 4, "cpu", kv_dtype=kind)
    for jl, tl in zip(jc, tc):
        assert set(jl) == set(tl) == {"k", "v", "k_scale", "v_scale"}
        for name in jl:
            a = bridge.to_numpy(tl[name])
            b = np.asarray(jl[name])
            assert a.shape == b.shape and a.dtype == b.dtype, name
            np.testing.assert_array_equal(_bytes(a), _bytes(b))
    with pytest.raises(ValueError, match="unknown kv_dtype"):
        TT.init_paged_cache(cfg, 3, 12, 4, "cpu", kv_dtype="e5m2")
    back = bridge.cache_from_numpy(jax.tree.map(np.asarray, jc),
                                   device="cpu")
    for bl, tl in zip(back, tc):
        for name in tl:
            assert bl[name].dtype == tl[name].dtype
            assert torch.equal(bl[name].view(torch.uint8)
                               if bl[name].element_size() == 1
                               else bl[name], tl[name].view(torch.uint8)
                               if tl[name].element_size() == 1
                               else tl[name])


def test_page_nbytes_matches_jax():
    for page, kh, hd, fp in ((8, 2, 32, 4), (8, 2, 128, 2), (4, 4, 16, 4)):
        for kind in (None, "int8", "fp8"):
            assert tkv.page_nbytes(page, kh, hd, kv_dtype=kind,
                                   fp_bytes=fp) == \
                jkv.page_nbytes(page, kh, hd, kv_dtype=kind, fp_bytes=fp)
    # the Qwen2-VL-2B layer page: 8192 B in bf16, 4224 B in 8 bits
    assert tkv.page_nbytes(8, 2, 128, fp_bytes=2) == 8192
    assert tkv.page_nbytes(8, 2, 128, kv_dtype="int8") == 4224
    with pytest.raises(ValueError):
        tkv.page_nbytes(8, 2, 32, kv_dtype="int4")


def _cores(system, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("answer_vocab", ANSWER_VOCAB)
    port = EngineCore(system["gs"], system["ac"], EngineCoreConfig(**kw))
    jax_ = JEngineCore(system["jgs"], system["jac"], JEngineCoreConfig(**kw))
    return port, jax_


def test_pool_bytes_sizing_matches_jax(system):
    port, jax_ = _cores(system)
    budget = port._page_nbytes_stack() * 22
    assert budget == jax_._page_nbytes_stack() * 22
    for kind in (None,) + KV_DTYPES:
        port, jax_ = _cores(system, pool_bytes=budget, kv_dtype=kind)
        assert port._n_pages == jax_._n_pages
        assert port._page_nbytes_stack() == jax_._page_nbytes_stack()
        if kind is None:
            assert port._n_pages == 22
        else:
            assert port._n_pages >= 3 * 22
        ps, js = port.kv_stats(), jax_.kv_stats()
        for key in ("kv_bytes_total", "kv_scale_bytes", "kv_dtype",
                    "page_bytes", "n_pages", "kv_bytes_per_slot"):
            assert ps[key] == js[key], key


VALIDATION = [
    (dict(pool_bytes=16), "buys only"),
    (dict(pool_bytes=1 << 20, pool_pages=8), "mutually exclusive"),
    (dict(pool_bytes=1 << 20, cache_impl="dense"), "paged cache"),
    (dict(kv_dtype="int8", cache_impl="dense"), "paged cache"),
    (dict(kv_dtype="fp8", cache_impl="dense"), "paged cache"),
    (dict(kv_dtype="e5m2"), "unknown kv_dtype"),
]


@pytest.mark.parametrize("kw,match", VALIDATION)
def test_validation_matches_jax(system, kw, match):
    with pytest.raises(ValueError, match=match):
        JEngineCore(system["jgs"], system["jac"], JEngineCoreConfig(**kw))
    with pytest.raises(ValueError, match=match):
        EngineCore(system["gs"], system["ac"], EngineCoreConfig(**kw))


def test_engine_config_takes_quantized_pools():
    for kind in KV_DTYPES:
        assert EngineConfig(kv_dtype=kind, pool_bytes=1 << 20).kv_dtype == \
            kind
        assert EngineCoreConfig(kv_dtype=kind).kv_dtype == kind


# ---------------------------------------------------------------------------
# the engines, against JAX's
# ---------------------------------------------------------------------------

MODES = {"paged": {}, "spec3": {"spec_gamma": 3},
         "chunk8": {"prefill_chunk": 8}}


def _requests(cls, stream, drafts=None):
    return [cls(task=t, image=im, prompt=p, scene_id=s,
                draft_tokens=None if drafts is None else drafts[i])
            for i, (t, im, p, s) in enumerate(stream)]


def _serve(system, port: bool, drafts=None, **kw):
    cfg = (EngineConfig if port else JEngineConfig)(
        slots=SLOTS, answer_vocab=ANSWER_VOCAB, **kw)
    tier = system["gs" if port else "jgs"]
    draft = system["sat" if port else "jsat"] if kw.get("spec_gamma") \
        else None
    if port:
        eng = InferenceEngine(tier.params, tier.cfg, system["ac"], cfg,
                              draft=draft, device="cpu")
    else:
        eng = JInferenceEngine(tier.params, tier.cfg, system["jac"], cfg,
                               draft=draft)
    reqs = _requests(Request if port else JRequest, system["stream"],
                     drafts)
    out = {r.request_id: r.tokens for r in eng.serve(reqs)}
    return eng, [np.asarray(out[r.request_id]) for r in reqs]


@pytest.fixture(scope="module")
def engines(system):
    """Every quantized engine of both packages on the stream, once:
    {(kind, mode): (port engine, port tokens, JAX engine, JAX tokens)},
    plus the port's fp paged engine under (None, "paged")."""
    out = {}
    for kind in KV_DTYPES:
        for mode, kw in MODES.items():
            pe, pt = _serve(system, True, kv_dtype=kind, **kw)
            je, jt = _serve(system, False, kv_dtype=kind, **kw)
            out[kind, mode] = (pe, pt, je, jt)
    pe, pt = _serve(system, True)
    out[None, "paged"] = (pe, pt, None, None)
    return out


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("kind", KV_DTYPES)
def test_quantized_engine_matches_jax(engines, kind, mode):
    pe, pt, je, jt = engines[kind, mode]
    for g, w in zip(pt, jt):
        np.testing.assert_array_equal(g, w)
    for key in COUNTERS:
        assert pe.core.stats[key] == je.core.stats[key], key
    assert pe.core.stats["prefill_by_kind"] == \
        je.core.stats["prefill_by_kind"]
    assert pe.core.stats["prefix_hits"] > 0
    ps, js = pe.core.kv_stats(), je.core.kv_stats()
    for key in KV_STATS:
        assert ps[key] == js[key], key
    assert ps["kv_dtype"] == kind and ps["kv_scale_bytes"] > 0
    if mode == "spec3":
        pst, jst = pe.core.spec_stats(), je.core.spec_stats()
        for key in SPEC_COUNTERS:
            assert pst[key] == jst[key], key
        assert pst["drafted"] > 0
    if mode == "chunk8":
        psc, jsc = pe.core.scheduler_stats(), je.core.scheduler_stats()
        for key in ("fused_steps", "steps", "decode_tokens"):
            assert psc[key] == jsc[key], key


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("kind", KV_DTYPES)
def test_quantized_pools_match_jax(engines, kind, mode):
    """After serving, the pools (trash page aside: the port writes its
    padding there, JAX drops it): scales within 1e-5 relative, stored
    values equal or one quantization step apart."""
    pe, _, je, _ = engines[kind, mode]
    jcache = jax.tree.map(np.asarray, je.core._slot_cache)
    steps = total = far = n_scales = 0
    worst = 0.0
    for tl, jl in zip(pe.core._slot_cache, jcache):
        for name in ("k_scale", "v_scale"):
            a, b = tl[name].numpy()[:, 1:], jl[name][:, 1:]
            np.testing.assert_allclose(a, b, rtol=SCALE_RTOL, atol=0)
            rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-30)
            rel[(a == 0) & (b == 0)] = 0
            worst = max(worst, float(rel.max()))
            far += int((rel > 1e-5).sum())
            n_scales += rel.size
        for name in ("k", "v"):
            a = bridge.to_numpy(tl[name])[:, 1:]
            b = jl[name][:, 1:]
            if kind == "int8":
                d = np.abs(a.astype(np.int32) - b.astype(np.int32))
            else:                       # e4m3 steps: adjacent codes
                d = np.abs(_e4m3_rank(a) - _e4m3_rank(b))
            assert d.max() <= 1, (name, int(d.max()))
            steps += int((d > 0).sum())
            total += d.size
    print(f"{kind} {mode}: {steps} of {total} stored values one step "
          f"apart ({steps / total:.2e}); scales: largest relative "
          f"difference {worst:.2e}, {far} of {n_scales} past 1e-5")


def _sat_requests(cls, sat_data, n=4, scenes=2):
    """JAX's ``tests/test_kv_quant.py`` stream: det/vqa over two scenes."""
    return [cls(task="det" if i % 2 else "vqa",
                image=sat_data["images"][i % scenes], prompt=i % 2,
                scene_id=f"s{i % scenes}") for i in range(n)]


def _drive(core, reqs):
    """JAX's ``_serve`` loop: admit one request at a time into free slots,
    step until drained; tokens in admission order."""
    queue = list(reversed(reqs))
    order, outs = {}, {}
    while queue or core.active_count() > 0:
        for _ in range(min(len(queue), len(core.free_slots()))):
            r = queue.pop()
            order[r.request_id] = len(order)
            core.admit_many([r])
        for req, toks in core.step():
            outs[order[req.request_id]] = np.asarray(toks).tolist()
    return [outs[i] for i in range(len(outs))]


@pytest.fixture(scope="module")
def sat_data(system):
    ac = system["ac"]
    cfg = synthetic.EOTaskConfig(image_size=ac.image_size, grid=ac.grid,
                                 num_classes=ac.num_classes)
    return synthetic.make_dataset("cls", 8, seed=0, cfg=cfg)


def _sat_core(system, port, **kw):
    kw = dict(slots=2, answer_vocab=ANSWER_VOCAB, **kw)
    if port:
        return EngineCore(system["sat"], system["ac"], EngineCoreConfig(**kw),
                          draft=kw.get("spec_gamma") and system["sat"])
    return JEngineCore(system["jsat"], system["jac"], JEngineCoreConfig(**kw),
                       draft=kw.get("spec_gamma") and system["jsat"])


@pytest.mark.parametrize("kind", KV_DTYPES)
def test_chunked_equals_unchunked(system, sat_data, kind):
    """JAX's chunk-stability check on its own stream (the satellite tier,
    two slots, chunk 4): per-slot scales keep every write local, so the
    chunked and synchronous quantized engines give the same tokens, in the
    port as in JAX."""
    want = _drive(_sat_core(system, False, kv_dtype=kind),
                  _sat_requests(JRequest, sat_data))
    plain = _drive(_sat_core(system, True, kv_dtype=kind),
                   _sat_requests(Request, sat_data))
    chunked = _drive(_sat_core(system, True, kv_dtype=kind, prefill_chunk=4),
                     _sat_requests(Request, sat_data))
    assert plain == chunked == want


def _quant_view(t):
    return t.view(torch.uint8) if t.element_size() == 1 else t


def _e4m3_rank(x):
    """e4m3 values as integers in value order (one apart = one step; +0
    and -0 are both 0)."""
    u = x.view(np.uint8).astype(np.int32)
    return np.where(u & 0x80, -(u & 0x7F), u)


@pytest.mark.parametrize("kind", KV_DTYPES)
def test_spec_rollback_keeps_committed_bytes(system, engines, kind):
    """Adversarial piggybacked drafts make every verify chunk roll back;
    the committed streams are the quantized greedy engine's, and the γ 3
    engines of both packages agree."""
    greedy = engines[kind, "paged"][1]
    drafts = [np.asarray([(t + 1) % ANSWER_VOCAB for t in toks], np.int32)
              for toks in greedy]
    pe, pt = _serve(system, True, drafts=drafts, kv_dtype=kind,
                    spec_gamma=3)
    for a, b in zip(pt, greedy):
        np.testing.assert_array_equal(a, b)
    assert pe.core.spec_stats()["accepted"] < \
        pe.core.spec_stats()["drafted"]
    # every resident scene's pages hold the greedy engine's bytes
    greedy_core = engines[kind, "paged"][0].core
    for scene in range(3):
        mine = torch.tensor(pe.core._prefix.get(scene).pages)
        theirs = torch.tensor(greedy_core._prefix.get(scene).pages)
        for sl, gl in zip(pe.core._slot_cache, greedy_core._slot_cache):
            for name in sl:
                assert torch.equal(_quant_view(sl[name])[:, mine],
                                   _quant_view(gl[name])[:, theirs]), name


@pytest.mark.parametrize("kind", KV_DTYPES)
def test_shared_prefix_pages_quantized_once(system, kind):
    """A scene's shared pages (values and scales) are byte-equal from
    their prefill to the end of decoding, and hits reuse them."""
    core = EngineCore(system["gs"], system["ac"],
                      EngineCoreConfig(slots=SLOTS, kv_dtype=kind,
                                       answer_vocab=ANSWER_VOCAB))
    stream = [s for s in system["stream"] if s[3] == 0][:SLOTS]
    reqs = _requests(Request, stream)
    core.admit_many(reqs[:1])
    pages = torch.tensor(core._prefix.get(0).pages)
    before = [{k: _quant_view(v)[:, pages].clone() for k, v in d.items()}
              for d in core._slot_cache]
    core.admit_many(reqs[1:])
    assert core.stats["prefix_hits"] == len(reqs) - 1
    done = []
    while core.active_count():
        done += core.step()
    assert len(done) == len(reqs)
    for b, d in zip(before, core._slot_cache):
        for k in b:
            assert torch.equal(b[k], _quant_view(d[k])[:, pages]), k
    st = core.kv_stats()
    assert st["kv_dtype"] == kind and st["kv_scale_bytes"] > 0


@pytest.mark.parametrize("kind", KV_DTYPES)
def test_quantized_agreement_with_fp_is_reported(engines, kind):
    fp = engines[None, "paged"][1]
    q = engines[kind, "paged"][1]
    rec = tq.compare_outputs(dict(enumerate(fp)), dict(enumerate(q)))
    assert rec == jq.compare_outputs(dict(enumerate(fp)), dict(enumerate(q)))
    assert rec["n_requests"] == len(TASKS)
    assert [len(t) for t in fp] == [len(t) for t in q]
    print(kind, "agreement with the fp engine:", rec)
