"""The port's xLSTM slice against the JAX package, on the CPU.

Same numpy inputs (or JAX random-init weights carried over by
``repro_torch.bridge``) through the JAX package (``impl="ref"``, and the
Pallas kernels in interpret mode where they run) and through the port on
the CPU, where ``repro_torch.kernels.ops`` takes the plain versions.
Tolerances (float32, sums in another order): the scans' outputs and states
3e-4 and the sLSTM's 2e-4 (the JAX package's own kernel-parity bounds);
layers and logits 1e-4; cache leaves 1e-4 + 1e-4·|want| (the sLSTM's
running max m reaches ~10).

Two results differ from the JAX package on purpose (ROADMAP §3): the port's
``ssm_scan`` masks the decay exponent before ``exp``, so it stays finite
where the JAX oracle gives NaN, and its sLSTM kernel takes an initial state,
where the Pallas kernel asserts a zero start.
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

from repro import configs as jconfigs  # noqa: E402
from repro.configs.base import BlockSpec as JBlockSpec  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import BlockSpec  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

TOL_SSM = 3e-4
TOL_SLSTM = 2e-4
TOL = 1e-4
N_DECODE = 8

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

_jprefill = jax.jit(JT.prefill, static_argnums=(1, 3))
_jdecode = jax.jit(JT.decode_step, static_argnums=(1,))


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    """A tensor that owns a copy: the port writes cache states in place,
    and must not write into a JAX array's buffer."""
    return torch.from_numpy(np.array(a, dtype=np.asarray(a).dtype))


def _close(got, want, tol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=tol)


def _ssm_inputs(rng, b, s, h, dk, dv, carried, g=None):
    q = _rand(rng, b, s, h, dk)
    k = _rand(rng, b, s, h, dk) * 0.3
    v = _rand(rng, b, s, h, dv)
    log_g = (-np.logaddexp(0.0, _rand(rng, b, s, h)) if g is None
             else np.full((b, s, h), g, np.float32)).astype(np.float32)
    state = _rand(rng, b, h, dk, dv) if carried else None
    return q, k, v, log_g, state


# ---------------------------------------------------------------------------
# ssm_scan
# ---------------------------------------------------------------------------

SSM_CASES = [
    # (s, h, dk, dv, chunk, carried)
    (128, 4, 16, 16, 32, False),
    (256, 2, 8, 24, 64, True),
    (64, 1, 32, 33, 16, True),       # dv = dk + 1, the mLSTM layout
    (37, 2, 12, 13, 64, True),       # chunk = S
    (96, 2, 48, 49, 32, False),
]


@pytest.mark.parametrize("s,h,dk,dv,chunk,carried", SSM_CASES)
def test_ssm_scan_plain_matches_jax(s, h, dk, dv, chunk, carried):
    rng = np.random.default_rng(s + dk)
    q, k, v, g, st = _ssm_inputs(rng, 2, s, h, dk, dv, carried)
    j_st = None if st is None else jnp.asarray(st)
    o, sf = ops.ssm_scan(_t(q), _t(k), _t(v), _t(g),
                         None if st is None else _t(st), chunk=chunk)
    for impl in ("ref", "pallas_interpret"):
        jo, jsf = jops.ssm_scan(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(g), j_st,
                                chunk=chunk, impl=impl)
        _close(o, jo, TOL_SSM)
        _close(sf, jsf, TOL_SSM)


def test_ssm_chunked_equals_sequential():
    rng = np.random.default_rng(5)
    b, s, h, dk, dv = 1, 96, 2, 8, 9
    q, k, v, g, st = (_t(x) for x in _ssm_inputs(rng, b, s, h, dk, dv,
                                                 True))
    o_chunk, f_chunk = ops.ssm_scan(q, k, v, g, st, chunk=32)
    outs = []
    for t in range(s):
        o_t, st = ops.ssm_decode_step(q[:, t], k[:, t], v[:, t], g[:, t], st)
        outs.append(o_t)
    _close(o_chunk, torch.stack(outs, 1), 1e-3)
    _close(f_chunk, st, 1e-3)


def test_ssm_decode_step_matches_jax():
    rng = np.random.default_rng(6)
    q, k, v, g, st = _ssm_inputs(rng, 3, 1, 2, 16, 17, True)
    o, sf = ops.ssm_decode_step(_t(q[:, 0]), _t(k[:, 0]), _t(v[:, 0]),
                                _t(g[:, 0]), _t(st))
    jo, jsf = jref.ssm_decode_step(q[:, 0], k[:, 0], v[:, 0], g[:, 0], st)
    _close(o, jo, TOL)
    _close(sf, jsf, TOL)


@pytest.mark.parametrize("g", [-2.0, -30.0])
def test_ssm_scan_stays_finite_under_strong_decay(g):
    """At log_g = -2 a 64-token chunk sums to -126: the JAX oracle's
    exp(cum_i - cum_j) overflows for j > i and gives inf·0 = NaN; the port
    masks first and equals the interpret-mode Pallas kernel."""
    rng = np.random.default_rng(7)
    q, k, v, lg, st = _ssm_inputs(rng, 2, 128, 2, 8, 9, True, g=g)
    args = [jnp.asarray(x) for x in (q, k, v, lg, st)]
    jo_ref, _ = jref.ssm_scan(*args, chunk=64)
    assert np.isnan(np.asarray(jo_ref)).any()
    o, sf = ops.ssm_scan(_t(q), _t(k), _t(v), _t(lg), _t(st), chunk=64)
    assert bool(o.isfinite().all()) and bool(sf.isfinite().all())
    jo, jsf = jops.ssm_scan(*args, chunk=64, impl="pallas_interpret")
    _close(o, jo, TOL_SSM)
    _close(sf, jsf, TOL_SSM)


def test_ssm_scan_chunk_must_divide_the_sequence():
    rng = np.random.default_rng(8)
    q, k, v, g, _ = (None if x is None else _t(x)
                     for x in _ssm_inputs(rng, 1, 100, 1, 8, 8, False))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ops.ssm_scan(q, k, v, g, chunk=64)


# ---------------------------------------------------------------------------
# slstm_scan
# ---------------------------------------------------------------------------

def _slstm_inputs(rng, b, s, heads, p, scale=1.0):
    d = heads * p
    gx = _rand(rng, b, s, 4 * d) * scale
    r = _rand(rng, heads, p, 4 * p) * 0.2
    state = (np.tanh(_rand(rng, b, heads, p)), _rand(rng, b, heads, p) * 3,
             rng.uniform(0.5, 5.0, (b, heads, p)).astype(np.float32),
             _rand(rng, b, heads, p) * 10)
    return gx, r, state


def _slstm_close(got, want, tol):
    h, st = got
    jh, jst = want
    _close(h, jh, tol)
    assert len(st) == len(jst) == 4
    for a, w in zip(st, jst):
        _close(a, w, tol, rtol=tol)


@pytest.mark.parametrize("b,s,heads,p,scale", [
    (2, 16, 2, 8, 1.0), (1, 33, 4, 4, 1.0), (3, 8, 1, 16, 1.0),
    (2, 1, 4, 12, 10.0), (2, 40, 2, 24, 10.0)])
def test_slstm_scan_plain_matches_jax(b, s, heads, p, scale):
    """With and without an initial state against the JAX oracle; the zero
    start also against the interpret-mode Pallas kernel.  ``scale`` 10 puts
    gate pre-activations past ±30 (the stabiliser and the stable
    log-sigmoid)."""
    rng = np.random.default_rng(b * 100 + s)
    gx, r, state = _slstm_inputs(rng, b, s, heads, p, scale)
    got = ops.slstm_scan(_t(gx), _t(r))
    _slstm_close(got, jref.slstm_scan(gx, r), TOL_SLSTM)
    _slstm_close(got, jops.slstm_scan(jnp.asarray(gx), jnp.asarray(r),
                                      impl="pallas_interpret"), TOL_SLSTM)
    got = ops.slstm_scan(_t(gx), _t(r), tuple(_t(x) for x in state))
    _slstm_close(got, jref.slstm_scan(gx, r, state), TOL_SLSTM)


def test_slstm_state_carries_across_calls():
    """Two calls chained through the state equal one call: the initial
    state operand is exactly what prefill → decode relies on."""
    rng = np.random.default_rng(9)
    gx, r, _ = _slstm_inputs(rng, 2, 20, 2, 8, 5.0)
    h_all, st_all = ops.slstm_scan(_t(gx), _t(r))
    h1, st1 = ops.slstm_scan(_t(gx[:, :13]), _t(r))
    h2, st2 = ops.slstm_scan(_t(gx[:, 13:]), _t(r), st1)
    _close(torch.cat([h1, h2], 1), h_all, 1e-6)
    for a, w in zip(st2, st_all):
        _close(a, w, 1e-6, rtol=1e-6)


def test_log_sigmoid_is_finite_far_below_zero():
    x = torch.tensor([-200.0, -30.0, 0.0, 30.0, 200.0])
    got = ref.log_sigmoid(x)
    assert bool(got.isfinite().all())
    _close(got, jax.nn.log_sigmoid(jnp.asarray(x.numpy())), 1e-6)


def test_scan_wrappers_refuse_cpu_tensors():
    from repro_torch.kernels.slstm_scan import slstm_scan_cuda
    from repro_torch.kernels.ssm_scan import ssm_scan_cuda
    x = torch.zeros(1, 2, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        ssm_scan_cuda(x, x, x, x[..., 0], torch.zeros(1, 2, 8, 8))
    with pytest.raises(ValueError, match="CUDA"):
        slstm_scan_cuda(torch.zeros(1, 3, 32), torch.zeros(2, 4, 16))


# ---------------------------------------------------------------------------
# configs, layers and the model stack on bridged weights
# ---------------------------------------------------------------------------

def test_config_registry_matches_jax():
    assert configs.list_configs() == ["codeqwen1.5-7b", "gemma2-27b",
                                      "gemma3-1b", "glm4-9b", "hymba-1.5b",
                                      "qwen2-vl-2b", "qwen2-vl-7b",
                                      "xlstm-125m"]
    assert "hymba-1.5b" in jconfigs.list_configs()
    for name in configs.list_configs():
        for reduced in (False, True):
            assert (dataclasses.asdict(configs.get_config(name, reduced))
                    == dataclasses.asdict(jconfigs.get_config(name,
                                                              reduced)))
    with pytest.raises(KeyError):
        configs.get_config("qwen2-moe-a2.7b")


VARIANTS = {
    "reduced": {},
    "d96": {"d_model": 96},       # mLSTM dk 48, sLSTM P 24: not powers of 2
    "mixed": {"num_layers": 3, "block_pattern": ("attn", "mlstm", "slstm")},
}


def _cfgs(variant):
    over = dict(VARIANTS[variant])
    kinds = over.pop("block_pattern", None)
    jover, tover = dict(over), dict(over)
    if kinds:
        jover["block_pattern"] = tuple(JBlockSpec(kind=k) for k in kinds)
        tover["block_pattern"] = tuple(BlockSpec(kind=k) for k in kinds)
    jcfg = jconfigs.reduced_config(jconfigs.get_config("xlstm-125m"), **jover)
    cfg = configs.reduced_config(configs.get_config("xlstm-125m"), **tover)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    return jcfg, cfg


@pytest.fixture(scope="module", params=list(VARIANTS))
def model(request):
    jcfg, cfg = _cfgs(request.param)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(1))
    tp = bridge.from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, cfg, jp, tp


def _cache_close(tcache, jcache):
    jl = jax.tree.leaves(jcache)
    tl = jax.tree.leaves(bridge.to_numpy(list(tcache)))
    assert len(jl) == len(tl)
    for a, w in zip(tl, jl):
        assert a.shape == w.shape and a.dtype == w.dtype
        _close(a, w, TOL, rtol=TOL)


def test_prefill_and_greedy_decode_match_jax(model):
    """Logits within 1e-4, equal greedy tokens, equal cache leaves after
    the prefill and after 8 greedy decode steps."""
    jcfg, cfg, jp, tp = model
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    jlog, jcache, jidx = _jprefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                                   16 + N_DECODE)
    tlog, tcache, tidx = T.prefill(tp, cfg, {"tokens": _t(toks)},
                                   16 + N_DECODE)
    assert int(jidx) == tidx == 16
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


def test_prefill_then_decode_continues_the_state(model):
    """prefill(S) equals prefill(S - 8) followed by 8 decode steps over the
    same tokens: the chunk form against the sequential path, and the sLSTM
    state operand."""
    jcfg, cfg, jp, tp = model
    rng = np.random.default_rng(12)
    toks = _t(rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32))
    want, wcache, _ = T.prefill(tp, cfg, {"tokens": toks}, 24)
    log, cache, idx = T.prefill(tp, cfg, {"tokens": toks[:, :16]}, 24)
    for t in range(16, 24):
        log, cache = T.decode_step(tp, cfg, cache, {"tokens": toks[:, t:t + 1]},
                                   t)
    _close(log, want, 1e-4)
    for a, w in zip(jax.tree.leaves(bridge.to_numpy(list(cache))),
                    jax.tree.leaves(bridge.to_numpy(list(wcache)))):
        _close(a, w, 1e-4, rtol=1e-4)


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_mlstm_and_slstm_layers_match_jax(mode):
    """Each mixer alone on bridged params and a carried cache state, against
    the JAX layer under ``ref`` and, for mLSTM (whose Pallas kernel takes a
    state), under the interpret-mode kernel."""
    jcfg, cfg = _cfgs("d96")
    rng = np.random.default_rng(13)
    s = 1 if mode == "decode" else 32
    x = _rand(rng, 2, s, cfg.d_model)
    key = jax.random.PRNGKey(2)
    for kind, jinit, jlayer, tlayer, jcache_fn in (
            ("mlstm", JL.init_mlstm, JL.mlstm, L.mlstm, JL.init_mlstm_cache),
            ("slstm", JL.init_slstm, JL.slstm, L.slstm, JL.init_slstm_cache)):
        jp = jinit(key, jcfg)
        tp = bridge.from_numpy({"embed": {}, "blocks": jax.tree.map(
            np.asarray, jp), "final_norm": np.zeros(1)}, device="cpu")
        # a carried state: random, with the sLSTM's n positive
        jcache = {k: jnp.asarray(
            rng.uniform(0.5, 2.0, a.shape).astype(np.float32) if k == "n"
            else _rand(rng, *a.shape) * 0.5)
            for k, a in jcache_fn(jcfg, 2).items()}
        tcache = {k: _t(np.asarray(a)) for k, a in jcache.items()}
        out, tcache = tlayer(tp["blocks"], _t(x), cfg=cfg, cache=tcache,
                             mode=mode)
        impls = ("ref", "pallas_interpret") if kind == "mlstm" else ("ref",)
        for impl in impls:
            prev = jops.set_default_impl(impl)
            try:
                jout, jnew = jlayer(jp, jnp.asarray(x), cfg=jcfg,
                                    cache=jcache, mode=mode)
            finally:
                jops.set_default_impl(prev)
            _close(out, jout, TOL)
            for k in jnew:
                _close(tcache[k], jnew[k], TOL, rtol=TOL)


# bfloat16: the port's casts against the JAX package's.  The operands each
# layer hands its scan are the JAX ones: bf16 operands bit-equal in at least
# 99.9% of elements and never more than one bf16 ulp apart (matmuls may sum
# in another order), f32 ones within 1e-5 relative; so is the sLSTM's
# output, which takes no bf16 transcendental after its scan.  Past the
# mLSTM's scan, XLA's
# bf16 logistic (in silu) rounds a different element in ~30% of cases from
# torch's, and a jit-compiled JAX model keeps f32 precision between fused
# bf16 ops; so a layer's output is held to 2^-6 of its largest magnitude,
# the model's logits to 2^-4 and its recurrent states to 2^-3 of theirs
# (readings: 2^-7.6, 0.12 on logits of ~3.9, 0.067).  A greedy token of the
# port must be one the JAX logits rank within twice the logit tolerance of
# their best: a bf16 near-tie may flip.
TOL_BF16_LAYER = 2.0 ** -6
TOL_BF16_LOGITS = 2.0 ** -4
TOL_BF16_STATE = 2.0 ** -3


def _f32(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _record(monkeypatch, module, names):
    """Wrap ``module``'s functions ``names`` so each call's arguments are
    kept (the last call of each; tensors copied, since the port writes its
    cache states in place)."""
    got = {}

    def copy(x):
        if isinstance(x, tuple):
            return tuple(copy(y) for y in x)
        return x.clone() if torch.is_tensor(x) else x

    for name in names:
        def call(*args, _fn=getattr(module, name), _name=name):
            got[_name] = copy(args)
            return _fn(*args)
        monkeypatch.setattr(module, name, call)
    return got


def _bf16_equal(got, want):
    a, b = _f32(got), _f32(want)
    assert a.shape == b.shape
    assert (a == b).mean() >= 0.999
    _close(a, b, 0.0, rtol=2.0 ** -7)


def _operands_equal(got, want):
    flat_g = [x for a in got for x in (a if isinstance(a, tuple) else (a,))]
    flat_w = [x for a in want for x in (a if isinstance(a, tuple) else (a,))]
    assert len(flat_g) == len(flat_w)
    for g, w in zip(flat_g, flat_w):
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        if str(w.dtype) == "bfloat16":
            _bf16_equal(g, w)
        else:
            _close(_f32(g), _f32(w), 1e-6, rtol=1e-5)


def _close_to_max(got, want, frac):
    a, b = _f32(got), _f32(want)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= frac * np.abs(b).max()


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_bf16_layers_hand_their_scans_the_jax_operands(mode, monkeypatch):
    """mLSTM and sLSTM in bfloat16 on bridged params and a carried state:
    the operands of ``ssm_scan`` / ``ssm_decode_step`` / ``slstm_scan`` equal
    the JAX layer's (``impl="ref"``, op by op), and the outputs and new
    states agree within the bf16 tolerances above."""
    jcfg, cfg = (dataclasses.replace(c, dtype="bfloat16")
                 for c in _cfgs("d96"))
    rng = np.random.default_rng(14)
    s = 1 if mode == "decode" else 32
    xj = jnp.asarray(_rand(rng, 2, s, cfg.d_model)).astype(jnp.bfloat16)
    xt = _t(_f32(xj)).to(torch.bfloat16)
    names = ("ssm_scan", "ssm_decode_step", "slstm_scan")
    jgot = _record(monkeypatch, jops, names)
    tgot = _record(monkeypatch, ops, names)
    prev = jops.set_default_impl("ref")
    try:
        for kind, jinit, jlayer, tlayer, jcache_fn in (
                ("mlstm", JL.init_mlstm, JL.mlstm, L.mlstm,
                 JL.init_mlstm_cache),
                ("slstm", JL.init_slstm, JL.slstm, L.slstm,
                 JL.init_slstm_cache)):
            jp = jinit(jax.random.PRNGKey(3), jcfg)
            tp = bridge.from_numpy({"embed": {}, "blocks": jax.tree.map(
                np.asarray, jp), "final_norm": np.zeros(1)}, device="cpu")
            jcache = {k: jnp.asarray(
                rng.uniform(0.5, 2.0, a.shape).astype(np.float32) if k == "n"
                else _rand(rng, *a.shape) * 0.5)
                for k, a in jcache_fn(jcfg, 2).items()}
            tcache = {k: _t(np.asarray(a)) for k, a in jcache.items()}
            out, tcache = tlayer(tp["blocks"], xt, cfg=cfg, cache=tcache,
                                 mode=mode)
            jout, jnew = jlayer(jp, xj, cfg=jcfg, cache=jcache, mode=mode)
            op = ("slstm_scan" if kind == "slstm" else
                  "ssm_decode_step" if mode == "decode" else "ssm_scan")
            _operands_equal(tgot.pop(op), jgot.pop(op))
            assert out.dtype == torch.bfloat16
            if kind == "slstm":
                _bf16_equal(out, jout)
            _close_to_max(out, jout, TOL_BF16_LAYER)
            for k in jnew:
                _close_to_max(tcache[k], jnew[k], TOL_BF16_LAYER)
    finally:
        jops.set_default_impl(prev)


def test_bf16_prefill_and_greedy_decode_match_jax():
    """The reduced xlstm-125m in bfloat16 on bridged weights: prefill and 8
    decode steps fed the JAX greedy tokens; logits and every cache leaf
    within the bf16 tolerances above, each port greedy token within twice
    the logit tolerance of the JAX best."""
    jcfg, cfg = (dataclasses.replace(c, dtype="bfloat16")
                 for c in _cfgs("reduced"))
    jp = JT.init_params(jcfg, jax.random.PRNGKey(1))
    tp = bridge.from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    jlog, jcache, _ = _jprefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                                16 + N_DECODE)
    tlog, tcache, tidx = T.prefill(tp, cfg, {"tokens": _t(toks)},
                                   16 + N_DECODE)
    for step in range(N_DECODE + 1):
        jl = np.asarray(jlog)
        tol = TOL_BF16_LOGITS * np.abs(jl).max()
        _close(tlog, jl, tol)
        picked = jl[np.arange(2), tlog.numpy().argmax(-1)]
        assert (picked >= jl.max(-1) - 2 * tol).all()
        for a, w in zip(jax.tree.leaves(bridge.to_numpy(list(tcache))),
                        jax.tree.leaves(jcache)):
            _close_to_max(a, w, TOL_BF16_STATE)
        if step == N_DECODE:
            break
        nxt = jl.argmax(-1).astype(np.int32)[:, None]
        jlog, jcache = _jdecode(jp, jcfg, jcache,
                                {"tokens": jnp.asarray(nxt)},
                                jnp.int32(tidx + step))
        tlog, tcache = T.decode_step(tp, cfg, tcache, {"tokens": _t(nxt)},
                                     tidx + step)


def test_init_params_keep_the_jax_tree_structure():
    jcfg, cfg = _cfgs("reduced")
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tp = bridge.to_numpy(T.init_params(cfg, seed=0, device="cpu"))
    jmeta = jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)), jp)
    tmeta = jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)), tp)
    assert jax.tree.structure(jmeta) == jax.tree.structure(tmeta)
    assert jax.tree.leaves(jmeta) == jax.tree.leaves(tmeta)


def test_bridge_round_trip_mixes_f32_and_bf16_leaves():
    jcfg, _ = _cfgs("reduced")
    jcfg = dataclasses.replace(jcfg, dtype="bfloat16")
    np_tree = jax.tree.map(np.asarray,
                           JT.init_params(jcfg, jax.random.PRNGKey(4)))
    dtypes = {a.dtype.name for a in jax.tree.leaves(np_tree)}
    assert dtypes == {"float32", "bfloat16"}
    back = bridge.to_numpy(bridge.from_numpy(np_tree, device="cpu"))
    for a, b in zip(jax.tree.leaves(np_tree), jax.tree.leaves(back)):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("variant", ["reduced", "mixed"])
def test_cache_trees_match_jax(variant):
    jcfg, cfg = _cfgs(variant)

    def meta(tree):
        return jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)), tree)

    for jc, tc in (
            (JT.init_cache(jcfg, 3, 40), T.init_cache(cfg, 3, 40, "cpu")),
            (JT.init_paged_cache(jcfg, 3, 9, 8),
             T.init_paged_cache(cfg, 3, 9, 8, "cpu"))):
        tnp = bridge.to_numpy(list(tc))
        assert jax.tree.structure(meta(list(jc))) == jax.tree.structure(
            meta(tnp))
        assert jax.tree.leaves(meta(list(jc))) == jax.tree.leaves(meta(tnp))
        assert all(not a.any() for a in jax.tree.leaves(tnp))
        kinds = dict(kv=lambda *c: "kv", state=lambda *c: "state")
        assert (T.map_cache_kinds(cfg, [tc, tc], **kinds)
                == JT.map_cache_kinds(jcfg, [jc, jc], **kinds))


@pytest.mark.parametrize("kind", ["moe"])
def test_unported_recurrent_blocks_raise(kind):
    """MoE blocks are not ported (Mamba and hybrid blocks are:
    ``tests/test_torch_hymba.py``)."""
    cfg = dataclasses.replace(configs.get_config("xlstm-125m", reduced=True),
                              block_pattern=(BlockSpec(kind="attn",
                                                       moe=True),),
                              num_layers=1)
    with pytest.raises(NotImplementedError, match="not ported"):
        T.init_params(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="not ported"):
        T.init_cache(cfg, 1, 8, "cpu")


@pytest.mark.parametrize("step", ["verify_step", "prefill_chunk_step"])
def test_recurrent_stacks_refuse_chunk_modes(step):
    cfg = configs.get_config("xlstm-125m", reduced=True)
    tp = T.init_params(cfg, seed=0, device="cpu")
    cache = T.init_cache(cfg, 1, 8, "cpu")
    toks = {"tokens": torch.zeros((1, 2), dtype=torch.int32)}
    with pytest.raises(NotImplementedError, match="needs attention blocks"):
        getattr(T, step)(tp, cfg, cache, toks, torch.zeros(1, dtype=torch.int64))


@pytest.mark.parametrize("kw", [
    pytest.param({"prefill_chunk": 8}, id="prefill_chunk"),
    pytest.param({"spec_gamma": 1}, id="spec_gamma"),
    pytest.param({"mesh": True}, id="mesh"),
])
def test_engine_core_refuses_a_recurrent_tier(kw):
    """An ``EngineCore`` over xLSTM blocks serves (tests/
    test_torch_recurrent_serving.py), but chunked prefill, speculative
    decoding and a mesh refuse a recurrent tier with the JAX engine's
    ValueError: a scan is not bit-stable across chunk boundaries, a state
    does not roll back, and a state has no heads to split."""
    from repro_torch.core import eo_adapter as EO
    from repro_torch.core.cascade import TierModel
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serving import EngineCore, EngineCoreConfig
    cfg = configs.get_config("xlstm-125m", reduced=True)
    ac = EO.EOAdapterConfig()
    tier = TierModel(EO.init_adapter(cfg, ac, 0, device="cpu"), cfg)
    draft = tier if kw.get("spec_gamma") else None
    if kw.get("mesh"):
        kw = {"mesh": make_host_mesh(model=1, data=1, devices=["cpu"])}
    with pytest.raises(ValueError, match="attention-only stacks"):
        EngineCore(tier, ac, EngineCoreConfig(**kw), draft=draft)
