"""The recurrent scans in train mode: the port's backward of the chunked scan
and of the sLSTM, the recurrent mixers in mode "train" and the training of
xlstm-125m and hymba-1.5b, against the live JAX package (CPU, float32).

The JAX side runs under ``impl="ref"`` (``set_default_impl``), where
``jax.vjp`` / ``jax.value_and_grad`` differentiate ``repro.kernels.ref``'s
``ssm_scan`` and ``slstm_scan`` through their ``lax.scan``s; the port's
plain backward versions (``ref.ssm_scan_bwd``, ``ref.slstm_scan_bwd``) are
written out, not autograd.  Every model-level case first asserts that
JAX's loss and gradients are finite: the JAX oracle exponentiates the
scan's decay before it masks it, and goes NaN where a chunk's summed decay
passes ~88 (the port masks first; ROADMAP §3).

Tolerances, each element:
- the plain backward against ``jax.vjp``, against ``torch.autograd`` of
  the port's plain forward, and in f64 against itself in f32:
  1e-5·(1 + max|want|) per output (f32 sums in another order; the scan's
  dlog_g is a reverse cumulative sum of per-token dot products, so its
  error scales with the largest term, not with each element);
- mixers' outputs, losses and the models' gradients: 1e-5 + 1e-4·|want|;
- a mixer's gradients under a random unit cotangent, O(10-400) sums over
  B·S tokens: 2e-5·(1 + max|want|) per leaf (the packages' f32 sums in
  other orders differ by up to 8e-6 of a leaf's largest element, most on
  the decay's leaves, whose reverse cumulative sums cancel);
- after a ``make_train_step``: metrics 1e-6 + 1e-5·|want|, moments 1e-6 +
  1e-3·|want|, parameters 1e-5 + 1e-3·|want| + 0.02·lr, as
  ``tests/test_torch_train.py`` holds the attention stacks.
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
from repro.kernels import ref as JR  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train import optimizer as JO  # noqa: E402
from repro.train import trainer as JTR  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import BlockSpec  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as R  # noqa: E402
from repro_torch.kernels import slstm_scan as SL  # noqa: E402
from repro_torch.kernels import ssm_scan as SS  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train import optimizer as O  # noqa: E402
from repro_torch.train import trainer as TR  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

TOL_BWD = 1e-5          # · (1 + max|want|), the plain backward
TOL_ABS, TOL_REL = 1e-5, 1e-4
TOL_MIXER_GRAD = 2e-5   # · (1 + max|want|), a mixer's gradient leaf


@pytest.fixture(autouse=True, scope="module")
def _jax_ref():
    prev = jops.set_default_impl("ref")
    yield
    jops.set_default_impl(prev)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _close_to_max(got, want, what=""):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= TOL_BWD * (1.0 + float(np.abs(want).max())), (what, err)


def _close(got, want, atol=TOL_ABS, rtol=TOL_REL, what=""):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bad = np.abs(got - want) > atol + rtol * np.abs(want)
    assert not bad.any(), (what, float(np.abs(got - want).max()))


def _finite(tree):
    for x in jax.tree.leaves(tree):
        assert np.isfinite(np.asarray(x, dtype=np.float32)).all()


# ---------------------------------------------------------------------------
# the plain backward versions against jax.vjp of the JAX references
# ---------------------------------------------------------------------------

#: (B, S, H, dk, dv, chunk, initial state, final-state cotangent, q/k as
#: Mamba's strided halves of one buffer): S below the chunk, one chunk,
#: several, chunk 16, xLSTM's dv = dk + 1
SSM_CASES = {
    "short_zero": (2, 37, 2, 8, 9, 64, False, False, False),
    "chunks_state_dsf": (2, 128, 2, 8, 9, 64, True, True, False),
    "chunk16_state": (1, 64, 3, 16, 17, 16, True, False, False),
    "mlstm_dv_dk1_dsf": (2, 64, 2, 12, 13, 16, False, True, False),
    "mamba_halves": (2, 64, 3, 16, 24, 64, True, True, True),
    "one_token": (3, 1, 2, 8, 5, 64, True, True, False),
}


def _ssm_case(name, g_const=None):
    b, s, h, dk, dv, chunk, carried, dsf, halves = SSM_CASES[name]
    rng = np.random.default_rng(sorted(SSM_CASES).index(name))
    if halves:          # C and B: the halves of one (B, S, H, 2·dk) buffer
        bc = rng.standard_normal((b, s, h, 2 * dk)).astype(np.float32)
        q, k = bc[..., dk:], bc[..., :dk] * 0.3
    else:
        q = rng.standard_normal((b, s, h, dk)).astype(np.float32)
        k = rng.standard_normal((b, s, h, dk)).astype(np.float32) * 0.3
    v = rng.standard_normal((b, s, h, dv)).astype(np.float32)
    g = (-np.logaddexp(0.0, rng.standard_normal((b, s, h))) if g_const is None
         else np.full((b, s, h), g_const)).astype(np.float32)
    st = (rng.standard_normal((b, h, dk, dv)).astype(np.float32)
          if carried else None)
    do = rng.standard_normal((b, s, h, dv)).astype(np.float32)
    dsf_ = (rng.standard_normal((b, h, dk, dv)).astype(np.float32)
            if dsf else None)
    return q, k, v, g, st, do, dsf_, chunk, halves


def _port_ssm_bwd(q, k, v, g, st, do, dsf, chunk, halves):
    if halves:          # strided views of one tensor, as layers.mamba's
        bc = torch.from_numpy(np.concatenate([k, q], -1))
        dk = q.shape[-1]
        tq, tk = bc[..., dk:], bc[..., :dk]
        assert tq.stride() == tk.stride() and not tq.is_contiguous()
    else:
        tq, tk = _t(q), _t(k)
    return R.ssm_scan_bwd(tq, tk, _t(v), _t(g), _t(st), _t(do), _t(dsf),
                          chunk=chunk)


@pytest.mark.parametrize("name", sorted(SSM_CASES))
def test_ssm_scan_bwd_matches_jax_vjp(name):
    """``ref.ssm_scan_bwd`` against ``jax.vjp`` of ``repro.kernels.ref.
    ssm_scan``: dq, dk, dv, dlog_g and the initial state's gradient."""
    q, k, v, g, st, do, dsf, chunk, halves = _ssm_case(name)
    b, _, h, dk = q.shape
    st_j = (jnp.asarray(st) if st is not None
            else jnp.zeros((b, h, dk, v.shape[-1]), jnp.float32))
    (_, sf), vjp = jax.vjp(lambda *a: JR.ssm_scan(*a, chunk=chunk),
                           *map(jnp.asarray, (q, k, v, g)), st_j)
    want = vjp((jnp.asarray(do),
                jnp.zeros_like(sf) if dsf is None else jnp.asarray(dsf)))
    _finite(want)
    got = _port_ssm_bwd(q, k, v, g, st, do, dsf, chunk, halves)
    for n, a, w in zip(("dq", "dk", "dv", "dlog_g", "dstate"), got, want):
        _close_to_max(a, w, n)


def _slstm_case(kind):
    """(gates_x, r, state, dh, dfinal): ``zero`` the zero start; ``carried``
    an initial state; ``dfinal`` with the final state's cotangents; ``big``
    pre-activations ~N(0, 10²) (the stabiliser's m path at work);
    ``clamp`` a carried n below 1e-6 with the input gate far below the
    forget gate, so that max(n, 1e-6) binds at every step (c carried at
    n's scale, so that h = o·c / 1e-6 stays O(1))."""
    rng = np.random.default_rng(len(kind))
    b, s, heads, p = 2, 13, 2, 8
    d = heads * p
    gx = rng.standard_normal((b, s, 4 * d)).astype(np.float32)
    r = (rng.standard_normal((heads, p, 4 * p)) / np.sqrt(p)).astype(
        np.float32)
    gx[..., 2 * d:3 * d] += 3.0
    state = None
    if kind != "zero":
        state = (np.tanh(rng.standard_normal((b, heads, p))),
                 rng.standard_normal((b, heads, p)) * 2,
                 np.abs(rng.standard_normal((b, heads, p))) + 0.5,
                 rng.standard_normal((b, heads, p)))
    if kind == "big":
        gx *= 10.0
    if kind == "clamp":
        gx[..., d:2 * d] = -30.0               # i' = exp(-30 - m) ~ 1e-13
        gx[..., 2 * d:3 * d] = 8.0             # log f ~ -3e-4 a step
        state = (state[0], state[1] * 1e-8, np.full((b, heads, p), 1e-8),
                 np.zeros((b, heads, p)))
    state = None if state is None else tuple(x.astype(np.float32)
                                             for x in state)
    dh = rng.standard_normal((b, s, d)).astype(np.float32)
    dfinal = None
    if kind in ("dfinal", "clamp", "big"):
        dfinal = tuple(rng.standard_normal((b, heads, p)).astype(np.float32)
                       for _ in range(4))
    if kind == "dfinal":
        state = tuple(x.astype(np.float32) for x in (
            np.zeros((b, heads, p)), np.zeros((b, heads, p)),
            np.full((b, heads, p), 1e-6), np.zeros((b, heads, p))))
    return gx, r, state, dh, dfinal


SLSTM_KINDS = ("zero", "carried", "dfinal", "big", "clamp")


@pytest.mark.parametrize("kind", SLSTM_KINDS)
def test_slstm_scan_bwd_matches_jax_vjp(kind):
    """``ref.slstm_scan_bwd`` against ``jax.vjp`` of ``repro.kernels.ref.
    slstm_scan``: dgates_x, dr and the initial (h, c, n, m)'s gradients, the
    m path and the clamp differentiated as JAX does."""
    gx, r, state, dh, dfinal = _slstm_case(kind)
    b, s, _ = gx.shape
    heads, p = r.shape[:2]
    z = jnp.zeros((b, heads, p), jnp.float32)
    st_j = (tuple(map(jnp.asarray, state)) if state is not None
            else (z, z, z + 1e-6, z))
    (_, fin), vjp = jax.vjp(JR.slstm_scan, jnp.asarray(gx), jnp.asarray(r),
                            st_j)
    cot = (tuple(map(jnp.asarray, dfinal)) if dfinal is not None
           else tuple(jnp.zeros_like(x) for x in fin))
    want = vjp((jnp.asarray(dh), cot))
    _finite(want)
    tstate = None if state is None else tuple(map(_t, state))
    hs, (_, _, n_f, _) = R.slstm_scan(_t(gx), _t(r), tstate)
    if kind == "clamp":
        assert float(n_f.max()) < 1e-6         # the clamp binds
    got = R.slstm_scan_bwd(_t(gx), _t(r), tstate, hs, _t(dh),
                           None if dfinal is None else tuple(map(_t, dfinal)))
    _close_to_max(got[0], want[0], "dgates_x")
    _close_to_max(got[1], want[1], "dr")
    for n, a, w in zip("hcnm", got[2], want[2]):
        _close_to_max(a, w, f"d{n}")


def _f64(x):
    if isinstance(x, tuple):
        return tuple(_f64(t) for t in x)
    return None if x is None else x.double()


@pytest.mark.parametrize("name", sorted(SSM_CASES)
                         + [f"slstm_{k}" for k in SLSTM_KINDS])
def test_plain_backward_in_f64_is_the_same_function(name):
    """Given f64, the plain backward computes in f64 (``chip_smoke.py``
    holds the card's backward kernels against it, within a multiple of the
    f32 version's own error): every output f64, within TOL_BWD·(1 +
    max|want|) of the f32 version on the same inputs."""
    if name.startswith("slstm_"):
        gx, r, state, dh, dfinal = _slstm_case(name[len("slstm_"):])
        tstate = None if state is None else tuple(map(_t, state))
        hs, _ = R.slstm_scan(_t(gx), _t(r), tstate)
        args = (_t(gx), _t(r), tstate, hs, _t(dh),
                None if dfinal is None else tuple(map(_t, dfinal)))
        f32, f64 = (R.slstm_scan_bwd(*a) for a in (args, _f64(args)))
        f32, f64 = ((x[0], x[1], *x[2]) for x in (f32, f64))
    else:
        q, k, v, g, st, do, dsf, chunk, _ = _ssm_case(name)
        args = tuple(map(_t, (q, k, v, g, st, do, dsf)))
        f32, f64 = (R.ssm_scan_bwd(*a, chunk=chunk)
                    for a in (args, _f64(args)))
    for a, w in zip(f32, f64):
        assert w.dtype == torch.float64
        _close_to_max(a, w, name)


# ---------------------------------------------------------------------------
# the plain backward against torch.autograd of the port's plain forward
# ---------------------------------------------------------------------------

def _autograd(fn, inputs, cotangents):
    leaves = [None if x is None else x.clone().requires_grad_()
              for x in inputs]
    outs = fn(*leaves)
    pairs = [(o, c) for o, c in zip(outs, cotangents) if c is not None]
    live = [x for x in leaves if x is not None]
    grads = torch.autograd.grad([o for o, _ in pairs], live,
                                [c for _, c in pairs])
    it = iter(grads)
    return [None if x is None else next(it) for x in leaves]


@pytest.mark.parametrize("name,g_const", [
    ("chunks_state_dsf", None), ("chunk16_state", -30.0),
    ("mamba_halves", -2.0)], ids=["soft", "decay_past_88", "halves"])
def test_ssm_scan_bwd_matches_port_autograd(name, g_const):
    """``ref.ssm_scan_bwd`` against ``torch.autograd`` of ``ref.ssm_scan``,
    also where a chunk's summed decay passes 88 (log_g -30 over 16 tokens),
    where the JAX oracle gives NaN and the port stays finite."""
    q, k, v, g, st, do, dsf, chunk, halves = _ssm_case(name, g_const)
    want = _autograd(lambda *a: R.ssm_scan(*a, chunk=chunk),
                     [_t(x) for x in (q, k, v, g, st)], [_t(do), _t(dsf)])
    got = _port_ssm_bwd(q, k, v, g, st, do, dsf, chunk, halves)
    for n, a, w in zip(("dq", "dk", "dv", "dlog_g", "dstate"), got, want):
        assert torch.isfinite(a).all(), n
        _close_to_max(a, w, n)


@pytest.mark.parametrize("kind", ["carried", "clamp"])
def test_slstm_scan_bwd_matches_port_autograd(kind):
    """``ref.slstm_scan_bwd`` against ``torch.autograd`` of
    ``ref.slstm_scan`` (torch takes a tie of ``maximum`` half and half,
    ``clamp`` all to the input: no tie arises here)."""
    gx, r, state, dh, dfinal = _slstm_case(kind)

    def fwd(gx, r, *st):
        hs, fin = R.slstm_scan(gx, r, st)
        return (hs, *fin)

    want = _autograd(fwd, [_t(x) for x in (gx, r, *state)],
                     [_t(dh), *(map(_t, dfinal or (None,) * 4))])
    hs, _ = R.slstm_scan(_t(gx), _t(r), tuple(map(_t, state)))
    got = R.slstm_scan_bwd(_t(gx), _t(r), tuple(map(_t, state)), hs, _t(dh),
                           None if dfinal is None else tuple(map(_t, dfinal)))
    for n, a, w in zip(("dgates_x", "dr", "dh", "dc", "dn", "dm"),
                       (got[0], got[1], *got[2]), want):
        _close_to_max(a, w, n)


def test_ops_take_the_autograd_functions_under_grad():
    """``ops.ssm_scan`` / ``ops.slstm_scan`` go through ``SsmScanFn`` /
    ``SlstmScanFn`` when grad is on and an input requires it, and launch
    the forward alone otherwise."""
    q, k, v, g, st, _, _, chunk, _ = _ssm_case("chunks_state_dsf")
    tq = _t(q).requires_grad_()
    o, sf = ops.ssm_scan(tq, _t(k), _t(v), _t(g), _t(st), chunk=chunk)
    assert type(o.grad_fn).__name__ == "SsmScanFnBackward"
    with torch.no_grad():
        o2, sf2 = ops.ssm_scan(tq, _t(k), _t(v), _t(g), _t(st), chunk=chunk)
    assert o2.grad_fn is None and torch.equal(o.detach(), o2)
    assert torch.equal(sf.detach(), sf2)
    gx, r, state, _, _ = _slstm_case("carried")
    tg = _t(gx).requires_grad_()
    hs, fin = ops.slstm_scan(tg, _t(r), tuple(map(_t, state)))
    assert type(hs.grad_fn).__name__ == "SlstmScanFnBackward"
    assert len(fin) == 4 and all(f.grad_fn is not None for f in fin)
    hs2, _ = ops.slstm_scan(_t(gx), _t(r), tuple(map(_t, state)))
    assert hs2.grad_fn is None and torch.equal(hs.detach(), hs2)


def test_backward_cluster_size_rule():
    """The sLSTM backward's clusters: every block owns a unit, at most 8
    blocks (portable), about 24 units a block, R's rows within shared
    memory at every P the wrapper takes."""
    for p in range(1, 257):
        cs = SL.bwd_cluster_size(p)
        up = -(-p // cs)
        assert 1 <= cs <= SL.BWD_MAX_CLUSTER and (cs - 1) * up < p
        assert 4 * (up * 4 * p + 8 * p + up) <= 227 * 1024
    assert SL.bwd_cluster_size(192) == 8 and SL.bwd_cluster_size(16) == 1
    assert SS.BWD_MAX_DK >= 384       # xlstm-125m's dk


# ---------------------------------------------------------------------------
# the recurrent mixers in mode "train"
# ---------------------------------------------------------------------------

def _cfg_pair(name, **over):
    kinds = over.pop("block_pattern", None)
    jover, tover = dict(over), dict(over)
    if kinds:
        jover["block_pattern"] = tuple(JBlockSpec(kind=k, window=w)
                                       for k, w in kinds)
        tover["block_pattern"] = tuple(BlockSpec(kind=k, window=w)
                                       for k, w in kinds)
    jcfg = jconfigs.reduced_config(jconfigs.get_config(name), **jover)
    cfg = configs.reduced_config(configs.get_config(name), **tover)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    return jcfg, cfg


def _layer_params(tree):
    return bridge.from_numpy({"embed": {}, "blocks": jax.tree.map(
        np.asarray, tree), "final_norm": np.zeros(1)},
        device="cpu")["blocks"]


@pytest.mark.parametrize("kind", ["mlstm", "slstm", "mamba", "hybrid"])
def test_mixer_train_mode_matches_jax(kind):
    """Each recurrent mixer in mode "train" (no cache) on bridged params:
    its output, and the gradients of <out, cotangent> with respect to the
    input and every parameter, against the JAX mixer under ``jax.vjp``;
    the port returns no cache."""
    name = "hymba-1.5b" if kind in ("mamba", "hybrid") else "xlstm-125m"
    jcfg, cfg = _cfg_pair(name)
    jinit, jmix = {"mlstm": (JL.init_mlstm, JL.mlstm),
                   "slstm": (JL.init_slstm, JL.slstm),
                   "mamba": (JL.init_mamba, JL.mamba),
                   "hybrid": (JL.init_hybrid, JL.hybrid)}[kind]
    mix = getattr(L, kind)
    rng = np.random.default_rng(len(kind))
    b, s = 2, 64 if kind != "slstm" else 24
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    ct = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    jp = jinit(jax.random.PRNGKey(7), jcfg)
    jkw, tkw = {}, {}
    if kind == "hybrid":
        pos = np.broadcast_to(np.arange(s), (b, s))
        jcos, jsin = JL.rope_angles(jnp.asarray(pos), jcfg.resolved_head_dim,
                                    jcfg.rope_theta)
        tcos, tsin = L.rope_angles(torch.from_numpy(pos.copy()),
                                   cfg.resolved_head_dim, cfg.rope_theta)
        jkw = dict(window=8, cos=jcos, sin=jsin)
        tkw = dict(window=8, cos=tcos, sin=tsin)

    def jf(p, x):
        out, cache = jmix(p, x, cfg=jcfg, mode="train", **jkw)
        assert cache is None
        return out

    jout, (jgp, jgx) = jax.jit(lambda p, x, ct: (
        lambda o, vjp: (o, vjp(ct)))(*jax.vjp(jf, p, x)))(
        jp, jnp.asarray(x), jnp.asarray(ct))
    _finite((jout, jgp, jgx))
    tp = _layer_params(jp)
    leaves = [t.requires_grad_() for t in tree_leaves(tp)]
    tx = _t(x).requires_grad_()
    out, cache = mix(tp, tx, cfg=cfg, mode="train", **tkw)
    assert cache is None
    grads = torch.autograd.grad(out, [tx] + leaves, _t(ct), allow_unused=True)
    _close(out, jout, what="out")
    jl = jax.tree.leaves(jgp)
    assert len(jl) == len(leaves)
    for i, (a, w) in enumerate(zip(grads, [jgx] + jl)):
        a, w = _np(a).astype(np.float64), _np(w).astype(np.float64)
        err = float(np.abs(a - w).max())
        assert err <= TOL_MIXER_GRAD * (1.0 + float(np.abs(w).max())), (i, err)


def test_train_mode_takes_no_cache():
    jcfg, cfg = _cfg_pair("xlstm-125m")
    p = L.init_mlstm(torch.Generator().manual_seed(0), cfg, "cpu")
    x = torch.zeros((1, 4, cfg.d_model))
    with pytest.raises(ValueError, match="no cache"):
        L.mlstm(p, x, cfg=cfg, cache=L.init_mlstm_cache(cfg, 1, "cpu"),
                mode="train")
    with pytest.raises(NotImplementedError, match="'verify'"):
        L.mlstm(p, x, cfg=cfg, mode="verify")


# ---------------------------------------------------------------------------
# the models: loss_fn and its gradients, one train step
# ---------------------------------------------------------------------------

#: reduced xlstm-125m (6 layers: 4 mLSTM, 2 sLSTM; d 64, B 2 × S 128: two
#: scan chunks) and hymba-1.5b cut to 2 hybrid layers (a global and a
#: windowed one, window 8 so that it binds) at B 2 × S 64: the 16-layer
#: reduced hymba's JAX loss is NaN (the oracle's decay overflow)
MODELS = {
    "xlstm": (("xlstm-125m", {}), 2, 128),
    "hymba": (("hymba-1.5b", {"num_layers": 2, "block_pattern": (
        ("hybrid", 0), ("hybrid", 8))}), 2, 64),
}
LOSS_KW = {"remat": True, "remat_policy": "nothing", "ce_chunks": 8}


@pytest.fixture(scope="module")
def models():
    """Per model: configs, JAX params, the batch, and JAX's loss, metrics
    and gradients (``jax.value_and_grad`` of ``JT.loss_fn``), built once."""
    out = {}
    for tag, ((name, over), b, s) in MODELS.items():
        jcfg, cfg = _cfg_pair(name, **over)
        rng = np.random.default_rng(len(tag))
        toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
        batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
                 "loss_mask": (rng.random((b, s)) > 0.2).astype(np.float32)}
        jp = JT.init_params(jcfg, jax.random.PRNGKey(1))
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        (lj, mj), gj = jax.jit(jax.value_and_grad(
            lambda p, bb, jcfg=jcfg: JT.loss_fn(p, jcfg, bb, **LOSS_KW),
            has_aux=True))(jp, jb)
        assert np.isfinite(float(lj))
        _finite(gj)
        out[tag] = {"jcfg": jcfg, "cfg": cfg, "jp": jp, "jb": jb,
                    "tb": {k: torch.from_numpy(v) for k, v in batch.items()},
                    "want": (lj, mj, gj)}
    return out


def _port(tree):
    return bridge.from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


@pytest.mark.parametrize("tag,remat,policy", [
    ("xlstm", False, "nothing"), ("xlstm", True, "nothing"),
    ("xlstm", True, "dots"), ("xlstm", True, "dots_saveable"),
    ("hymba", True, "nothing"), ("hymba", True, "dots")])
def test_loss_fn_and_grads_match_jax(models, tag, remat, policy):
    """``T.loss_fn`` and every gradient leaf through ``TR.value_and_grad``
    against ``jax.value_and_grad`` of the JAX package's ``loss_fn`` (remat
    "nothing", ce_chunks 8), within 1e-5 + 1e-4·|want|: the scans'
    autograd functions survive ``torch.utils.checkpoint``'s recompute under
    each remat policy of the port."""
    m = models[tag]
    lj, mj, gj = m["want"]
    kw = {"remat": remat, "remat_policy": policy, "ce_chunks": 8}
    loss, met, grads = TR.value_and_grad(
        lambda p, b: T.loss_fn(p, m["cfg"], b, **kw), _port(m["jp"]),
        m["tb"])
    _close(loss, lj, what="loss")
    for k in ("ce", "aux", "acc"):
        _close(met[k], mj[k], what=k)
    g, w = tree_leaves(grads), jax.tree.leaves(gj)
    assert len(g) == len(w)
    for i, (a, b) in enumerate(zip(g, w)):
        _close(a, b, what=f"leaf {i}")


def test_xlstm_train_step_matches_jax(models):
    """One ``make_train_step`` (AdamW) on reduced xlstm-125m against the
    JAX package's: metrics, parameters and moments within the module's
    tolerances."""
    m = models["xlstm"]
    opt = JO.OptConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    popt = O.OptConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    jstep = jax.jit(JTR.make_train_step(m["jcfg"], opt,
                                        JTR.TrainConfig(**LOSS_KW)))
    step = TR.make_train_step(m["cfg"], popt, TR.TrainConfig(**LOSS_KW))
    jstate = JO.init_opt_state(m["jp"])
    tstate = bridge.from_numpy(jax.tree.map(np.asarray, jstate),
                               device="cpu")
    jp, jst, jm = jstep(m["jp"], jstate, m["jb"])
    tp, tstate, met = step(_port(m["jp"]), tstate, m["tb"])
    for k in ("loss", "ce", "aux", "acc", "grad_norm", "lr"):
        _close(met[k], jm[k], 1e-6, 1e-5, k)
    lr = float(JO.schedule(opt, jnp.int32(1)))
    for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        _close(a, b, 1e-5 + 0.02 * lr, 1e-3)
    for k in ("m", "v"):
        for a, b in zip(tree_leaves(tstate[k]), jax.tree.leaves(jst[k])):
            _close(a, b, 1e-6, 1e-3)


@pytest.mark.parametrize("tag", sorted(MODELS))
def test_hidden_features_and_forward_train_match_jax(models, tag):
    """``T.hidden_features`` (mode "train" without grad: the scans' forward
    alone) and ``T.forward_train``'s logits against the JAX package's, on
    the module's batch, within 1e-5 + 1e-4·|want|."""
    m = models[tag]
    inputs = {"tokens": m["jb"]["tokens"]}
    tp = _port(m["jp"])
    want = JT.hidden_features(m["jp"], m["jcfg"], inputs)
    with torch.no_grad():
        got = T.hidden_features(tp, m["cfg"], {"tokens": m["tb"]["tokens"]})
    _close(got, want, what="hidden")
    jlogits, _ = JT.forward_train(m["jp"], m["jcfg"], inputs, remat=False)
    logits, aux = T.forward_train(tp, m["cfg"], {"tokens": m["tb"]["tokens"]},
                                  remat=False)
    _close(logits, jlogits, what="logits")
    assert float(aux) == 0.0
