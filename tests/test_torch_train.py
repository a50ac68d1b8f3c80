"""Training in the port against the live JAX package (CPU, float32, the
small proxies).

The same inputs, made from a seed with numpy, go through both packages.
Tolerances, each element:
- the plain flash backward against ``jax.vjp`` of ``repro.kernels.ref``'s
  ``flash_attention`` and ``flash_structured``: 1e-5·(1 + max|want|) (f32
  on both sides, sums in another order);
- logits, hidden states, losses and gradients: 1e-5 + 1e-4·|want|;
- after optimizer steps (``make_train_step``, ``train_proxy``,
  ``train_confidence``): losses 1e-5 relative; moments 1e-6 +
  1e-3·|want|; parameters 1e-5 + 1e-3·|want| + 0.02·Σ lr (Adam's step is
  about lr·sign(g) for a gradient near its noise floor, so an f32
  difference in the last bits of such a gradient moves its parameter by a
  share of the learning rate: 2% of the steps' summed learning rates);
- checkpoints: bit-equal both ways.
The JAX package draws threefry bits where the port draws from a
``torch.Generator``; ``train_proxy`` and ``train_confidence`` are held on
JAX's realised draws, fed through the port's draw helpers, and the port's
own draws are checked for reproducibility by seed.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.spaceverse_pair import proxy_pair as jproxy_pair  # noqa: E402
from repro.core import confidence as JC  # noqa: E402
from repro.core import eo_adapter as JEO  # noqa: E402
from repro.core import pipeline as JP  # noqa: E402
from repro.core.cascade import TierModel as JTierModel  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.kernels import ref as JR  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train import checkpoint as JCK  # noqa: E402
from repro.train import compression as JGC  # noqa: E402
from repro.train import elastic as JEL  # noqa: E402
from repro.train import optimizer as JO  # noqa: E402
from repro.train import trainer as JTR  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.spaceverse_pair import proxy_pair  # noqa: E402
from repro_torch.core import confidence as C  # noqa: E402
from repro_torch.core import eo_adapter as EO  # noqa: E402
from repro_torch.core import pipeline as P  # noqa: E402
from repro_torch.core.cascade import TierModel  # noqa: E402
from repro_torch.kernels import ref as R  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train import checkpoint as CK  # noqa: E402
from repro_torch.train import compression as GC  # noqa: E402
from repro_torch.train import elastic as EL  # noqa: E402
from repro_torch.train import optimizer as O  # noqa: E402
from repro_torch.train import trainer as TR  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _close(got, want, atol, rtol, what=""):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bad = np.abs(got - want) > atol + rtol * np.abs(want)
    assert not bad.any(), (what, float(np.abs(got - want).max()))


def _lr_sum(cfg, steps):
    """Σ of the learning rates of steps 1..steps (``JO.schedule``)."""
    return float(sum(JO.schedule(cfg, jnp.int32(s))
                     for s in range(1, steps + 1)))


def _trees_close(got, want, atol, rtol):
    """Leaf by leaf, in each tree's order (the bridge keeps JAX's sorted
    dict order)."""
    g, w = tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for i, (a, b) in enumerate(zip(g, w)):
        _close(a, b, atol, rtol, f"leaf {i}")


def _port(tree):
    return bridge.from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


# ---------------------------------------------------------------------------
# the plain flash backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window,softcap,group,hd", [
    (0, None, 1, 12), (5, None, 3, 16), (0, 4.0, 3, 12), (6, 3.0, 1, 16),
    (0, None, 3, 16)],
    ids=["causal", "window", "softcap", "window_softcap", "groups3"])
def test_flash_attention_bwd_matches_jax_vjp(window, softcap, group, hd):
    rng = np.random.default_rng(hd + group)
    b, s, kh = 2, 24, 2
    q, do = (rng.standard_normal((b, s, kh * group, hd)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((b, s, kh, hd)).astype(np.float32)
            for _ in range(2))
    def grads(f):
        return jax.jit(lambda q, k, v, do: jax.vjp(f, q, k, v)[1](do))

    o = JR.flash_attention(q, k, v, causal=True, window=window,
                           softcap=softcap)
    got = R.flash_attention_bwd(*(torch.from_numpy(np.array(t))
                                  for t in (q, k, v, o, do)),
                                window=window, softcap=softcap)
    for want in (grads(lambda q, k, v: JR.flash_attention(
                     q, k, v, causal=True, window=window,
                     softcap=softcap))(q, k, v, do),
                 grads(lambda q, k, v: JR.flash_structured(
                     q, k, v, True, window, softcap, None, 8, 8))(
                     q, k, v, do)):
        for g, w in zip(got, want):
            w = np.asarray(w)
            _close(g, w, 1e-5 * (1 + np.abs(w).max()), 0.0)


def test_flash_autograd_on_the_cpu_is_the_plain_backward():
    """``ops.flash_attention`` under autograd on CPU tensors: the plain
    forward and backward, no kernel launch counted."""
    from repro_torch.kernels import ops
    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, 9, 4, 12), generator=g, requires_grad=True)
    k = torch.randn((1, 9, 2, 12), generator=g, requires_grad=True)
    v = torch.randn((1, 9, 2, 12), generator=g, requires_grad=True)
    before = ops.launch_counts()
    o = ops.flash_attention(q, k, v, window=4)
    do = torch.randn(o.shape, generator=g)
    got = torch.autograd.grad(o, (q, k, v), do)
    want = R.flash_attention_bwd(q.detach(), k.detach(), v.detach(),
                                 o.detach(), do, window=4)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert ops.launch_counts() == before


# ---------------------------------------------------------------------------
# forward_train, loss_fn, hidden_features
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sat():
    jcfg, _ = jproxy_pair("small")
    cfg, _ = proxy_pair("small")
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    b, s_t, r = 4, 4, cfg.num_patches
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s_t)
                                    ).astype(np.int32),
             "patch_embeds": rng.standard_normal((b, r, cfg.d_model)
                                                 ).astype(np.float32),
             "targets": rng.integers(0, cfg.vocab_size, (b, r + s_t)
                                     ).astype(np.int32),
             "loss_mask": (rng.random((b, r + s_t)) > 0.3
                           ).astype(np.float32)}
    return {"jcfg": jcfg, "cfg": cfg, "jp": jp, "batch": batch,
            "jb": {k: jnp.asarray(v) for k, v in batch.items()},
            "tb": {k: torch.from_numpy(v) for k, v in batch.items()}}


def test_forward_train_and_hidden_features_match_jax(sat):
    tp = _port(sat["jp"])
    lj, aux_j = jax.jit(lambda p, b: JT.forward_train(p, sat["jcfg"], b))(
        sat["jp"], sat["jb"])
    with torch.no_grad():
        lt, aux_t = T.forward_train(tp, sat["cfg"], sat["tb"])
        ht = T.hidden_features(tp, sat["cfg"], sat["tb"])
    _close(lt, lj, 1e-5, 1e-4)
    assert float(aux_t) == float(aux_j) == 0.0
    _close(ht, jax.jit(lambda p, b: JT.hidden_features(p, sat["jcfg"], b))(
        sat["jp"], sat["jb"]), 1e-5, 1e-4)


@pytest.mark.parametrize("remat,policy,ce_chunks", [
    (False, "nothing", 1), (True, "nothing", 3), (True, "dots", 8),
    (True, "dots_saveable", 8)])
def test_loss_fn_and_grads_match_jax(sat, remat, policy, ce_chunks):
    (lj, mj), gj = jax.jit(jax.value_and_grad(
        lambda p, b: JT.loss_fn(p, sat["jcfg"], b, remat=remat,
                                remat_policy=policy, ce_chunks=ce_chunks),
        has_aux=True))(sat["jp"], sat["jb"])
    loss, m, grads = TR.value_and_grad(
        lambda p, b: T.loss_fn(p, sat["cfg"], b, remat=remat,
                               remat_policy=policy, ce_chunks=ce_chunks),
        _port(sat["jp"]), sat["tb"])
    _close(loss, lj, 1e-5, 1e-4)
    for k in ("ce", "aux", "acc"):
        _close(m[k], mj[k], 1e-5, 1e-4, k)
    _trees_close(grads, gj, 1e-5, 1e-4)


def test_remat_recomputes_each_block_once():
    """remat "nothing" runs each block's forward twice a step (the forward
    and the backward's recompute); off, once."""
    from repro_torch.kernels import ops
    cfg, _ = proxy_pair("small")
    params = T.init_params(cfg, 0, device="cpu")
    tb = {"tokens": torch.zeros((1, 2), dtype=torch.int32),
          "patch_embeds": torch.zeros((1, cfg.num_patches, cfg.d_model)),
          "targets": torch.zeros((1, cfg.num_patches + 2),
                                 dtype=torch.int32),
          "loss_mask": torch.ones((1, cfg.num_patches + 2))}
    calls = []
    real = ops.flash_attention

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    for remat, want in ((False, 1), (True, 2)):
        calls.clear()
        ops.flash_attention, saved = counted, ops.flash_attention
        try:
            TR.value_and_grad(lambda p, b: T.loss_fn(p, cfg, b, remat=remat),
                              params, tb)
        finally:
            ops.flash_attention = saved
        assert len(calls) == want * cfg.num_layers


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_recurrent_mixers_refuse_train_mode(kind):
    cfg = get_config("xlstm-125m", reduced=True)
    gen = torch.Generator().manual_seed(0)
    init, mixer = {"mlstm": (L.init_mlstm, L.mlstm),
                   "slstm": (L.init_slstm, L.slstm)}[kind]
    p = init(gen, cfg, "cpu")
    x = torch.zeros((1, 4, cfg.d_model))
    with pytest.raises(NotImplementedError, match="'train'"):
        mixer(p, x, cfg=cfg, mode="train")


# ---------------------------------------------------------------------------
# the train step: optimizer, microbatches, compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat,policy,mb,scheme", [
    (False, "nothing", 1, "none"), (True, "nothing", 2, "none"),
    (True, "dots", 1, "int8"), (True, "dots", 2, "topk")])
def test_train_step_matches_jax(sat, remat, policy, mb, scheme):
    opt = JO.OptConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    popt = O.OptConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    comp = dict(scheme=scheme, topk_frac=0.1)
    jtc = JTR.TrainConfig(microbatches=mb, remat=remat, remat_policy=policy,
                          ce_chunks=3,
                          compression=JGC.CompressionConfig(**comp))
    tc = TR.TrainConfig(microbatches=mb, remat=remat, remat_policy=policy,
                        ce_chunks=3,
                        compression=GC.CompressionConfig(**comp))
    jstate = JO.init_opt_state(sat["jp"])
    if scheme != "none":
        jstate["err"] = JGC.init_error_state(sat["jp"])
    tp = _port(sat["jp"])
    tstate = bridge.from_numpy(jax.tree.map(np.asarray, jstate),
                               device="cpu")
    jstep = jax.jit(JTR.make_train_step(sat["jcfg"], opt, jtc))
    step = TR.make_train_step(sat["cfg"], popt, tc)
    jp, jst = sat["jp"], jstate
    for _ in range(2):
        jp, jst, jm = jstep(jp, jst, sat["jb"])
        tp, tstate, m = step(tp, tstate, sat["tb"])
        for k in ("loss", "ce", "aux", "acc", "grad_norm", "lr"):
            _close(m[k], jm[k], 1e-6, 1e-5, k)
    assert int(tstate["step"]) == int(jst["step"]) == 2
    _trees_close(tp, jp, 1e-5 + 0.02 * _lr_sum(opt, 2), 1e-3)
    for k in ("m", "v") + (("err",) if scheme != "none" else ()):
        _trees_close(tstate[k], jst[k], 1e-6, 1e-3)
    if scheme != "none":
        assert GC.compressed_bytes(tp, tc.compression) == \
            JGC.compressed_bytes(jp, jtc.compression)


def test_optimizer_pieces_match_jax():
    rng = np.random.default_rng(3)
    tree = {"a": rng.standard_normal((5, 3)).astype(np.float32),
            "b": [rng.standard_normal((7,)).astype(np.float32)]}
    ttree = tree_map(torch.from_numpy, tree)
    _close(O.global_norm(ttree), JO.global_norm(tree), 1e-6, 1e-6)
    clipped, norm = O.clip_by_global_norm(ttree, 0.5)
    jclipped, jnorm = JO.clip_by_global_norm(tree, 0.5)
    _trees_close(clipped, jclipped, 1e-7, 1e-6)
    cfg, pcfg = JO.OptConfig(warmup_steps=3, total_steps=9), \
        O.OptConfig(warmup_steps=3, total_steps=9)
    for s in range(12):
        _close(O.schedule(pcfg, torch.tensor(s, dtype=torch.int32)),
               JO.schedule(cfg, jnp.int32(s)), 1e-10, 1e-6, s)
    assert O.init_opt_state(ttree)["step"].dtype == torch.int32


# ---------------------------------------------------------------------------
# eo_adapter batches, train_proxy, build_confidence_data, train_confidence
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiers():
    jsat_cfg, jgs_cfg = jproxy_pair("small")
    sat_cfg, gs_cfg = proxy_pair("small")
    jac, ac = JEO.EOAdapterConfig(), EO.EOAdapterConfig()
    jsat = JEO.init_adapter(jax.random.PRNGKey(0), jsat_cfg, jac)
    jgs = JEO.init_adapter(jax.random.PRNGKey(1), jgs_cfg, jac)
    eo = jsyn.EOTaskConfig(image_size=ac.image_size, grid=ac.grid,
                           num_classes=ac.num_classes)
    data = {t: jsyn.make_dataset(t, 16, seed=i, cfg=eo)
            for i, t in enumerate(("vqa", "cls", "det"))}
    return {"jsat": JTierModel(jsat, jsat_cfg), "jgs": JTierModel(jgs, jgs_cfg),
            "sat": TierModel(_port(jsat), sat_cfg),
            "gs": TierModel(_port(jgs), gs_cfg), "jac": jac, "ac": ac,
            "data": data}


@pytest.mark.parametrize("task", ["vqa", "cls", "det"])
def test_build_batch_matches_jax(tiers, task):
    d = tiers["data"][task]
    ja = JEO.answers_from_labels(tiers["jac"], task, jnp.asarray(d["labels"]),
                                 jnp.asarray(d["region_rel"]))
    ta = EO.answers_from_labels(tiers["ac"], task,
                                torch.from_numpy(d["labels"]),
                                torch.from_numpy(d["region_rel"]))
    assert ta.dtype == torch.int32 and np.array_equal(_np(ta), np.asarray(ja))
    jb = JEO.build_batch(tiers["jsat"].params, tiers["jsat"].cfg,
                         tiers["jac"], task, jnp.asarray(d["images"]),
                         jnp.asarray(d["prompts"]), ja)
    tb = EO.build_batch(tiers["sat"].params, tiers["sat"].cfg, tiers["ac"],
                        task, torch.from_numpy(d["images"]),
                        torch.from_numpy(d["prompts"]), ta)
    assert set(tb) == set(jb)
    for k in ("tokens", "targets", "loss_mask"):
        assert np.array_equal(_np(tb[k]), np.asarray(jb[k])), k
    _close(tb["patch_embeds"], jb["patch_embeds"], 1e-5, 1e-4)


def _jax_proxy_draws(seed, steps, n, batch_size, shape, rate):
    """``repro.core.pipeline.train_proxy``'s realised draws: its init key,
    then each step's permutation rows and keep mask."""
    key = jax.random.PRNGKey(seed)
    k_init, key = jax.random.split(key)
    idx, keep = [], []
    for _ in range(steps):
        key, sub, kd = jax.random.split(key, 3)
        idx.append(np.asarray(jax.random.permutation(sub, n)[:batch_size]))
        keep.append(np.asarray(jax.random.uniform(kd, shape) >= rate))
    return k_init, idx, keep


def test_train_proxy_matches_jax_on_its_draws(tiers, monkeypatch):
    """Five steps over vqa and cls in turn, region dropout 0.2: per-step
    losses and the final weights, on JAX's init and JAX's draws."""
    steps, bs, seed = 5, 8, 0
    data = {t: tiers["data"][t] for t in ("vqa", "cls")}
    cfg, jcfg = tiers["sat"].cfg, tiers["jsat"].cfg
    jparams, jlosses = JP.train_proxy(jcfg, tiers["jac"], data, steps=steps,
                                      batch_size=bs, seed=seed)
    k_init, idx, keep = _jax_proxy_draws(seed, steps, 16, bs,
                                         (bs, tiers["ac"].n_regions), 0.2)
    init = _port(JEO.init_adapter(k_init, jcfg, tiers["jac"]))
    idx, keep = iter(idx), iter(keep)
    monkeypatch.setattr(P, "init_tier", lambda *a: init)
    monkeypatch.setattr(P, "draw_batch", lambda *a: next(idx))
    monkeypatch.setattr(P, "draw_keep",
                        lambda *a: torch.from_numpy(np.array(next(keep))))
    params, losses = P.train_proxy(cfg, tiers["ac"], data, steps=steps,
                                   batch_size=bs, seed=seed, device="cpu")
    _close(np.array(losses), np.array(jlosses), 1e-6, 1e-5)
    lr_sum = _lr_sum(JO.OptConfig(lr=3e-3, warmup_steps=5,
                                  total_steps=steps), steps)
    _trees_close(params, jparams, 1e-5 + 0.02 * lr_sum, 1e-3)


def test_build_confidence_data_matches_jax(tiers, monkeypatch):
    # JAX's generate jitted (the same function; its eager first call
    # compiles op by op, most of this test's time)
    monkeypatch.setattr(JEO, "generate",
                        jax.jit(JEO.generate, static_argnums=(1, 2, 3, 6)))
    for task in ("vqa",):
        d = {k: v[:8] for k, v in tiers["data"][task].items()}
        want = JP.build_confidence_data(tiers["jsat"], tiers["jgs"],
                                        tiers["jac"], d, task, 9)
        got = P.build_confidence_data(tiers["sat"], tiers["gs"], tiers["ac"],
                                      d, task, 9, device="cpu")
        for g, w in zip(got, want):
            _close(g, w, 1e-5, 1e-4, task)


def test_train_confidence_matches_jax_on_its_draws(monkeypatch):
    rng = np.random.default_rng(5)
    n, d, steps, batch = 40, 24, 20, 16
    vis = rng.standard_normal((n, d)).astype(np.float32)
    st = rng.standard_normal((n, d)).astype(np.float32)
    tgt = rng.random(n).astype(np.float32)
    jconf = JC.init_confidence(jax.random.PRNGKey(2), d, d, hidden=64,
                               num_stages=2)
    jparams, jlosses = JC.train_confidence(
        jconf, jnp.asarray(vis), [jnp.asarray(st)], jnp.asarray(tgt),
        steps=steps, batch=batch, seed=3)
    key, draws = jax.random.PRNGKey(3), []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        draws.append(np.asarray(jax.random.randint(sub, (batch,), 0, n)))
    draws = iter(draws)
    monkeypatch.setattr(C, "draw_rows",
                        lambda *a: torch.from_numpy(np.array(next(draws)))
                        .long())
    params, losses = C.train_confidence(
        _port(jconf), torch.from_numpy(vis), [torch.from_numpy(st)],
        torch.from_numpy(tgt), steps=steps, batch=batch, seed=3)
    _close(np.array(losses), np.array(jlosses), 1e-6, 1e-5)
    _trees_close(params, jparams, 1e-5 + 0.02 * 1e-2 * steps, 1e-3)
    _close(C.loss_fn(params, torch.from_numpy(vis), [torch.from_numpy(st)],
                     torch.from_numpy(tgt)),
           JC.loss_fn(jparams, jnp.asarray(vis), [jnp.asarray(st)],
                      jnp.asarray(tgt)), 1e-6, 1e-4)


def test_the_ports_own_draws_are_reproducible_by_seed(tiers):
    data = {t: tiers["data"][t] for t in ("vqa", "cls")}
    cfg, ac = tiers["sat"].cfg, tiers["ac"]
    runs = [P.train_proxy(cfg, ac, data, steps=3, batch_size=4, seed=s,
                          device="cpu") for s in (0, 0, 1)]
    assert runs[0][1] == runs[1][1] and runs[0][1] != runs[2][1]
    for a, b in zip(tree_leaves(runs[0][0]), tree_leaves(runs[1][0])):
        assert torch.equal(a, b)
    draws = []
    for _ in range(2):
        g = torch.Generator().manual_seed(7)
        draws.append((P.draw_batch(g, 16, 5), P.draw_keep(g, (2, 3), 0.2),
                      C.draw_rows(g, 16, 4)))
    assert all(np.array_equal(_np(a), _np(b))
               for a, b in zip(*draws))
    assert sorted(P.draw_batch(torch.Generator().manual_seed(1), 6, 6)) == \
        list(range(6))


def test_build_system_on_the_cpu():
    """The whole assembly at a few steps: finite, falling proxy losses, and
    the bundle's SpaceVerse evaluates on the CPU."""
    b = P.build_system(n_train=32, n_test=8, proxy_steps=12, conf_steps=5,
                       tasks=("vqa", "cls"), device="cpu")
    h = b.history
    assert len(h["sat_losses"]) == 12 and len(h["gs_losses"]) == 18
    assert len(h["conf_losses"]) == 5
    assert all(np.isfinite(h[k]).all() for k in h)
    assert h["sat_losses"][-1] < h["sat_losses"][0]
    out = b.spaceverse().evaluate("vqa", b.datasets["vqa"], 8)
    assert out["per_sample_simi"].shape == (8,)


# ---------------------------------------------------------------------------
# checkpoints, the bridge's optimizer state, elastic plans
# ---------------------------------------------------------------------------

def _bits(x):
    a = _np(x) if not (isinstance(x, torch.Tensor)
                       and x.dtype == torch.bfloat16) \
        else x.view(torch.int16).numpy()
    return a.view(np.uint8) if a.dtype.kind != "V" else a


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_restore_bit_equal_across_packages(sat, tmp_path, writer):
    jp = sat["jp"]
    jstate = JO.init_opt_state(jp)
    jstep = jax.jit(JTR.make_train_step(sat["jcfg"], JO.OptConfig(lr=1e-2)))
    jp, jstate, _ = jstep(jp, jstate, sat["jb"])   # m, v, step non-trivial
    jtree = {"params": jp, "opt": jstate}
    ttree = {"params": _port(jp),
             "opt": bridge.from_numpy(jax.tree.map(np.asarray, jstate),
                                      device="cpu")}
    d = str(tmp_path)
    want = JCK._flatten(jtree)                    # path → array
    if writer == "jax":
        JCK.save(d, 7, jtree, extra_meta={"who": "jax"})
        got, step = CK.restore(d, tree_map(torch.zeros_like, ttree))
        assert step == 7 and CK.latest_step(d) == 7
        got = {k: _np(v) for k, v in CK._paths(got)}
    else:
        CK.save(d, 7, ttree, extra_meta={"who": "port"})
        got, step = JCK.restore(d, jax.tree.map(jnp.zeros_like, jtree))
        assert step == 7 and JCK.latest_step(d) == 7
        got = JCK._flatten(got)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype, k
        assert got[k].tobytes() == w.tobytes(), k
    import json
    meta = json.load(open(os.path.join(d, "step_00000007.json")))
    assert meta["keys"] == sorted(meta["dtypes"]) and meta["step"] == 7


def test_bf16_checkpoints_restore_bit_equal(sat, tmp_path):
    """A bfloat16 tree JAX writes restores bit-equal into the port, and the
    port's own bf16 snapshot round-trips; both files hold the leaf as two
    raw bytes an element, as JAX writes it."""
    jtree = jax.tree.map(lambda x: x.astype(jnp.bfloat16), sat["jp"])
    like = tree_map(lambda t: torch.zeros_like(t, dtype=torch.bfloat16),
                    _port(sat["jp"]))
    JCK.save(str(tmp_path / "j"), 1, jtree)
    got, _ = CK.restore(str(tmp_path / "j"), like)
    for a, b in zip(tree_leaves(got), jax.tree.leaves(jtree)):
        assert a.dtype == torch.bfloat16
        assert np.array_equal(a.view(torch.int16).numpy(),
                              np.asarray(b).view(np.int16))
    CK.save(str(tmp_path / "p"), 1, got)
    again, _ = CK.restore(str(tmp_path / "p"), like)
    for a, b in zip(tree_leaves(again), tree_leaves(got)):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    with np.load(str(tmp_path / "p" / "step_00000001.npz")) as pf, \
            np.load(str(tmp_path / "j" / "step_00000001.npz")) as jf:
        for k in jf.files:
            assert pf[k].dtype == jf[k].dtype
            assert pf[k].tobytes() == jf[k].tobytes()


def test_async_checkpointer_keeps_the_last_k(tmp_path):
    tree = {"w": torch.arange(6, dtype=torch.float32),
            "s": torch.zeros((), dtype=torch.int32)}
    ck = CK.AsyncCheckpointer(str(tmp_path), keep=2)
    for s in range(4):
        ck.save_async(s, tree)
        tree["w"].add_(1.0)          # the snapshot was taken before this
    ck.wait()
    assert CK.list_steps(str(tmp_path)) == [2, 3]
    got, step = CK.restore(str(tmp_path), tree)
    assert step == 3 and got["w"].tolist() == [3, 4, 5, 6, 7, 8]
    with pytest.raises(FileNotFoundError):
        CK.restore(str(tmp_path / "none"), tree)
    (tmp_path / "file").write_text("")          # a save that cannot write
    bad = CK.AsyncCheckpointer(str(tmp_path / "file" / "sub"))
    bad.save_async(0, tree)
    with pytest.raises(OSError):
        bad.wait()


def test_bridge_carries_an_optimizer_state_both_ways(sat):
    jstate = JO.init_opt_state(sat["jp"])
    jstate["err"] = JGC.init_error_state(sat["jp"])
    t = bridge.from_numpy(jax.tree.map(np.asarray, jstate), device="cpu",
                          dtype=torch.bfloat16)
    assert bridge.kind_of(t) == "opt_state_err"
    assert t["step"].dtype == torch.int32 and t["step"].dim() == 0
    assert all(x.dtype == torch.float32 for x in tree_leaves(t["m"]))
    back = bridge.to_numpy(t)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_elastic_plans_match_jax():
    mon, jmon = EL.HeartbeatMonitor(4, timeout_s=5.0), \
        JEL.HeartbeatMonitor(4, timeout_s=5.0)
    for m in (mon, jmon):
        m.heartbeat(1, now=100.0)
        for _ in range(3):
            m.heartbeat(2, step_time_s=9.0, fleet_median_s=1.0, now=100.0)
    for dev in range(4):
        for m in (mon, jmon):
            if dev != 1 and dev != 2:
                m.heartbeat(dev, now=100.0)
    assert mon.failed_devices(now=103.0) == jmon.failed_devices(now=103.0)
    for args in [(16, [3], 4), (16, [0, 1, 2], 4, 2), (8, [], 2)]:
        assert EL.recovery_plan(*args) == JEL.recovery_plan(*args)
    with pytest.raises(RuntimeError):
        EL.fallback_mesh_shape(3, 4)
