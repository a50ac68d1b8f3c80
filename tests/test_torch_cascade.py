"""The rest of Algorithm 1 in the port against the live JAX package: the
batch evaluator (``SpaceVerse.run_batch`` / ``evaluate``), the Simi
metrics, the §4.1.5 baselines and the speculative cascade server.

Both packages run the same bridged random-init proxy weights
(``proxy_pair("small")``, ``EOAdapterConfig()``, a 2-stage confidence net,
``answer_vocab=9``) on ``make_dataset`` batches that are byte-equal between
the packages.  Decisions and tokens must be equal; scores, probabilities and
region scores within 1e-5 absolute; bytes and latencies within 1e-6
relative.  The random baselines (GS-only's region drop, AI-RG's selection)
draw from a ``torch.Generator`` where the JAX package draws threefry bits,
so for them the JAX realisation is fed to the port and everything
downstream is held equal; the port's own draws are checked for
reproducibility and rate.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: pytest's workers share the cores, and torch's
# default of a thread a core in each worker oversubscribes them
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.baselines import AIRG as JAIRG  # noqa: E402
from repro.baselines import GSOnly as JGSOnly  # noqa: E402
from repro.baselines import SatelliteOnly as JSatelliteOnly  # noqa: E402
from repro.baselines import Tabi as JTabi  # noqa: E402
from repro.configs.spaceverse_pair import proxy_pair as jproxy_pair  # noqa: E402
from repro.core import confidence as JC  # noqa: E402
from repro.core import eo_adapter as JEO  # noqa: E402
from repro.core import similarity as JS  # noqa: E402
from repro.core.cascade import CascadeConfig as JCascadeConfig  # noqa: E402
from repro.core.cascade import SpaceVerse as JSpaceVerse  # noqa: E402
from repro.core.cascade import TierModel as JTierModel  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.network.orbit import ContactPlan as JContactPlan  # noqa: E402
from repro.serving import CascadeServer as JCascadeServer  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving.offload import OffloadPipeline as JOffload  # noqa: E402
from repro.serving.policy import AIRGPolicy as JAIRGPolicy  # noqa: E402
from repro.serving.policy import GroundOnlyPolicy as JGroundOnlyPolicy  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.baselines import AIRG, GSOnly, SatelliteOnly, Tabi  # noqa: E402
from repro_torch.configs.spaceverse_pair import proxy_pair  # noqa: E402
from repro_torch.core import eo_adapter as EO  # noqa: E402
from repro_torch.core import preprocess as PP  # noqa: E402
from repro_torch.core import similarity as S  # noqa: E402
from repro_torch.core.cascade import CascadeConfig, SpaceVerse, TierModel  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.network.orbit import ContactPlan  # noqa: E402
from repro_torch.serving import AIRGPolicy, CascadeServer, Request  # noqa: E402
from repro_torch.serving.offload import OffloadPipeline  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

ANSWER_VOCAB = 9
B = 6
TASKS = ("vqa", "cls", "det")
#: all offload at stage 0, all at stage 1, none; "median": τ₀ at the median
#: of the batch's own stage-0 scores (a split batch)
TAUS = [(1.01, 0.0), (0.0, 1.01), (0.0, 0.0), "median"]
EXACT = ("pred", "offload", "exit_stage", "sat_pred", "gs_pred")
CLOSE = ("conf_scores", "sat_probs", "gs_probs", "region_scores")
RELATIVE = ("tx_bytes", "latency_s", "kept_frac")


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def systems():
    jsat_cfg, jgs_cfg = jproxy_pair("small")
    sat_cfg, gs_cfg = proxy_pair("small")
    jac, ac = JEO.EOAdapterConfig(), EO.EOAdapterConfig()
    jsat_p = JEO.init_adapter(jax.random.PRNGKey(0), jsat_cfg, jac)
    jgs_p = JEO.init_adapter(jax.random.PRNGKey(1), jgs_cfg, jac)
    jconf = JC.init_confidence(jax.random.PRNGKey(2), jsat_cfg.d_model,
                               jsat_cfg.d_model, hidden=64, num_stages=2)

    def carry(tree):
        return bridge.from_numpy(jax.tree.map(np.asarray, tree),
                                 device="cpu")

    data = {}
    for i, task in enumerate(TASKS):
        got = synthetic.make_dataset(task, B, seed=20 + i)
        want = jsyn.make_dataset(task, B, seed=20 + i)
        for key in ("images", "prompts", "labels", "region_rel"):
            np.testing.assert_array_equal(got[key], want[key])
        data[task] = got
    return {"jsat": JTierModel(jsat_p, jsat_cfg),
            "jgs": JTierModel(jgs_p, jgs_cfg), "jac": jac, "jconf": jconf,
            "sat": TierModel(carry(jsat_p), sat_cfg),
            "gs": TierModel(carry(jgs_p), gs_cfg), "ac": ac,
            "conf": carry(jconf), "data": data}


def _batch(data):
    images, prompts = data["images"], data["prompts"]
    return ((jnp.asarray(images), jnp.asarray(prompts)),
            (torch.from_numpy(images), torch.from_numpy(prompts)))


def _evaluators(s, taus):
    jsv = JSpaceVerse(s["jsat"], s["jgs"], s["jac"], s["jconf"],
                      JCascadeConfig(taus=taus, answer_vocab=ANSWER_VOCAB))
    sv = SpaceVerse(s["sat"], s["gs"], s["ac"], s["conf"],
                    CascadeConfig(taus=taus, answer_vocab=ANSWER_VOCAB),
                    device="cpu")
    return jsv, sv


def _compare(got, want, keys, msg=""):
    for key in keys:
        g, w = _np(got[key]), np.asarray(want[key])
        if key in EXACT:
            np.testing.assert_array_equal(g, w, err_msg=f"{msg} {key}")
        elif key in CLOSE:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5,
                                       err_msg=f"{msg} {key}")
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6,
                                       err_msg=f"{msg} {key}")


@pytest.mark.parametrize("taus", TAUS, ids=str)
@pytest.mark.parametrize("task", TASKS)
def test_run_batch_matches_live_jax(systems, task, taus):
    (jim, jpr), (im, pr) = _batch(systems["data"][task])
    if taus == "median":
        jsv, _ = _evaluators(systems, (0.0, 0.0))
        s0 = np.asarray(jsv.run_batch(task, jim, jpr)["conf_scores"])[:, 0]
        taus = (float(np.median(s0)), 0.0)
    jsv, sv = _evaluators(systems, taus)
    assert list(sv._stage_plan(task)) == list(jsv._stage_plan(task))
    want = jsv.run_batch(task, jim, jpr)
    got = sv.run_batch(task, im, pr)
    _compare(got, want, EXACT + CLOSE + RELATIVE, f"{task} {taus}")
    off, ex = _np(got["offload"]), _np(got["exit_stage"])
    if taus == (1.01, 0.0):
        assert off.all() and (ex == 0).all()
    elif taus == (0.0, 1.01):
        assert off.all() and (ex == 1).all()
    elif taus == (0.0, 0.0):
        assert not off.any() and (ex == -1).all()
    else:                       # the median split: `where` selects both ways
        assert 0 < off.sum() < B
        sel = off[:, None] if task == "det" else off
        np.testing.assert_array_equal(
            _np(got["pred"]), np.where(sel, _np(got["gs_pred"]),
                                       _np(got["sat_pred"])))


def test_evaluate_matches_live_jax(systems):
    """A batch size that leaves a partial last batch (8 samples in 6 + 2)."""
    data = synthetic.make_dataset("cls", 8, seed=30)
    jdata = jsyn.make_dataset("cls", 8, seed=30)
    jsv, sv = _evaluators(systems, (0.5, 0.4))
    want = jsv.evaluate("cls", jdata, batch_size=B)
    got = sv.evaluate("cls", data, batch_size=B)
    for key in ("performance", "latency_s", "offload_rate"):
        assert got[key] == pytest.approx(want[key], rel=1e-6), key
    np.testing.assert_array_equal(got["offload"], want["offload"])
    np.testing.assert_array_equal(got["per_sample_simi"],
                                  want["per_sample_simi"])
    np.testing.assert_allclose(got["per_sample_latency"],
                               want["per_sample_latency"], rtol=1e-6)


def _similarity_inputs():
    rng = np.random.default_rng(7)
    dist_s = rng.random((4, 3, 9), np.float32)
    dist_g = rng.random((4, 3, 9), np.float32)
    pred = rng.integers(0, 3, (5,)).astype(np.int32)
    label = rng.integers(0, 3, (5,))
    pmask = rng.random((5, 16)) < 0.4
    tmask = rng.random((5, 16)) < 0.4
    pmask[2] = tmask[2] = False            # an empty union
    return dist_s, dist_g, pred, label, pmask, tmask


@pytest.mark.parametrize("fn", ["cosine", "output_similarity", "simi_exact",
                                "simi_region_iou", "task_simi"])
def test_similarity_matches_jax(fn):
    dist_s, dist_g, pred, label, pmask, tmask = _similarity_inputs()
    t = torch.from_numpy
    cases = {
        "cosine": [((dist_s, dist_g), {})],
        "output_similarity": [((dist_s, dist_g), {})],
        "simi_exact": [((pred, label), {})],
        "simi_region_iou": [((pmask, tmask), {})],
        "task_simi": [(("vqa", pred, label), {}), (("cls", pred, label), {}),
                      (("det", pmask, tmask), {})],
    }[fn]
    for args, kw in cases:
        want = np.asarray(getattr(JS, fn)(
            *[jnp.asarray(a) if isinstance(a, np.ndarray) else a
              for a in args], **kw))
        got = getattr(S, fn)(*[t(a) if isinstance(a, np.ndarray) else a
                               for a in args], **kw).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if fn == "simi_region_iou":
        assert got[2] == 0.0
    if fn == "task_simi":
        with pytest.raises(ValueError):
            S.task_simi("seg", t(pred), t(label))


def _tabi_split(s, task):
    """A Tabi threshold between the batch's own confidences."""
    jsv, _ = _evaluators(s, (0.0, 0.0))
    (jim, jpr), _ = _batch(s["data"][task])
    probs = np.asarray(jsv.run_batch(task, jim, jpr)["sat_probs"])
    return float(np.median(probs.max(-1).mean(-1)))


BASELINES = ["satellite-only", "gs-only", "tabi-0.7", "tabi-split",
             "airg-0.0", "airg-1.0"]


def _baselines(s, which, task):
    ac, jac = s["ac"], s["jac"]
    jcc = JCascadeConfig(answer_vocab=ANSWER_VOCAB)
    cc = CascadeConfig(answer_vocab=ANSWER_VOCAB)
    if which == "satellite-only":
        return (JSatelliteOnly(s["jsat"], jac, jcc),
                SatelliteOnly(s["sat"], ac, cc, device="cpu"))
    if which == "gs-only":
        return (JGSOnly(s["jgs"], jac, jcc, keep_frac=None),
                GSOnly(s["gs"], ac, cc, keep_frac=None, device="cpu"))
    if which.startswith("tabi"):
        th = 0.7 if which == "tabi-0.7" else _tabi_split(s, task)
        return (JTabi(s["jsat"], s["jgs"], jac, jcc, threshold=th),
                Tabi(s["sat"], s["gs"], ac, cc, threshold=th, device="cpu"))
    rho = float(which.split("-")[1])
    return (JAIRG(s["jsat"], s["jgs"], jac, jcc, offload_fraction=rho),
            AIRG(s["sat"], s["gs"], ac, cc, offload_fraction=rho,
                 device="cpu"))


@pytest.mark.parametrize("which", BASELINES)
@pytest.mark.parametrize("task", ["cls", "det"])
def test_baselines_match_live_jax(systems, task, which):
    """The deterministic settings: predictions, latencies and offloads."""
    jb, b = _baselines(systems, which, task)
    (jim, jpr), (im, pr) = _batch(systems["data"][task])
    want = jb.run_batch(jim, jpr, task)
    got = b.run_batch(im, pr, task)
    _compare(got, want, [k for k in ("pred", "offload", "latency_s")
                         if k in want], f"{which} {task}")
    assert set(got) == set(want)
    if which == "tabi-split":
        assert 0 < got["offload"].sum() < B
    if which == "airg-0.0":
        assert not got["offload"].any()
    if which in ("airg-1.0", "gs-only"):
        assert got["offload"].all()


def test_baseline_evaluate_matches_live_jax(systems):
    data = systems["data"]["cls"]
    jb, b = _baselines(systems, "tabi-0.7", "cls")
    want = jb.evaluate("cls", data, batch_size=B)
    got = b.evaluate("cls", data, batch_size=B)
    for key in ("performance", "latency_s", "offload_rate"):
        assert got[key] == pytest.approx(want[key], rel=1e-6), key
    np.testing.assert_array_equal(got["per_sample_simi"],
                                  want["per_sample_simi"])


def test_airg_plan_fraction_matches_jax(systems):
    jb = JAIRG(systems["jsat"], systems["jgs"], systems["jac"])
    b = AIRG(systems["sat"], systems["gs"], systems["ac"], device="cpu")
    for task in TASKS:
        assert b.plan_fraction(task) == jb.plan_fraction(task), task


def test_gs_only_random_drop_downstream_matches_jax(systems, monkeypatch):
    """JAX's realised region mask fed through the port's mask-applying
    helper: the view the GS tier receives and everything downstream."""
    task, keep_frac, seed = "cls", 0.5, 4
    (jim, jpr), (im, pr) = _batch(systems["data"][task])
    jpipe = JOffload(systems["jac"], JCascadeConfig(), None)
    jview = JGroundOnlyPolicy(keep_frac, seed).gs_view(jpipe, task, jim,
                                                       None, None)
    keep = np.array(jview.meta["kept"])
    assert 0 < keep.mean() < 1
    monkeypatch.setattr(
        PP, "random_mask_filter",
        lambda regions, kf, generator, **kw: PP.keep_mask_filter(
            regions, torch.from_numpy(keep), **kw))
    view = GSOnly(systems["gs"], systems["ac"], keep_frac=keep_frac,
                  seed=seed, device="cpu").policy.gs_view(
        OffloadPipeline(systems["ac"], CascadeConfig(), None), task, im,
        None, None)
    np.testing.assert_array_equal(_np(view.meta["kept"]), keep)
    np.testing.assert_allclose(view.bytes_frac, jview.bytes_frac, rtol=1e-6)
    np.testing.assert_allclose(view.kept_frac, jview.kept_frac, rtol=1e-6)
    np.testing.assert_array_equal(_np(view.images), np.asarray(jview.images))
    jcc = JCascadeConfig(answer_vocab=ANSWER_VOCAB)
    want = JGSOnly(systems["jgs"], systems["jac"], jcc, keep_frac=keep_frac,
                   seed=seed).run_batch(jim, jpr, task)
    got = GSOnly(systems["gs"], systems["ac"],
                 CascadeConfig(answer_vocab=ANSWER_VOCAB),
                 keep_frac=keep_frac, seed=seed,
                 device="cpu").run_batch(im, pr, task)
    _compare(got, want, ("pred", "offload", "latency_s"), "gs-only 0.5")


def test_airg_random_selection_downstream_matches_jax(systems):
    """The JAX policy's realised selection at ρ 0.4 fed to the port's
    policy: predictions, offloads and latencies equal."""
    task, rho, seed = "det", 0.4, 2
    (jim, jpr), (im, pr) = _batch(systems["data"][task])
    jmask, _ = JAIRGPolicy(lambda t: rho, seed).decide_initial(task, B, None)
    jmask = np.array(jmask)
    assert 0 < jmask.sum() < B
    jcc = JCascadeConfig(answer_vocab=ANSWER_VOCAB)
    want = JAIRG(systems["jsat"], systems["jgs"], systems["jac"], jcc,
                 offload_fraction=rho, seed=seed).run_batch(jim, jpr, task)
    np.testing.assert_array_equal(want["offload"], jmask)
    b = AIRG(systems["sat"], systems["gs"], systems["ac"],
             CascadeConfig(answer_vocab=ANSWER_VOCAB), offload_fraction=rho,
             seed=seed, device="cpu")
    b.policy.decide_initial = lambda task, batch, visual: (
        torch.from_numpy(jmask), None)
    got = b.run_batch(im, pr, task)
    _compare(got, want, ("pred", "offload", "latency_s"), "airg 0.4")


@pytest.mark.parametrize("draw", ["airg", "region-drop"])
def test_random_draws_reproducible_at_the_set_rate(draw):
    """The port's own draws: equal under one seed, another under another,
    and a rate within 4 standard deviations of the set one over 4096."""
    n, rate = 4096, {"airg": 0.4, "region-drop": 0.5}[draw]

    def sample(seed):
        if draw == "airg":
            mask, _ = AIRGPolicy(lambda t: rate, seed,
                                 device="cpu").decide_initial("cls", n, None)
            return mask
        regions = torch.ones((64, 64, 2, 2, 3))
        g = torch.Generator().manual_seed(seed)
        out, txb, meta = PP.random_mask_filter(regions, rate, g)
        keep = meta["kept"]
        np.testing.assert_array_equal(out[..., 0, 0, 0].numpy(),
                                      keep.float().numpy())
        np.testing.assert_array_equal(txb.numpy(),
                                      keep.sum(-1).float().numpy() * 36.0)
        return keep.reshape(-1)

    a, b, c = sample(3), sample(3), sample(4)
    assert a.shape == (n,) and a.dtype == torch.bool
    assert torch.equal(a, b) and not torch.equal(a, c)
    sigma = (rate * (1 - rate) / n) ** 0.5
    assert abs(a.float().mean().item() - rate) < 4 * sigma


#: stage-1 offloads, whose onboard answers ride the downlink as drafts, and
#: stage-0 offloads, which carry none
SPEC_REQUESTS = [("vqa", (0.0, 1.01)), ("cls", (0.0, 1.01)),
                 ("det", (0.0, 1.01)), ("vqa", (1.01, 0.0)),
                 ("cls", (1.01, 0.0)), ("det", (1.01, 0.0))]


def _record_drafts(monkeypatch, cls, seen):
    orig = cls.attach_draft

    def attach_draft(self, view, sat_tokens):
        out = orig(self, view, sat_tokens)
        seen.append((None if out is None else np.asarray(out).tolist(),
                     view.meta.get("draft_bytes")))
        return out

    monkeypatch.setattr(cls, "attach_draft", attach_draft)


def test_spec_cascade_server_matches_jax_and_the_greedy_server(systems,
                                                               monkeypatch):
    """``CascadeServer(spec_gamma=3)`` against JAX's and against the port's
    spec-off server: tiers, exit stages, tokens, bytes and latencies; the
    piggybacked drafts; the GS spec core's ``spec_stats()``."""
    s = systems
    plan = ContactPlan(contact_fraction_override=1.0)
    jplan = JContactPlan(contact_fraction_override=1.0)
    jseen, seen = [], []
    _record_drafts(monkeypatch, JOffload, jseen)
    _record_drafts(monkeypatch, OffloadPipeline, seen)
    # one server each; the thresholds change between requests through
    # ``cc``, which every server reads per request
    jcc = JCascadeConfig(answer_vocab=ANSWER_VOCAB)
    cc = CascadeConfig(answer_vocab=ANSWER_VOCAB)
    jserver = JCascadeServer(s["jsat"], s["jgs"], s["jac"], s["jconf"], jcc,
                             plan=jplan, spec_gamma=3)
    server = CascadeServer(s["sat"], s["gs"], s["ac"], s["conf"], cc,
                           plan=plan, spec_gamma=3, device="cpu")
    greedy = CascadeServer(s["sat"], s["gs"], s["ac"], s["conf"], cc,
                           plan=plan, device="cpu")
    tiers = set()
    for i, (task, taus) in enumerate(SPEC_REQUESTS):
        data = s["data"][task]
        image, prompt = data["images"][i], int(data["prompts"][i])
        jserver.cc = JCascadeConfig(taus=taus, answer_vocab=ANSWER_VOCAB)
        server.cc = greedy.cc = CascadeConfig(taus=taus,
                                              answer_vocab=ANSWER_VOCAB)
        want = jserver.handle(JRequest(task=task, image=image, prompt=prompt),
                              now=float(i))
        got = server.handle(Request(task=task, image=image, prompt=prompt),
                            now=float(i))
        ref = greedy.handle(Request(task=task, image=image, prompt=prompt),
                            now=float(i))
        for other, name in ((want, "jax"), (ref, "spec-off")):
            msg = f"{task} request {i} taus {taus} against {name}"
            assert got.tier == other.tier, msg
            assert got.exit_stage == other.exit_stage, msg
            np.testing.assert_array_equal(
                np.asarray(got.tokens).reshape(-1),
                np.asarray(other.tokens).reshape(-1), err_msg=msg)
            assert got.tx_bytes == pytest.approx(other.tx_bytes,
                                                 rel=1e-6), msg
            assert got.latency_s == pytest.approx(other.latency_s,
                                                  rel=1e-6), msg
        tiers.add((got.tier, got.exit_stage, task))
    assert tiers == {("ground", 1, t) for t in TASKS} | {
        ("ground", 0, t) for t in TASKS}
    assert seen == jseen
    assert [d is None for d, _ in seen] == [False] * 3 + [True] * 3
    assert all(b == 4 * len(d) for d, b in seen[:3])
    ps = server._gs_spec_core.spec_stats()
    assert ps == pytest.approx(jserver._gs_spec_core.spec_stats(),
                               rel=1e-12)
    assert ps["piggybacked"] > 0
