"""The port's ``CascadeServer`` against the live JAX ``CascadeServer``.

Both servers run the same bridged random-init proxy weights
(``proxy_pair("small")``, ``EOAdapterConfig()``, a 2-stage confidence net,
``answer_vocab=9``) and answer the same vqa/cls/det requests from
``make_dataset``.  Decisions (tier, exit stage) and tokens must be equal,
bytes and modelled latency within 1e-6 relative, and the Eq. 2 region
scores of the offload view within 1e-5.  The JAX golden file is not used:
the comparison is with the live JAX objects.
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
from repro.core import confidence as JC  # noqa: E402
from repro.core import eo_adapter as JEO  # noqa: E402
from repro.core.cascade import CascadeConfig as JCascadeConfig  # noqa: E402
from repro.core.cascade import TierModel as JTierModel  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.network.orbit import ContactPlan as JContactPlan  # noqa: E402
from repro.serving import CascadeServer as JCascadeServer  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving.engine_core import shared_core as jshared_core  # noqa: E402
from repro.serving.offload import OffloadPipeline as JOffload  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.spaceverse_pair import proxy_pair  # noqa: E402
from repro_torch.core import eo_adapter as EO  # noqa: E402
from repro_torch.core.cascade import CascadeConfig, TierModel  # noqa: E402
from repro_torch.core.latency import LatencyModel  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.network.orbit import ContactPlan  # noqa: E402
from repro_torch.serving import CascadeServer, Request  # noqa: E402
from repro_torch.serving.engine_core import shared_core  # noqa: E402
from repro_torch.serving.offload import OffloadPipeline  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

ANSWER_VOCAB = 9
TAUS = [(0.5, 0.4), (0.0, 1.01), (0.0, 0.0)]


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

    jtiers = (JTierModel(jsat_p, jsat_cfg), JTierModel(jgs_p, jgs_cfg))
    ttiers = (TierModel(carry(jsat_p), sat_cfg),
              TierModel(carry(jgs_p), gs_cfg))
    requests = []
    for i, task in enumerate(("vqa", "cls", "det", "vqa")):
        data = synthetic.make_dataset(task, 1, seed=10 + i)
        jdata = jsyn.make_dataset(task, 1, seed=10 + i)
        np.testing.assert_array_equal(data["images"], jdata["images"])
        requests.append((task, data["images"][0], int(data["prompts"][0])))
    return jtiers, jac, jconf, ttiers, ac, carry(jconf), requests


@pytest.mark.parametrize("taus", TAUS)
def test_cascade_server_matches_live_jax(systems, taus):
    jtiers, jac, jconf, ttiers, ac, conf, requests = systems
    jserver = JCascadeServer(
        *jtiers, jac, jconf, JCascadeConfig(taus=taus,
                                            answer_vocab=ANSWER_VOCAB),
        plan=JContactPlan(contact_fraction_override=1.0))
    server = CascadeServer(
        *ttiers, ac, conf, CascadeConfig(taus=taus,
                                         answer_vocab=ANSWER_VOCAB),
        latency=LatencyModel(),
        plan=ContactPlan(contact_fraction_override=1.0), device="cpu")
    seen = set()
    for i, (task, image, prompt) in enumerate(requests):
        want = jserver.handle(JRequest(task=task, image=image, prompt=prompt),
                              now=float(i))
        got = server.handle(Request(task=task, image=image, prompt=prompt),
                            now=float(i))
        msg = f"{task} request {i} taus {taus}"
        assert got.tier == want.tier, msg
        assert got.exit_stage == want.exit_stage, msg
        np.testing.assert_array_equal(np.asarray(got.tokens).reshape(-1),
                                      np.asarray(want.tokens).reshape(-1),
                                      err_msg=msg)
        assert got.tx_bytes == pytest.approx(want.tx_bytes, rel=1e-6), msg
        assert got.latency_s == pytest.approx(want.latency_s, rel=1e-6), msg
        seen.add((got.tier, got.exit_stage))
    if taus == (0.0, 1.01):
        assert seen == {("ground", 1)}         # stage-1 offloads via Eq. 2/3
    if taus == (0.0, 0.0):
        assert seen == {("satellite", -1)}     # onboard answers
    if taus == (0.5, 0.4):
        assert ("ground", 0) in seen           # a stage-0 offload


def test_offload_view_matches_live_jax(systems):
    """Eq. 2 region scores (within 1e-5) and the Eq. 3 view the GS tier
    receives, from each package's own satellite encode."""
    jtiers, jac, _, ttiers, ac, _, requests = systems
    cc = CascadeConfig(answer_vocab=ANSWER_VOCAB)
    jpipe = JOffload(jac, JCascadeConfig(answer_vocab=ANSWER_VOCAB), None)
    pipe = OffloadPipeline(ac, cc, LatencyModel())
    for task, image, prompt in requests:
        jimg = jnp.asarray(image[None])
        jprm = jnp.asarray(np.array([prompt], np.int32))
        rf, tf, vis = jshared_core(jtiers[0], jac).encode(task, jimg, jprm)
        img = torch.from_numpy(image[None])
        prm = torch.tensor([prompt], dtype=torch.int32)
        trf, ttf, tvis = shared_core(ttiers[0], ac).encode(task, img, prm)
        np.testing.assert_allclose(tvis.numpy(), np.asarray(vis), rtol=0,
                                   atol=1e-5)
        want = jpipe.multiscale_view(task, jimg, rf, tf)
        got = pipe.multiscale_view(task, img, trf, ttf)
        np.testing.assert_allclose(got.region_scores.numpy(),
                                   np.asarray(want.region_scores), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(got.bytes_frac, want.bytes_frac,
                                   rtol=1e-6)
        np.testing.assert_allclose(got.kept_frac, want.kept_frac, rtol=1e-6)
        np.testing.assert_allclose(got.images.numpy(),
                                   np.asarray(want.images), rtol=0,
                                   atol=1e-6)


def test_server_refuses_weights_on_another_device(systems):
    _, _, _, ttiers, ac, conf, _ = systems
    # spec_gamma > 0 builds the speculative GS core on the server's device
    spec = CascadeServer(*ttiers, ac, conf, spec_gamma=2,
                         device="cpu")._gs_spec_core
    assert spec.cfg.spec_gamma == 2 and spec.device.type == "cpu"
    assert spec.tier is ttiers[1] and spec.draft is ttiers[0]
    # the default device is the card: without one the server raises, with
    # one it refuses these CPU weights
    err = ValueError if torch.cuda.is_available() else RuntimeError
    with pytest.raises(err):
        CascadeServer(*ttiers, ac, conf)
