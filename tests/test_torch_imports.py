"""Import hygiene and the device rule of the port.

``import repro_torch`` and every one of its modules must pull in neither
JAX nor the JAX package, and its entry points must run on the card unless
``device="cpu"`` is asked for.
"""
import os
import shutil
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), bad)
"""


def _run(args, cwd, **env):
    full = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), **env)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=full,
                          capture_output=True, text=True, timeout=120)


def test_port_imports_neither_jax_nor_repro():
    out = _run(["-c", _PROBE], cwd=REPO)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 30
    assert bad == "[]"


@pytest.mark.parametrize("module", ["repro_torch", "repro_torch.baselines",
                                    "repro_torch.core.cascade",
                                    "repro_torch.launch.mesh",
                                    "repro_torch.distributed.sharding",
                                    "repro_torch.distributed.collectives",
                                    "repro_torch.serving.sharded",
                                    "repro_torch.train.optimizer",
                                    "repro_torch.train.compression",
                                    "repro_torch.train.trainer",
                                    "repro_torch.train.checkpoint",
                                    "repro_torch.train.elastic",
                                    "repro_torch.core.pipeline"])
def test_entry_modules_import_neither_jax_nor_repro(module):
    """Each entry module alone, in a fresh interpreter."""
    probe = (f"import sys, {module}\n"
             "print(sorted(k for k in sys.modules\n"
             "             if k.split('.')[0] in ('jax', 'jaxlib', 'repro')))")
    out = _run(["-c", probe], cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _rank_modules(rank):
    import repro_torch.serving  # noqa: F401  (the engines a rank runs)
    return sorted(k for k in sys.modules
                  if k.split(".")[0] in ("jax", "jaxlib", "repro"))


def test_spawned_ranks_import_neither_jax_nor_repro():
    """The rank processes of ``spawn_tp`` start from a fresh interpreter
    that imports only the port (and the module of the rank function)."""
    from repro_torch.launch.mesh import spawn_tp
    assert spawn_tp(_rank_modules, 2, backend="gloo", timeout_s=60) \
        == [[], []]


def test_chip_smoke_imports_neither_jax_nor_repro():
    src = open(os.path.join(REPO, "chip_smoke.py")).read()
    for line in src.splitlines():
        words = line.split()
        if words[:1] in (["import"], ["from"]):
            assert words[1].split(".")[0] not in ("jax", "jaxlib", "repro"), \
                line


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """No CUDA device: non-zero exit and no result line.  The same alone in
    a directory without the repo."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = _run([os.path.join(REPO, "chip_smoke.py")], cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), alone)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=alone,
                         capture_output=True, text=True, timeout=120,
                         env={k: v for k, v in os.environ.items()
                              if k != "PYTHONPATH"})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_entry_points_default_to_the_card():
    from repro_torch.configs.spaceverse_pair import proxy_pair
    from repro_torch.core import confidence as C
    from repro_torch.core import eo_adapter as EO
    from repro_torch.models import transformer as T
    sat, _ = proxy_pair("small")
    calls = [lambda: T.init_params(sat),
             lambda: EO.init_adapter(sat, EO.EOAdapterConfig()),
             lambda: C.init_confidence(48, 48, hidden=8)]
    for call in calls:
        if torch.cuda.is_available():
            tree = call()
            leaf = tree["embed"]["tok"] if "embed" in tree else (
                tree["patch_proj"] if "patch_proj" in tree
                else tree["trunk"]["w1"])
            assert leaf.device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                call()
    assert T.init_params(sat, device="cpu")["final_norm"].device.type == "cpu"


def _cascade_entry_points():
    """The Algorithm 1 entry points over tier weights, each with CPU
    weights and its default device."""
    from repro_torch.baselines import AIRG, GSOnly, SatelliteOnly, Tabi
    from repro_torch.configs.spaceverse_pair import proxy_pair
    from repro_torch.core import confidence as C
    from repro_torch.core import eo_adapter as EO
    from repro_torch.core.cascade import SpaceVerse, TierModel
    from repro_torch.serving import CascadeServer
    sat_cfg, gs_cfg = proxy_pair("small")
    ac = EO.EOAdapterConfig()
    sat = TierModel(EO.init_adapter(sat_cfg, ac, 0, device="cpu"), sat_cfg)
    gs = TierModel(EO.init_adapter(gs_cfg, ac, 1, device="cpu"), gs_cfg)
    conf = C.init_confidence(sat_cfg.d_model, sat_cfg.d_model, hidden=8,
                             device="cpu")
    return {"SpaceVerse": lambda **kw: SpaceVerse(sat, gs, ac, conf, **kw),
            "SatelliteOnly": lambda **kw: SatelliteOnly(sat, ac, **kw),
            "GSOnly": lambda **kw: GSOnly(gs, ac, keep_frac=0.5, **kw),
            "Tabi": lambda **kw: Tabi(sat, gs, ac, **kw),
            "AIRG": lambda **kw: AIRG(sat, gs, ac, **kw),
            "CascadeServer(spec_gamma=3)": lambda **kw: CascadeServer(
                sat, gs, ac, conf, spec_gamma=3, **kw)}


def test_cascade_entry_points_default_to_the_card():
    """``SpaceVerse``, the baselines and the speculative server: the card by
    default (without one they raise; with one they refuse CPU weights),
    and ``device="cpu"`` runs on the CPU."""
    for name, make in _cascade_entry_points().items():
        if torch.cuda.is_available():
            with pytest.raises(ValueError, match="weights lie on"):
                make()
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                make()
        assert make(device="cpu") is not None, name


def test_training_entry_points_default_to_the_card():
    """``init_train_state`` and ``build_system`` run on the card by default
    (without one they raise) and on the CPU when asked."""
    from repro_torch.configs.spaceverse_pair import proxy_pair
    from repro_torch.core import pipeline as P
    from repro_torch.train import trainer as TR
    sat, _ = proxy_pair("small")
    if torch.cuda.is_available():
        params, state = TR.init_train_state(sat)
        assert params["final_norm"].device.type == "cuda"
        assert state["step"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            TR.init_train_state(sat)
        with pytest.raises(RuntimeError, match="CUDA"):
            P.build_system(n_train=4, n_test=4, proxy_steps=1, conf_steps=1)
    params, state = TR.init_train_state(sat, device="cpu")
    assert state["m"]["final_norm"].dtype == torch.float32
    assert int(state["step"]) == 0
