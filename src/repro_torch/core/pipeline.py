"""End-to-end system assembly: train the two proxy LVLM tiers on synthetic
EO tasks, supervise the progressive confidence net on a small split
(paper: 5 % of train), and assemble SpaceVerse.

The port of ``repro.core.pipeline``.  Its random draws differ from the JAX
package's (a ``torch.Generator`` where JAX splits threefry keys) and all
go through the module-level helpers ``init_tier`` / ``init_conf`` (the
weights) and ``draw_batch`` / ``draw_keep`` (each step's minibatch and
region-dropout mask), and ``confidence.draw_rows``: the tests feed JAX's
realised draws through them.  Every draw is made on a CPU generator seeded
from ``seed`` and then moved to ``device``, so a run on the card draws what
a CPU run draws.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.spaceverse_pair import proxy_pair
from repro_torch.core import confidence as C
from repro_torch.core import eo_adapter as EO
from repro_torch.core.cascade import CascadeConfig, SpaceVerse, TierModel
from repro_torch.core.latency import LatencyModel
from repro_torch.core.similarity import output_similarity
from repro_torch.data import synthetic
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as T
from repro_torch.train import optimizer as O
from repro_torch.train.trainer import value_and_grad
from repro_torch.tree import tree_map

TASKS = ("vqa", "cls", "det")


@dataclasses.dataclass
class SystemBundle:
    sat: TierModel
    gs: TierModel
    adapter_cfg: EO.EOAdapterConfig
    conf_params: Any
    cascade_cfg: CascadeConfig
    latency: LatencyModel
    datasets: Dict[str, Dict[str, np.ndarray]]       # task → test data
    train_datasets: Dict[str, Dict[str, np.ndarray]]
    history: Dict[str, Any]
    device: torch.device                             # where the weights lie

    def spaceverse(self, **overrides) -> SpaceVerse:
        cc = dataclasses.replace(self.cascade_cfg, **overrides) \
            if overrides else self.cascade_cfg
        return SpaceVerse(self.sat, self.gs, self.adapter_cfg,
                          self.conf_params, cc, self.latency,
                          device=self.device)


# ---------------------------------------------------------------------------
# The random draws
# ---------------------------------------------------------------------------

def init_tier(backbone_cfg: ArchConfig, adapter_cfg: EO.EOAdapterConfig,
              gen: torch.Generator, device: torch.device) -> Dict:
    """A tier's initial weights (``eo_adapter.init_adapter_with``) drawn on
    ``gen``'s device, then moved to ``device``."""
    params = EO.init_adapter_with(backbone_cfg, adapter_cfg, gen, gen.device)
    return tree_map(lambda t: t.to(device), params)


def init_conf(d_visual: int, d_state: int, num_stages: int, seed: int,
              device: torch.device) -> Dict:
    """The confidence net's initial weights, drawn on the CPU from ``seed``
    and moved to ``device``."""
    conf = C.init_confidence(d_visual, d_state, hidden=64,
                             num_stages=num_stages, seed=seed, device="cpu")
    return tree_map(lambda t: t.to(device), conf)


def draw_batch(gen: torch.Generator, n: int, batch_size: int) -> np.ndarray:
    """A step's minibatch: the first ``batch_size`` rows of a permutation of
    ``n`` (``jax.random.permutation``'s role)."""
    return torch.randperm(n, generator=gen)[:batch_size].numpy()


def draw_keep(gen: torch.Generator, shape: Tuple[int, ...],
              region_dropout: float) -> torch.Tensor:
    """The region-dropout mask: True where a region is kept (a uniform draw
    at or above the rate), bool, on ``gen``'s device."""
    return torch.rand(shape, generator=gen) >= region_dropout


# ---------------------------------------------------------------------------
# Proxy LVLM training
# ---------------------------------------------------------------------------

def _task_batch(adapter_cfg: EO.EOAdapterConfig, task: str,
                data: Dict[str, np.ndarray], idx: np.ndarray, dtype,
                device: torch.device) -> Dict[str, torch.Tensor]:
    """Teacher-forced batch with raw region pixels (the projector trains
    end to end)."""
    def rows(name):
        return torch.from_numpy(data[name][idx]).to(device)

    answers = EO.answers_from_labels(adapter_cfg, task, rows("labels"),
                                     rows("region_rel"))
    regions = synthetic.regions_of(rows("images"), adapter_cfg.grid)
    b, r = regions.shape[:2]
    return dict(EO.teacher_forced(adapter_cfg, task, rows("prompts"),
                                  answers),
                raw_regions=regions.reshape(b, r, -1).to(dtype))


def train_proxy(backbone_cfg: ArchConfig, adapter_cfg: EO.EOAdapterConfig,
                train_data: Dict[str, Dict[str, np.ndarray]], *,
                steps: int = 300, batch_size: int = 16, lr: float = 3e-3,
                region_dropout: float = 0.2, seed: int = 0,
                device: DeviceLike = None) -> Tuple[Dict, List[float]]:
    """Multi-task training of one tier (patch projector + backbone), one
    task a step in turn.  ``region_dropout`` zeroes random regions so that
    inference on Eq. 3-filtered images is in distribution.  Returns (the
    adapter params on ``device``, per-step losses)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    params = init_tier(backbone_cfg, adapter_cfg, gen, dev)
    opt_cfg = O.OptConfig(lr=lr, warmup_steps=max(steps // 20, 5),
                          total_steps=steps, weight_decay=0.0)
    opt_state = O.init_opt_state(params)

    def loss_fn(params, batch):
        model_batch = {k: v for k, v in batch.items() if k != "raw_regions"}
        model_batch["patch_embeds"] = batch["raw_regions"] @ \
            params["patch_proj"]
        return T.loss_fn(params["backbone"], backbone_cfg, model_batch,
                         remat=False)

    losses = []
    tasks = [t for t in TASKS if t in train_data]
    dtype = params["patch_proj"].dtype
    for s in range(steps):
        task = tasks[s % len(tasks)]
        idx = draw_batch(gen, train_data[task]["images"].shape[0],
                         batch_size)
        batch = _task_batch(adapter_cfg, task, train_data[task], idx, dtype,
                            dev)
        if region_dropout > 0:
            keep = draw_keep(gen, tuple(batch["raw_regions"].shape[:2]),
                             region_dropout)
            batch["raw_regions"] = batch["raw_regions"] * \
                keep[..., None].to(device=dev, dtype=dtype)
        loss, _, grads = value_and_grad(loss_fn, params, batch)
        params, opt_state, _ = O.apply_updates(params, grads, opt_state,
                                               opt_cfg)
        losses.append(float(loss))
    return params, losses


# ---------------------------------------------------------------------------
# Confidence-net supervision (§3.1.4)
# ---------------------------------------------------------------------------

def build_confidence_data(sat: TierModel, gs: TierModel,
                          adapter_cfg: EO.EOAdapterConfig,
                          data: Dict[str, np.ndarray], task: str,
                          answer_vocab: int, batch_size: int = 32,
                          device: DeviceLike = None):
    """Run both tiers on the supervision split; target = cos(ŷ^s, ŷ^g).
    Returns numpy (pooled visual features, pooled generated-token
    features, targets)."""
    dev = resolve_device(device)
    n = data["images"].shape[0]
    vis, states, tgts = [], [], []
    with torch.inference_mode():
        for i in range(0, n, batch_size):
            sl = slice(i, min(i + batch_size, n))
            images = torch.from_numpy(data["images"][sl]).to(dev)
            prompts = torch.from_numpy(data["prompts"][sl]).to(dev)
            rf = EO.encode_regions(sat.params, adapter_cfg, images)
            vis.append(rf.float().mean(1).cpu().numpy())
            s_toks, s_probs = EO.generate(sat.params, sat.cfg, adapter_cfg,
                                          task, images, prompts,
                                          answer_vocab)
            _, g_probs = EO.generate(gs.params, gs.cfg, adapter_cfg, task,
                                     images, prompts, answer_vocab)
            states.append(EO.token_features(sat.params, s_toks).cpu()
                          .numpy())
            tgts.append(output_similarity(s_probs, g_probs).cpu().numpy())
    return (np.concatenate(vis), np.concatenate(states),
            np.concatenate(tgts))


def train_confidence_net(sat: TierModel, gs: TierModel,
                         adapter_cfg: EO.EOAdapterConfig,
                         train_data: Dict[str, Dict[str, np.ndarray]],
                         answer_vocab: int, *, frac: float = 0.05,
                         num_stages: int = 2, steps: int = 400,
                         seed: int = 0, device: DeviceLike = None):
    dev = resolve_device(device)
    vis_all, st_all, tgt_all = [], [], []
    for task, data in train_data.items():
        n = max(int(data["images"].shape[0] * frac), 16)
        sub = {k: v[:n] for k, v in data.items() if isinstance(v, np.ndarray)}
        v, s, t = build_confidence_data(sat, gs, adapter_cfg, sub, task,
                                        answer_vocab, device=dev)
        vis_all.append(v)
        st_all.append(s)
        tgt_all.append(t)
    vis = torch.from_numpy(np.concatenate(vis_all)).to(dev)
    st = torch.from_numpy(np.concatenate(st_all)).to(dev)
    tgt = torch.from_numpy(np.concatenate(tgt_all)).to(dev)
    conf = init_conf(vis.shape[-1], st.shape[-1], num_stages, seed, dev)
    # stages 2..I all see pooled generated-token features
    states = [st] * (num_stages - 1)
    return C.train_confidence(conf, vis, states, tgt, steps=steps, seed=seed)


# ---------------------------------------------------------------------------
# Full assembly
# ---------------------------------------------------------------------------

def build_system(*, scale: str = "small", n_train: int = 256,
                 n_test: int = 128, proxy_steps: int = 250,
                 conf_steps: int = 300, seed: int = 0,
                 tasks: Tuple[str, ...] = TASKS,
                 grid: int = 4, image_size: int = 64,
                 cascade_cfg: Optional[CascadeConfig] = None,
                 device: DeviceLike = None) -> SystemBundle:
    """Train both proxy tiers and the confidence net on ``device`` (the
    card unless ``"cpu"`` is asked for) and assemble the system."""
    dev = resolve_device(device)
    sat_cfg, gs_cfg = proxy_pair(scale)
    adapter_cfg = EO.EOAdapterConfig(grid=grid, image_size=image_size)
    eo_cfg = synthetic.EOTaskConfig(image_size=image_size, grid=grid,
                                    num_classes=adapter_cfg.num_classes)
    train_data = {t: synthetic.make_dataset(t, n_train, seed=seed + i,
                                            cfg=eo_cfg)
                  for i, t in enumerate(tasks)}
    test_data = {t: synthetic.make_dataset(t, n_test, seed=seed + 100 + i,
                                           cfg=eo_cfg)
                 for i, t in enumerate(tasks)}

    cc = cascade_cfg or CascadeConfig(
        answer_vocab=max(adapter_cfg.num_classes + 1, 2))

    sat_params, sat_losses = train_proxy(sat_cfg, adapter_cfg, train_data,
                                         steps=proxy_steps, seed=seed,
                                         device=dev)
    # the GS tier trains longer at a gentler LR (deeper model), preserving
    # the paper's |W^g| > |W^s| quality ordering
    gs_params, gs_losses = train_proxy(gs_cfg, adapter_cfg, train_data,
                                       steps=int(proxy_steps * 1.5),
                                       lr=2e-3, seed=seed + 1, device=dev)
    sat = TierModel(sat_params, sat_cfg)
    gs = TierModel(gs_params, gs_cfg)

    conf, conf_losses = train_confidence_net(
        sat, gs, adapter_cfg, train_data, cc.answer_vocab,
        num_stages=len(cc.taus), steps=conf_steps, seed=seed, device=dev)

    return SystemBundle(
        sat=sat, gs=gs, adapter_cfg=adapter_cfg, conf_params=conf,
        cascade_cfg=cc, latency=LatencyModel(),
        datasets=test_data, train_datasets=train_data,
        history={"sat_losses": sat_losses, "gs_losses": gs_losses,
                 "conf_losses": conf_losses},
        device=dev)
