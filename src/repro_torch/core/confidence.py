"""Progressive confidence network g̃ (§3.1), inference.

A shared MLP trunk ``M`` with ``I`` stage-specific input projections
``{L_i}``: stage 1 scores from pooled visual features V(x) alone (before any
decode step); stage i>1 also sees the pooled features of the tokens
generated so far.  A sample whose score falls below τ_i is offloaded and
onboard decoding stops.  The port of ``repro.core.confidence``, with its
training: Eq. (1), Σ_i MSE(g̃_i(V(x), A_{i−1}), cos(ŷ^s, ŷ^g)), by Adam on
a small supervision split (``train_confidence``).  Its minibatch draws come
from ``draw_rows`` on an explicit ``torch.Generator`` (the JAX package
draws threefry bits: the tests feed JAX's draws through it).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.tree import tree_leaves, tree_map

Params = Dict[str, Any]


def init_confidence(d_visual: int, d_state: int, hidden: int = 128,
                    num_stages: int = 2, seed: int = 0, *,
                    device: DeviceLike = None) -> Params:
    """L_1: d_visual → hidden;  L_i (i>1): d_visual + d_state → hidden;
    trunk M: hidden → hidden → 1.  float32, from a ``torch.Generator``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(shape, fan_in):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32) * fan_in ** -0.5

    projs = []
    for i in range(num_stages):
        d_in = d_visual if i == 0 else d_visual + d_state
        projs.append({"w": normal((d_in, hidden), d_in),
                      "b": torch.zeros((hidden,), device=dev)})
    return {
        "projs": projs,
        "trunk": {"w1": normal((hidden, hidden), hidden),
                  "b1": torch.zeros((hidden,), device=dev),
                  "w2": normal((hidden, 1), hidden),
                  "b2": torch.zeros((1,), device=dev)},
    }


def num_stages(params: Params) -> int:
    return len(params["projs"])


def apply_stage(params: Params, stage: int, visual: torch.Tensor,
                state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """g̃_{stage+1}.  visual: (B, d_visual) pooled V(x); state: (B, d_state)
    pooled features of the tokens generated so far (None for stage 0).
    Returns (B,) predicted similarity in [0, 1]."""
    x = visual.float()
    if stage > 0:
        if state is None:
            raise ValueError("stage > 0 needs generated-token features")
        x = torch.cat([x, state.float()], dim=-1)
    p = params["projs"][stage]
    h = torch.relu(x @ p["w"] + p["b"])
    t = params["trunk"]
    h = torch.relu(h @ t["w1"] + t["b1"])
    return torch.sigmoid((h @ t["w2"] + t["b2"])[..., 0])


def loss_fn(params: Params, visual: torch.Tensor,
            states: Sequence[torch.Tensor], target: torch.Tensor
            ) -> torch.Tensor:
    """Eq. (1): Σ_i MSE(g̃_i(·), cos-sim target).  ``states[i]`` is the
    pooled token features available to stage i+1 (num_stages − 1 of
    them)."""
    total = torch.mean((apply_stage(params, 0, visual) - target) ** 2)
    for i, st in enumerate(states):
        pred = apply_stage(params, i + 1, visual, st)
        total = total + torch.mean((pred - target) ** 2)
    return total


def draw_rows(gen: torch.Generator, n: int, size: int) -> torch.Tensor:
    """A minibatch of ``size`` row indices in [0, n), with replacement
    (``jax.random.randint``'s role), from ``gen``'s device."""
    return torch.randint(0, n, (size,), generator=gen, device=gen.device)


def train_confidence(params: Params, visual: torch.Tensor,
                     states: Sequence[torch.Tensor], target: torch.Tensor, *,
                     steps: int = 300, lr: float = 1e-2, batch: int = 64,
                     seed: int = 0) -> Tuple[Params, List[float]]:
    """Adam on Eq. (1) over a small supervision split (paper: 5% of train).
    The minibatches come from ``draw_rows`` on a CPU generator seeded with
    ``seed``, so a run's draws do not depend on the device it trains on.
    Returns (new params, per-step losses)."""
    n = visual.shape[0]
    gen = torch.Generator().manual_seed(seed)
    m = tree_map(torch.zeros_like, params)
    v = tree_map(torch.zeros_like, params)
    b1, b2, eps = 0.9, 0.999, 1e-8
    losses = []
    for t in range(1, steps + 1):
        idx = draw_rows(gen, n, min(batch, n)).to(visual.device)
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        it = iter(leaves)
        with torch.enable_grad():
            loss = loss_fn(tree_map(lambda _: next(it), params), visual[idx],
                           [s[idx] for s in states], target[idx])
        grads = iter(torch.autograd.grad(loss, leaves))
        g = tree_map(lambda _: next(grads), params)
        m = tree_map(lambda m_, g_: b1 * m_ + (1 - b1) * g_, m, g)
        v = tree_map(lambda v_, g_: b2 * v_ + (1 - b2) * g_ * g_, v, g)
        tt = torch.tensor(float(t), dtype=torch.float32)
        mh = tree_map(lambda m_: m_ / (1 - b1 ** tt).to(m_.device), m)
        vh = tree_map(lambda v_: v_ / (1 - b2 ** tt).to(v_.device), v)
        params = tree_map(lambda p, mh_, vh_: (p - lr * mh_
                                               / (torch.sqrt(vh_) + eps)),
                          params, mh, vh)
        losses.append(float(loss.detach()))
    return params, losses
