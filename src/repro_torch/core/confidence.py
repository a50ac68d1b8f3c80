"""Progressive confidence network g̃ (§3.1), inference.

A shared MLP trunk ``M`` with ``I`` stage-specific input projections
``{L_i}``: stage 1 scores from pooled visual features V(x) alone (before any
decode step); stage i>1 also sees the pooled features of the tokens
generated so far.  A sample whose score falls below τ_i is offloaded and
onboard decoding stops.  The port of ``repro.core.confidence``; training
(Eq. 1) is not ported yet.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.device import DeviceLike, resolve_device

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
