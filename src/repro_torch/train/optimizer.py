"""AdamW with a warmup + cosine schedule and global-norm clipping.

The port of ``repro.train.optimizer``: the moments ``m`` and ``v`` are
float32 trees shaped as the parameters, the step an int32 scalar, and the
update is computed in float32 and cast back to each parameter's dtype, as
in the JAX package.  Unlike JAX's functional update, ``apply_updates``
writes the new parameters and moments into the tensors it was given (the
same tree objects come back): at the 2B's width a second copy of the
parameters and moments would cost ~15 GB.  The ZeRO-1 sharding of the
moments is not ported.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map

Params = Any


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def init_opt_state(params: Params) -> Dict[str, Any]:
    """Zero moments (float32, on each parameter's device) and step 0."""
    def zeros32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = tree_leaves(params)[0].device
    return {"m": tree_map(zeros32, params), "v": tree_map(zeros32, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor), float32, on its device."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, float32."""
    total = None
    for g in tree_leaves(tree):
        sq = (g.float() ** 2).sum()
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(grads: Params, max_norm: float
                        ) -> Tuple[Params, torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


@torch.no_grad()
def apply_updates(params: Params, grads: Params, opt_state: Dict[str, Any],
                  cfg: OptConfig) -> Tuple[Params, Dict[str, Any],
                                           Dict[str, torch.Tensor]]:
    """One AdamW step, in place: returns (params, opt_state, {"grad_norm",
    "lr"}); ``params`` and the moments are the tensors given, updated."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = opt_state["step"] + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()

    def upd(p, g, m, v):
        gf = g.float()
        m.copy_(b1 * m + (1 - b1) * gf)
        v.copy_(b2 * v + (1 - b2) * gf * gf)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        pf = p.float()
        p.copy_((pf - lr * (delta + cfg.weight_decay * pf)).to(p.dtype))

    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(opt_state["m"]),
                          tree_leaves(opt_state["v"])):
        upd(p, g, m, v)
    opt_state = dict(opt_state, step=step)
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
