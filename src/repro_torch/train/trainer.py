"""The train step: a remat'd forward, gradient accumulation over
microbatches, optional gradient compression, AdamW.

The port of ``repro.train.trainer``.  ``make_train_step`` returns
``(params, opt_state, batch) → (params, opt_state, metrics)``; the
gradients come from ``torch.autograd.grad`` on detached views of the
parameters (the caller's tensors keep ``requires_grad`` False), and the
update is ``optimizer.apply_updates``, in place.  On the card the
attention's backward is the hand-written flash backward kernel
(``kernels/flash_attention.py::FlashAttentionFn``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as T
from repro_torch.train import compression as GC
from repro_torch.train import optimizer as O
from repro_torch.tree import tree_leaves, tree_map

Params = Any


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1            # grad accumulation steps per update
    remat: bool = True
    remat_policy: str = "nothing"    # see transformer.REMAT_POLICIES
    ce_chunks: int = 8
    # default_factory, not a shared class-level instance (SL004)
    compression: GC.CompressionConfig = dataclasses.field(
        default_factory=GC.CompressionConfig)


def make_loss_fn(cfg: ArchConfig, train_cfg: TrainConfig) -> Callable:
    def loss(params, batch):
        return T.loss_fn(params, cfg, batch, remat=train_cfg.remat,
                         remat_policy=train_cfg.remat_policy,
                         ce_chunks=train_cfg.ce_chunks)
    return loss


def value_and_grad(loss_fn: Callable, params: Params, *args
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Params]:
    """``loss_fn(params, *args)`` → (loss, aux dict, grads), the gradients
    shaped and typed as the parameters (zeros for a leaf the loss does not
    reach), everything detached."""
    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    it = iter(leaves)
    with torch.enable_grad():
        loss, aux = loss_fn(tree_map(lambda _: next(it), params), *args)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = iter([torch.zeros_like(w) if g is None else g
                  for w, g in zip(leaves, grads)])
    aux = {k: v.detach() for k, v in aux.items()}
    return loss.detach(), aux, tree_map(lambda _: next(grads), params)


def make_train_step(cfg: ArchConfig, opt_cfg: O.OptConfig,
                    train_cfg: TrainConfig = None) -> Callable:
    train_cfg = train_cfg or TrainConfig()
    loss_fn = make_loss_fn(cfg, train_cfg)

    def train_step(params: Params, opt_state: Dict[str, Any],
                   batch: Dict[str, torch.Tensor]
                   ) -> Tuple[Params, Dict[str, Any], Dict[str, torch.Tensor]]:
        mb = train_cfg.microbatches
        if mb <= 1:
            loss, metrics, grads = value_and_grad(loss_fn, params, batch)
        else:
            # split the batch into microbatches and sum their gradients in
            # float32, as JAX's scan over microbatches does
            n = next(iter(batch.values())).shape[0] // mb
            grads = tree_map(lambda p: torch.zeros(p.shape,
                                                   dtype=torch.float32,
                                                   device=p.device), params)
            loss, ms = None, []
            for i in range(mb):
                micro = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                l, m, g = value_and_grad(loss_fn, params, micro)
                grads = tree_map(torch.add, grads, g)
                loss = l if loss is None else loss + l
                ms.append(m)
            grads = tree_map(lambda g: g / mb, grads)
            loss = loss / mb
            metrics = {k: torch.stack([m[k] for m in ms]).mean()
                       for k in ms[0]}

        err = None
        if train_cfg.compression.scheme != "none":
            grads, err = GC.compress_grads(grads, opt_state.get("err"),
                                           train_cfg.compression)
        params, new_opt, stats = O.apply_updates(
            params, grads, {k: v for k, v in opt_state.items()
                            if k != "err"}, opt_cfg)
        if err is not None:
            new_opt["err"] = err
        metrics = dict(metrics)
        metrics.update(stats)
        metrics["loss"] = loss
        return params, new_opt, metrics

    return train_step


def init_train_state(cfg: ArchConfig, seed: int = 0,
                     train_cfg: TrainConfig = None, *,
                     device: DeviceLike = None
                     ) -> Tuple[Params, Dict[str, Any]]:
    """Random weights from ``seed`` (``transformer.init_params``) on
    ``device`` (the card unless ``"cpu"`` is asked for) and their fresh
    optimizer state (with an error-feedback state when the compression
    keeps one)."""
    train_cfg = train_cfg or TrainConfig()
    params = T.init_params(cfg, seed, device=resolve_device(device))
    opt_state = O.init_opt_state(params)
    if train_cfg.compression.scheme != "none" \
            and train_cfg.compression.error_feedback:
        opt_state["err"] = GC.init_error_state(params)
    return params, opt_state
