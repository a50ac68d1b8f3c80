"""The serving tensor-parallel plan and the backbone's shard rules.

The port's counterpart of the serving half of
``repro.distributed.sharding``: ``tp_serving_plan`` decides what splits
over the mesh's ``"model"`` axis (the same rules as JAX's), the shard
rules name which backbone leaf splits on which dimension (the counterpart
of ``serving_param_specs``), ``shard_backbone`` cuts rank ``r``'s
contiguous block, and ``kv_head_block`` gives the KV heads its page pools
hold (the counterpart of ``paged_kv_leaf_spec``).  The training and
dry-run rules (``param_specs``, ``zero1_specs``, ``batch_specs``,
``cache_specs``) are not ported (ROADMAP queue 1, items 12, 16 and 19).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ATTN, ArchConfig

Params = Any


def mesh_axis_size(mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 1


def data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


@dataclasses.dataclass(frozen=True)
class TPServingPlan:
    """What the serving engine shards over the mesh's "model" axis.

    ``attn``: q/k/v/o projections and the paged KV pools split by
    (KV-)heads: both head counts divisible by ``tp`` (dividing only the
    q-heads would break the contiguous GQA head-to-group mapping) and a
    pure-attention block pattern.  ``mlp``: the dense FFN's hidden dim
    split: ``d_ff`` divisible and no MoE blocks.  ``cfg_local`` is the
    config every rank's step runs the model with: head counts (and
    ``d_ff``) divided by ``tp``, ``head_dim`` pinned to the global value
    (``resolved_head_dim`` would otherwise grow by ``tp``)."""
    tp: int
    attn: bool
    mlp: bool
    cfg_local: ArchConfig


def tp_serving_plan(cfg: ArchConfig, mesh) -> TPServingPlan:
    tp = mesh_axis_size(mesh, "model")
    all_attn = all(s.kind == ATTN for s in cfg.block_pattern)
    no_moe = not any(s.moe for s in cfg.block_pattern)
    attn = (tp > 1 and all_attn and cfg.num_heads % tp == 0
            and cfg.num_kv_heads % tp == 0)
    mlp = tp > 1 and all_attn and no_moe and cfg.d_ff > 0 \
        and cfg.d_ff % tp == 0
    over: Dict[str, Any] = {}
    if attn:
        over.update(head_dim=cfg.resolved_head_dim,
                    num_heads=cfg.num_heads // tp,
                    num_kv_heads=cfg.num_kv_heads // tp)
    if mlp:
        over.update(d_ff=cfg.d_ff // tp)
    cfg_local = dataclasses.replace(cfg, **over) if over else cfg
    return TPServingPlan(tp=tp, attn=attn, mlp=mlp, cfg_local=cfg_local)


#: the split leaves of a block: (sublayer, leaf) → the dimension of the
#: stacked (n_super, rows, cols) leaf that splits.  Only sublayers whose
#: partial outputs the model all-reduces (``collectives``) may split.
SPLITS = {("mixer", "wq"): 2, ("mixer", "wk"): 2, ("mixer", "wv"): 2,
          ("mixer", "wo"): 1, ("ffn", "wg"): 2, ("ffn", "wu"): 2,
          ("ffn", "wd"): 1}


def split_dim(plan: TPServingPlan, path: Tuple, leaf: torch.Tensor
              ) -> Optional[int]:
    """The dimension leaf ``path`` of a backbone splits on under ``plan``
    (``None``: replicated).  ``path`` is the tuple of keys from the
    backbone's root, e.g. ``("blocks", 0, "mixer", "wq")``."""
    if not path or path[0] != "blocks" or leaf.dim() != 3:
        return None
    dim = SPLITS.get(tuple(path[-2:]))
    kind = path[-2]
    if dim is None or not (plan.attn if kind == "mixer" else plan.mlp):
        return None
    return dim


def _map_with_path(fn, tree: Any, path: Tuple = ()) -> Any:
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in
                tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def split_dims(plan: TPServingPlan, params: Params) -> Params:
    """The tree of ``split_dim`` for every leaf of a backbone."""
    return _map_with_path(lambda p, x: split_dim(plan, p, x), params)


def shard_backbone(params: Params, plan: TPServingPlan, rank: int
                   ) -> Params:
    """Rank ``rank``'s backbone: each split leaf's contiguous block of
    ``1/tp`` along its split dimension, as a contiguous tensor; every other
    leaf is the same tensor (shared, not copied)."""
    def cut(path, leaf):
        dim = split_dim(plan, path, leaf)
        if dim is None:
            return leaf
        n = leaf.shape[dim] // plan.tp
        return leaf.narrow(dim, rank * n, n).contiguous()
    return _map_with_path(cut, params)


def kv_head_block(plan: TPServingPlan, rank: int) -> slice:
    """The global KV heads rank ``rank``'s page pools hold: a contiguous
    block of ``cfg_local.num_kv_heads`` when attention splits, else all."""
    h = plan.cfg_local.num_kv_heads
    return slice(rank * h, (rank + 1) * h) if plan.attn else slice(0, h)
