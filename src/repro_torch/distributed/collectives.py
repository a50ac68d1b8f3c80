"""The serving engine's tensor-parallel all-reduce hooks.

``models/layers.py`` calls ``tp_attn_all_reduce`` after attention's output
projection and ``tp_mlp_all_reduce`` after the MLP's down projection.
Outside a ``tp_context`` both are identity, so a single-device model runs
exactly as before.  Inside one they sum the partial outputs over the
context's process group (``torch.distributed.all_reduce``, in place), but
only for the sublayer kinds the context marks as split, so a replicated
sublayer is never multiplied by the tensor-parallel degree.  Every
all-reduce counts under its kind (``all_reduce_counts``).  The gradient
helpers of the JAX module (``reduce_scatter_grads``, ``all_gather_params``,
``chunked_psum``), the tools of ZeRO-1 sharding, are not ported (ROADMAP
queue 1, item 12's rest).
"""
from __future__ import annotations

import contextlib
from typing import Dict, NamedTuple, Optional

import torch
import torch.distributed as dist


class _TPState(NamedTuple):
    group: object
    attn: bool
    mlp: bool


_TP: Optional[_TPState] = None
_COUNTS: Dict[str, int] = {"attn": 0, "mlp": 0}


@contextlib.contextmanager
def tp_context(group, *, attn: bool = False, mlp: bool = False):
    """Arm the hooks over ``group`` while the model runs a split step;
    ``attn`` / ``mlp`` flag which sublayers hold split weights (partial-sum
    outputs)."""
    global _TP
    prev = _TP
    _TP = _TPState(group, attn, mlp)
    try:
        yield
    finally:
        _TP = prev


def _all_reduce(x: torch.Tensor, kind: str) -> torch.Tensor:
    dist.all_reduce(x, group=_TP.group)
    _COUNTS[kind] += 1
    return x


def tp_attn_all_reduce(x: torch.Tensor) -> torch.Tensor:
    """Sum attention-output partials over the group (identity outside a
    ``tp_context`` or when attention is not head-split)."""
    if _TP is not None and _TP.attn:
        return _all_reduce(x, "attn")
    return x


def tp_mlp_all_reduce(x: torch.Tensor) -> torch.Tensor:
    """Sum MLP-output partials over the group (identity outside a
    ``tp_context`` or when the FFN is not split)."""
    if _TP is not None and _TP.mlp:
        return _all_reduce(x, "mlp")
    return x


def all_reduce_counts() -> Dict[str, int]:
    """All-reduces by kind ("attn", "mlp") since the last reset."""
    return dict(_COUNTS)


def reset_all_reduce_counts() -> None:
    for k in _COUNTS:
        _COUNTS[k] = 0
