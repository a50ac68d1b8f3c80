"""The port's one device rule.

Every entry point (``init_params``, ``init_adapter``, ``init_confidence``,
the bridge, ``CascadeServer``, ``SpaceVerse``, the baselines) takes a
``device`` argument and resolves it here: ``None`` means the card.  Without
a CUDA device, only an explicit ``"cpu"`` runs; anything else raises, so
nothing carries on quietly on the CPU.  The entry points over tier weights
refuse weights that lie on another device (``check_on_device``).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.tree import tree_leaves

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card unless the caller "
            "passes device='cpu' explicitly")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev!s} (cuda or cpu)")
    return dev


def same_device(a: torch.device, b: torch.device) -> bool:
    """One device: the same type and index (no index: device 0)."""
    return (a.type, a.index or 0) == (b.type, b.index or 0)


def check_on_device(device: torch.device, **trees) -> None:
    """Raise ``ValueError`` when a leaf of a named weight tree lies on
    another device type than ``device``."""
    for name, tree in trees.items():
        for t in tree_leaves(tree):
            if t.device.type != device.type:
                raise ValueError(f"{name} weights lie on {t.device}, the "
                                 f"entry point on {device}")
