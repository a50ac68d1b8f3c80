"""The port's one device rule.

Every entry point (``init_params``, ``init_adapter``, ``init_confidence``,
the bridge, ``CascadeServer``) takes a ``device`` argument and resolves it
here: ``None`` means the card.  Without a CUDA device, only an explicit
``"cpu"`` runs; anything else raises, so nothing carries on quietly on the
CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

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
