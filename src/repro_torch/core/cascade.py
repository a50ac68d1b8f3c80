"""The cascade's configuration records (Algorithm 1).

The port holds only ``CascadeConfig`` and ``TierModel`` of
``repro.core.cascade`` so far: the request server
(``serving.cascade_server``) is the slice's entry point, and the batch
evaluator ``SpaceVerse.run_batch`` is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

from repro_torch.configs.base import ArchConfig

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class CascadeConfig:
    taus: Tuple[float, ...] = (0.5, 0.4)      # τ_1..τ_I (paper §4.1.4)
    alpha: float = 0.35
    beta: float = 0.55
    n_t: int = 8                               # tokens per progressive chunk
    answer_vocab: int = 64


@dataclasses.dataclass
class TierModel:
    params: Params
    cfg: ArchConfig
