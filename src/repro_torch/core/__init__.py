"""SpaceVerse core of the port (inference): the EO adapter, Eq. (2) region
scoring, the Eq. (3) multi-scale filter, the progressive confidence net,
the Algorithm 1 batch evaluator (``cascade.SpaceVerse``), the Simi metrics
and the latency model.

- ``confidence``        progressive confidence network g̃ (§3.1)
- ``region_attention``  Eq. (2) text-image region scoring (kernel-backed)
- ``preprocess``        Eq. (3) multi-scale filter + byte accounting
- ``cascade``           Algorithm 1 orchestrator (two-tier inference)
- ``eo_adapter``        LVLM task protocol for EO tasks
- ``similarity``        Simi metrics + confidence targets
- ``latency``           paper-calibrated deployment latency model
"""
from repro_torch.core import (cascade, confidence, eo_adapter,  # noqa: F401
                              latency, preprocess, region_attention,
                              similarity)
