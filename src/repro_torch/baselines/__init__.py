"""Baselines from §4.1.5: satellite-only, GS-only, Tabi, AI-RG.

The port of ``repro.baselines``: thin adapters over the shared
``CascadeExecutor`` with the baseline policies of ``serving.policy``.  Each
runs on the card unless ``device="cpu"`` is asked for."""
from repro_torch.baselines.static import SatelliteOnly, GSOnly  # noqa: F401
from repro_torch.baselines.tabi import Tabi  # noqa: F401
from repro_torch.baselines.airg import AIRG  # noqa: F401
