"""Satellite↔GS link model, calibrated to the paper's Starlink measurements.

The paper's commercial Starlink GS measured an average 110.67 Mb/s downlink;
traffic was replayed with Open vSwitch + tc.  Here the link is analytic:
deterministic seeded lognormal rate jitter around the measured mean plus a
fixed per-transfer protocol overhead, combined with the orbit contact plan by
the scheduler.
"""
from __future__ import annotations

import dataclasses

import numpy as np

MBPS = 1e6 / 8.0  # bytes per second per Mb/s


@dataclasses.dataclass
class LinkModel:
    bandwidth_mbps: float = 110.67      # paper §4.1.4 measurement
    rtt_s: float = 0.04                 # LEO bent-pipe RTT ~25–50 ms
    jitter_sigma: float = 0.15          # lognormal σ of rate multiplier
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    def rate_Bps(self, sample_jitter: bool = True) -> float:
        mult = 1.0
        if sample_jitter and self.jitter_sigma > 0:
            mult = float(self._rng.lognormal(0.0, self.jitter_sigma))
            mult = min(max(mult, 0.3), 3.0)
        return self.bandwidth_mbps * MBPS * mult

    def tx_seconds(self, n_bytes: float, sample_jitter: bool = True) -> float:
        """Pure air-time for ``n_bytes`` (no contact-window waiting)."""
        if n_bytes <= 0:
            return 0.0
        return self.rtt_s + n_bytes / self.rate_Bps(sample_jitter)
