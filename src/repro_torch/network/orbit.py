"""Circular-orbit contact-window model (replaces the paper's TLE playback).

For a LEO shell at altitude ``h`` and a ground station with minimum elevation
``ε``, the Earth-central half-angle of visibility is

    λ = arccos(R_e cos ε / (R_e + h)) − ε

and an overhead pass spends the fraction λ/π of the orbital period in view.
At the paper's 570 km Starlink shell with ε = 25° this gives ≈ 4.6 %,
matching the 4.33 % average the paper derives from constellation data
(Fig. 4a); the exact paper value can be pinned via ``contact_fraction_override``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

MU_EARTH_KM3_S2 = 398_600.4418
R_EARTH_KM = 6_371.0


def orbital_period_s(alt_km: float) -> float:
    a = R_EARTH_KM + alt_km
    return 2.0 * math.pi * math.sqrt(a ** 3 / MU_EARTH_KM3_S2)


def contact_fraction(alt_km: float, min_elev_deg: float = 25.0) -> float:
    """Fraction of the orbital period a GS sees the satellite (overhead pass)."""
    eps = math.radians(min_elev_deg)
    cos_lam = R_EARTH_KM * math.cos(eps) / (R_EARTH_KM + alt_km)
    lam = math.acos(min(max(cos_lam, -1.0), 1.0)) - eps
    return max(lam, 0.0) / math.pi


@dataclasses.dataclass(frozen=True)
class ContactPlan:
    """Periodic satellite↔GS visibility windows.

    Multiple ground stations appear as phase-shifted copies of the window
    train — the straggler-mitigation path in the scheduler picks whichever
    opens first.
    """
    alt_km: float = 570.0
    min_elev_deg: float = 25.0
    num_gs: int = 1
    contact_fraction_override: Optional[float] = None

    @property
    def period_s(self) -> float:
        return orbital_period_s(self.alt_km)

    @property
    def fraction(self) -> float:
        if self.contact_fraction_override is not None:
            return self.contact_fraction_override
        return contact_fraction(self.alt_km, self.min_elev_deg)

    @property
    def window_s(self) -> float:
        return self.fraction * self.period_s

    def gs_phase(self, gs: int) -> float:
        return self.period_s * gs / max(self.num_gs, 1)

    def next_window(self, t: float) -> Tuple[float, float]:
        """Earliest (start, end) of a window open at-or-after time ``t``
        across all ground stations."""
        best = (math.inf, math.inf)
        for g in range(max(self.num_gs, 1)):
            ph = self.gs_phase(g)
            k = math.floor((t - ph) / self.period_s)
            for kk in (k, k + 1):
                start = ph + kk * self.period_s
                end = start + self.window_s
                if end > t:
                    cand = (max(start, t), end)
                    if cand[0] < best[0]:
                        best = cand
                    break
        return best

    def windows(self, t0: float, t1: float) -> List[Tuple[float, float]]:
        out = []
        t = t0
        while True:
            s, e = self.next_window(t)
            if s >= t1:
                break
            out.append((s, min(e, t1)))
            t = e + 1e-9
        return out

    def expected_wait_s(self) -> float:
        """Mean wait until a window opens, for a uniformly-random arrival,
        with ``num_gs`` phase-spread stations."""
        gap = self.period_s / max(self.num_gs, 1) - self.window_s
        if gap <= 0:
            return 0.0
        p_closed = gap / (self.period_s / max(self.num_gs, 1))
        return p_closed * gap / 2.0
