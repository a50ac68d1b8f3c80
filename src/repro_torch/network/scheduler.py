"""Window-aware transmission scheduling with straggler mitigation.

Transfers queue per satellite; bytes drain only while a contact window is
open (transfers may span windows).  Straggler mitigation: (i) multiple
phase-spread ground stations — the earliest open window wins; (ii) a
transfer that stalls across a window boundary and is already running longer
than ``straggler_factor``× the fleet-median completion is **re-replicated to
the next window**: the full payload restarts there on a freshly sampled link
rate, and whichever copy finishes first wins (models the paper's
multi-satellite spread of test data, §4.1.4 — a slow link draw is abandoned
rather than ridden to completion).  ``straggler_report()`` reports the
post-mitigation straggler count; ``n_replicated`` counts how many transfers
the mitigation actually rescued.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from repro_torch.network.link import LinkModel
from repro_torch.network.orbit import ContactPlan


@dataclasses.dataclass
class Transfer:
    t_submit: float
    n_bytes: float
    t_done: float = 0.0
    air_time: float = 0.0
    wait_time: float = 0.0
    replicated: bool = False    # won by the re-replicated copy


class TransmissionScheduler:
    def __init__(self, plan: ContactPlan, link: LinkModel,
                 straggler_factor: float = 3.0):
        self.plan = plan
        self.link = link
        self.straggler_factor = straggler_factor
        self.completed: List[Transfer] = []
        self.n_replicated = 0
        self._t_free = 0.0     # time the link becomes free (per-satellite FIFO)

    # ------------------------------------------------------------------
    def _drain(self, t_start: float, n_bytes: float, rate: float
               ) -> Tuple[float, float, float, Optional[float], float]:
        """Drain ``n_bytes`` through contact windows from ``t_start`` at
        ``rate``; returns (t_end, air, wait, first_window_close,
        air_before_close) where ``first_window_close`` is the end of the
        first window the transfer overran (None if it fit in one window) and
        ``air_before_close`` the link time spent up to that point."""
        t = t_start
        remaining = float(n_bytes)
        air = 0.0
        wait = 0.0
        first_close: Optional[float] = None
        air_before_close = 0.0
        while remaining > 0:
            ws, we = self.plan.next_window(t)
            if ws > t:
                wait += ws - t
                t = ws
            sendable = (we - t) * rate
            sent = min(remaining, sendable)
            dt = sent / rate
            air += dt
            t += dt
            remaining -= sent
            if remaining > 0:
                if first_close is None:
                    first_close = we
                    air_before_close = air
                t = we + 1e-9  # window closed; roll to the next one
        return t, air, wait, first_close, air_before_close

    def _median_completion(self) -> float:
        lats = sorted(t.t_done - t.t_submit for t in self.completed)
        return lats[len(lats) // 2]

    def submit(self, t_submit: float, n_bytes: float,
               sample_jitter: bool = True) -> Transfer:
        """Schedule one downlink transfer; returns completion record."""
        tr = Transfer(t_submit=t_submit, n_bytes=n_bytes)
        start = max(t_submit, self._t_free)
        rate = self.link.rate_Bps(sample_jitter)
        t_end, air, wait, first_close, air_w1 = self._drain(start, n_bytes,
                                                            rate)

        # straggler re-replication (item ii), decided with the information
        # available AT the window boundary: when the first window closes with
        # bytes outstanding and the transfer has already been running longer
        # than factor× the fleet median, the full payload restarts in the
        # next window on a fresh rate draw; the earlier finisher wins.
        if first_close is not None and self.completed:
            med = self._median_completion()
            elapsed = first_close + self.link.rtt_s - t_submit
            if elapsed > self.straggler_factor * max(med, 1e-9):
                rate2 = self.link.rate_Bps(sample_jitter)
                t2, air2, _, _, _ = self._drain(first_close + 1e-9,
                                                n_bytes, rate2)
                if t2 < t_end:
                    # winning timeline: the primary transmits until its first
                    # window closes, then the replica carries the payload.
                    # ``air`` counts all link time actually spent; ``wait``
                    # is the rest, so start + air + wait == t_end still holds.
                    t_end = t2
                    air = air_w1 + air2
                    wait = (t2 - start) - air
                    tr.replicated = True
                    self.n_replicated += 1

        t_end += self.link.rtt_s
        tr.t_done, tr.air_time, tr.wait_time = t_end, air, wait
        self._t_free = t_end
        self.completed.append(tr)
        return tr

    # ------------------------------------------------------------------
    def expected_latency_s(self, n_bytes: float) -> float:
        """Analytic per-sample expectation (no queueing): mean window wait +
        air time at mean rate, ignoring window splits for small transfers."""
        rate = self.link.bandwidth_mbps * 1e6 / 8.0
        return (self.plan.expected_wait_s()
                + self.link.rtt_s + n_bytes / rate)

    def straggler_report(self) -> Tuple[float, int]:
        """(median completion latency, #transfers exceeding factor×median),
        measured AFTER mitigation — a transfer rescued by re-replication
        that no longer exceeds the threshold does not count."""
        if not self.completed:
            return 0.0, 0
        med = self._median_completion()
        n_stragglers = sum(
            1 for t in self.completed
            if t.t_done - t.t_submit > self.straggler_factor * max(med, 1e-9))
        return med, n_stragglers


def fleet_expected_latency(plans: List[ContactPlan], link: LinkModel,
                           n_bytes: float) -> float:
    """Straggler-mitigated fleet latency: the earliest satellite wins."""
    waits = [p.expected_wait_s() for p in plans]
    rate = link.bandwidth_mbps * 1e6 / 8.0
    return min(waits) + link.rtt_s + n_bytes / rate
