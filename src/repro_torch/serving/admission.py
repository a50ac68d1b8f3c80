"""Overload control: bounded priority admission queue + policy knobs.

The port of ``repro.serving.admission``: framework-free, the same
outcomes, reasons and queue order.  The paper's deployment case is bursty,
contact-window-gated traffic in which disaster-monitoring queries must
stay near real time while the engine is saturated.  Without this layer
``EngineCore.admit_many`` admits unconditionally: the only backpressure is
``PrefixCache.evict_for`` raising ``MemoryError``, and callers queue
without bound in front of the engine.  Overload control replaces both
with an explicit contract:

- **Admission is a pure check first.**  A request's worst-case page demand
  (shared scene prefix + private pages covering prompt + max answer + spec
  γ slack) is compared against the pool's *headroom* — free pages plus
  zero-user evictable prefix pages — and the request is admitted only when
  the pool can provably hold it.  ``evict_for`` then runs inside the
  commit phase where it can no longer fail.

- **Over-budget requests park here**, in a bounded queue ordered by
  ``Request.priority`` (FIFO within a class, aging preserved across
  preemption).  When the queue overflows the *least valuable* entry is
  rejected with an explicit outcome instead of growing without bound.

- **Deadlines expire queued work.**  ``Request.deadline_s`` bounds how
  long a request may wait; the engine rejects expired entries at pump
  time (reason ``"expired"``) rather than burning saturated capacity on
  answers nobody can use.  Admitted requests always run to completion.

Outcome vocabulary (returned by ``EngineCore.submit_many`` and recorded
for late rejections): ``ADMITTED`` — in a slot now; ``QUEUED`` — parked,
will be admitted or rejected later; ``REJECTED`` — dropped, with a reason
(``"queue_full"``, ``"expired"`` or ``"infeasible"``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from repro_torch.serving.request import Request

ADMITTED = "admitted"
QUEUED = "queued"
REJECTED = "rejected"

REASON_QUEUE_FULL = "queue_full"
REASON_EXPIRED = "expired"
#: the request's worst-case page demand exceeds what the pool could hold
#: even on an idle engine with everything evictable evicted — it can never
#: be admitted, so parking it would wedge the strict-priority queue head
REASON_INFEASIBLE = "infeasible"


@dataclasses.dataclass(frozen=True)
class OverloadConfig:
    """Knobs of the overload-control layer (None on the engine = off,
    preserving the legacy admit-unconditionally contract byte-for-byte).

    ``queue_cap`` bounds the admission queue; ``preempt`` enables
    drop-and-recompute preemption of lower-priority in-flight slots when a
    higher-priority request cannot otherwise be admitted."""
    queue_cap: int = 64
    preempt: bool = True

    def __post_init__(self):
        if self.queue_cap < 1:
            raise ValueError("queue_cap must be >= 1")


@dataclasses.dataclass
class QueueEntry:
    """One parked request.  ``seq`` is the submission sequence number —
    kept across preemption so a preempted-and-re-enqueued request returns
    to the FRONT of its priority class (it has waited longest), preserving
    aging instead of sending it to the back of the line."""
    request: Request
    seq: int
    t_submit: float
    preempts: int = 0           # times this request was preempted so far

    @property
    def sort_key(self) -> Tuple[int, int]:
        # smaller = served first: high priority first, then oldest seq
        return (-self.request.priority, self.seq)


class AdmissionQueue:
    """Bounded priority queue over ``QueueEntry``.

    Small by construction (``queue_cap`` is tens, not thousands — a
    satellite buffers little), so a sorted list beats a heap: ``peek`` and
    ``pop`` are O(1) at the front, overflow eviction is O(1) at the back,
    and insertion's O(n) shift is noise next to a model step."""

    def __init__(self, cap: int):
        if cap < 1:
            raise ValueError("queue cap must be >= 1")
        self.cap = cap
        self._q: List[QueueEntry] = []
        self.depth_peak = 0

    def __len__(self) -> int:
        return len(self._q)

    def __iter__(self):
        return iter(self._q)

    # ------------------------------------------------------------------
    def push(self, entry: QueueEntry) -> Optional[QueueEntry]:
        """Insert in priority order.  Returns the entry REJECTED by this
        push when the queue is full: the lowest-priority youngest entry if
        ``entry`` outranks it, else ``entry`` itself (the queue is never
        left over capacity).  Returns ``None`` when nothing was dropped."""
        rejected = None
        if len(self._q) >= self.cap:
            worst = self._q[-1]             # sorted: back = least valuable
            if entry.sort_key < worst.sort_key:
                rejected = self._q.pop()
            else:
                return entry
        lo, hi, key = 0, len(self._q), entry.sort_key
        while lo < hi:                       # insertion point, stable FIFO
            mid = (lo + hi) // 2
            if self._q[mid].sort_key <= key:
                lo = mid + 1
            else:
                hi = mid
        self._q.insert(lo, entry)
        self.depth_peak = max(self.depth_peak, len(self._q))
        return rejected

    def peek(self) -> Optional[QueueEntry]:
        return self._q[0] if self._q else None

    def pop(self) -> QueueEntry:
        return self._q.pop(0)

    def expire(self, now: float) -> List[QueueEntry]:
        """Remove and return every entry whose deadline has passed."""
        out, keep = [], []
        for e in self._q:
            d = e.request.deadline_s
            if d is not None and now - e.t_submit > d:
                out.append(e)
            else:
                keep.append(e)
        if out:
            self._q = keep
        return out
