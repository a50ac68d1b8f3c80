"""Elastic scaling / fault tolerance plan (the port of
``repro.train.elastic``, pure Python, carried over unchanged).

At fleet scale failures arrive constantly; the policy here is the standard
checkpoint-restart-on-shrunk-mesh loop:

  1. a heartbeat monitor marks devices lost (simulated here by a predicate),
  2. ``fallback_mesh_shape`` picks the largest (data', model') grid that the
     surviving device count supports while keeping the model-parallel degree
     (TP degree is fixed by memory; DP shrinks),
  3. the trainer restores the latest checkpoint (checkpoints are
     mesh-shape-agnostic, see ``checkpoint.py``) and resumes with the batch
     re-sharded over the smaller data axis.

Straggler mitigation for training is the same machinery with "slow" instead
of "dead": the monitor demotes persistent stragglers and the mesh re-forms.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class DeviceHealth:
    device_id: int
    last_heartbeat: float
    slow_strikes: int = 0


class HeartbeatMonitor:
    """Tracks liveness + straggler strikes for a fleet of devices."""

    def __init__(self, num_devices: int, timeout_s: float = 30.0,
                 straggler_threshold: float = 2.0, max_strikes: int = 3):
        now = time.monotonic()
        self.devices = {i: DeviceHealth(i, now) for i in range(num_devices)}
        self.timeout_s = timeout_s
        self.straggler_threshold = straggler_threshold
        self.max_strikes = max_strikes

    def heartbeat(self, device_id: int, step_time_s: Optional[float] = None,
                  fleet_median_s: Optional[float] = None,
                  now: Optional[float] = None) -> None:
        d = self.devices[device_id]
        d.last_heartbeat = now if now is not None else time.monotonic()
        if step_time_s is not None and fleet_median_s:
            if step_time_s > self.straggler_threshold * fleet_median_s:
                d.slow_strikes += 1
            else:
                d.slow_strikes = 0

    def failed_devices(self, now: Optional[float] = None) -> List[int]:
        now = now if now is not None else time.monotonic()
        out = []
        for d in self.devices.values():
            dead = now - d.last_heartbeat > self.timeout_s
            demoted = d.slow_strikes >= self.max_strikes
            if dead or demoted:
                out.append(d.device_id)
        return sorted(out)


def fallback_mesh_shape(alive: int, model_degree: int,
                        pod_degree: int = 1) -> Tuple[int, ...]:
    """Largest (pod, data', model) grid under ``alive`` devices.

    TP degree is memory-mandated so it is preserved; DP shrinks to the
    largest power of two that fits.  Raises if even data=1 doesn't fit."""
    per_pod = alive // max(pod_degree, 1)
    data = per_pod // model_degree
    if data < 1:
        raise RuntimeError(
            f"cannot keep model_degree={model_degree} with {alive} devices")
    # largest power of two ≤ data (keeps batch divisibility simple)
    d = 1
    while d * 2 <= data:
        d *= 2
    if pod_degree > 1:
        return (pod_degree, d, model_degree)
    return (d, model_degree)


def recovery_plan(num_devices: int, failed: List[int], model_degree: int,
                  pod_degree: int = 1) -> Dict:
    alive = num_devices - len(failed)
    shape = fallback_mesh_shape(alive, model_degree, pod_degree)
    used = 1
    for s in shape:
        used *= s
    return {
        "alive": alive,
        "new_mesh_shape": shape,
        "devices_used": used,
        "devices_spare": alive - used,
        "action": "restore_latest_checkpoint_and_resume",
    }
