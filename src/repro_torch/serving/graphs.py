"""CUDA-graph capture of the slot path's steps.

The port's counterpart of the JAX engine's jitted slot-path executables.
Every step of ``EngineCore``'s slot path is split in three:

- a host **prepare** that writes the step's inputs into persistent device
  buffers (``StagedInput``: a pinned host copy, one asynchronous upload);
- a device-only **body** that reads and writes persistent tensors alone
  (the slot caches, logits, index, block table, the staged inputs and the
  step's output buffers), with no host sync and no host data baked in;
- the one deliberate host fetch of the step's outputs.

On the CPU, or with graphs turned off, the body runs eagerly.  On a CUDA
device ``StepGraphs`` captures each body once per (family, shape key) into
one memory pool of the engine and replays it afterwards, so a step is one
graph launch instead of hundreds of kernel launches.  A family's first call
at a key runs the body eagerly (that call's step), then captures it; later
calls replay.  ``warm`` does the same ahead of serving on inputs that
change no slot state.  A failed capture raises: there is no eager
fallback.  Eager runs ahead of a capture go to the capture's side stream,
so the libraries' per-stream state (cuBLAS workspaces) exists before the
capture begins.

A replay runs no Python, so the kernels' launch counts
(``kernels.ops.launch_counts``) cannot grow in their wrappers: each capture
records what the wrappers counted while it was captured (and takes it back
off), and each replay adds that again.  ``captures()`` of a family counts
its graphs, which ``analysis.compile_guard`` watches after warmup.
"""
from __future__ import annotations

import gc
from typing import Any, Callable, Dict, Hashable, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops


class StagedInput:
    """A persistent device tensor filled from the host: on a CUDA device
    through a pinned staging tensor and an asynchronous copy (the next
    ``put`` waits for that copy before it reuses the staging), on the CPU
    by a plain copy.  ``dev`` never moves, so a captured graph reads it."""

    def __init__(self, dev: torch.Tensor):
        self.dev = dev
        self._host: Optional[torch.Tensor] = None
        self._copied: Optional[torch.cuda.Event] = None
        if dev.device.type == "cuda":
            self._host = torch.empty(dev.shape, dtype=dev.dtype,
                                     pin_memory=True)
            self._copied = torch.cuda.Event()

    @classmethod
    def zeros(cls, shape, dtype: torch.dtype,
              device: torch.device) -> "StagedInput":
        return cls(torch.zeros(shape, dtype=dtype, device=device))

    def put(self, a) -> torch.Tensor:
        """Write ``a`` (array-like of ``dev``'s shape) into ``dev``."""
        src = torch.from_numpy(np.ascontiguousarray(a)).to(self.dev.dtype)
        if self._host is None:
            self.dev.copy_(src)
            return self.dev
        self._copied.synchronize()
        self._host.copy_(src)
        self.dev.copy_(self._host, non_blocking=True)
        self._copied.record()
        return self.dev


class _Family:
    """One step family's graphs: shape key → (graph, launches it makes)."""

    def __init__(self):
        self.graphs: Dict[Hashable, Tuple[Any, ops.LaunchState]] = {}
        self.replays = 0

    def captures(self) -> int:
        return len(self.graphs)


class StepGraphs:
    """The captured step families of one engine.  ``capture=False`` runs
    every body eagerly (the CPU, graphs turned off)."""

    def __init__(self, device: torch.device, capture: bool,
                 families: Tuple[str, ...]):
        self.device = device
        self.capture = capture
        self.families = {name: _Family() for name in families}
        self.pool = self.stream = None
        if capture:
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(device)

    def run(self, name: str, key: Hashable, body: Callable[[], None]
            ) -> None:
        """One step of family ``name`` at shape ``key``: the replay of its
        graph, or (first call at ``key``) the body run eagerly and then
        captured for the next call."""
        if not self.capture:
            body()
            return
        fam = self.families[name]
        hit = fam.graphs.get(key)
        if hit is None:
            self._eager(body)
            self._capture(fam, key, body)
            return
        graph, launches = hit
        graph.replay()
        ops.add_launches(launches)
        fam.replays += 1

    def warm(self, name: str, key: Hashable, body: Callable[[], None]
             ) -> None:
        """Run ``body`` once (on inputs that change no slot state) and, on
        a capturing engine, capture it at ``key`` if not yet captured."""
        self._eager(body)
        fam = self.families[name]
        if self.capture and key not in fam.graphs:
            self._capture(fam, key, body)

    def _eager(self, body: Callable[[], None]) -> None:
        if not self.capture:
            body()
            return
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            body()
        cur.wait_stream(self.stream)

    def _capture(self, fam: _Family, key: Hashable,
                 body: Callable[[], None]) -> None:
        before = ops.launch_state()
        graph = torch.cuda.CUDAGraph()
        # a garbage collection inside the capture may free what a dropped
        # engine held in a reference cycle (pinned staging tensors, events),
        # and those CUDA calls invalidate the capture: none runs until it
        # ends
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
                body()
            after = ops.launch_state()
        finally:
            if collecting:
                gc.enable()
            # the capture launched nothing: its counts belong to replays
            ops.restore_launches(before)
        fam.graphs[key] = (graph, ops.launch_delta(before, after))

    def stats(self) -> Dict[str, Any]:
        """Graphs by family, replays, and the bytes the engine's graph
        pool holds on the device (0 when nothing is captured)."""
        return {"captured": self.capture,
                "graphs": sum(f.captures() for f in self.families.values()),
                "by_family": {n: f.captures()
                              for n, f in self.families.items()
                              if f.captures()},
                "replays": sum(f.replays for f in self.families.values()),
                "pool_bytes": self.pool_bytes()}

    def pool_bytes(self) -> int:
        if self.pool is None:
            return 0
        pool = tuple(self.pool)
        return sum(seg["total_size"]
                   for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)
