"""Runtime compile guard: no step captured after warmup.

The port's copy of ``repro.analysis.compile_guard``.  Where the JAX engine
compiles one jitted executable per slot-path entry point and shape, the
port captures one CUDA graph per step family and shape
(``serving/graphs.py``); a capture after ``warmup()`` is the port's
steady-state recompile: the step it serves runs eagerly once and the
capture stalls the serving loop.  ``EngineCore`` registers its step
families, arms the guard at the end of ``warmup()`` (every admission bucket
and step variant is captured by then), and calls ``check()`` after each
step and admission.  A registered family whose ``captures()`` grows past
its armed baseline is a steady-state recompile: under pytest that raises
``SteadyStateRecompile`` at once (naming the family); elsewhere it adds to
the counter ``scheduler_stats()['steady_recompiles']`` reports.

Mode resolution: ``SPACELINT_COMPILE_GUARD`` in {``raise``, ``count``,
``off``} wins if set; otherwise ``raise`` when running under pytest
(``PYTEST_CURRENT_TEST`` present), ``count`` elsewhere.

Also usable as a context manager around any traffic window::

    with CompileGuard({"step": family}) as guard:
        drive_traffic(engine)
    assert guard.steady_recompiles == 0

Stdlib only: a family is anything with a ``captures()`` method.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional


class SteadyStateRecompile(RuntimeError):
    """A slot-path step family captured a graph after warmup."""


def _resolve_mode(mode: Optional[str]) -> str:
    if mode is not None:
        return mode
    env = os.environ.get("SPACELINT_COMPILE_GUARD", "").strip().lower()
    if env in ("raise", "count", "off"):
        return env
    return "raise" if "PYTEST_CURRENT_TEST" in os.environ else "count"


class CompileGuard:
    """Watches ``captures()`` of registered step families."""

    def __init__(self, families: Optional[Mapping[str, Any]] = None, *,
                 mode: Optional[str] = None):
        self._fams: Dict[str, Any] = {}
        self._baseline: Dict[str, int] = {}
        self._armed = False
        self._mode_override = mode
        self.steady_recompiles = 0
        for name, fam in (families or {}).items():
            self.register(name, fam)

    # -- wiring ---------------------------------------------------------
    def register(self, name: str, family: Any) -> None:
        """Track ``family`` (must expose ``captures()``; anything else is
        skipped silently)."""
        if callable(getattr(family, "captures", None)):
            self._fams[name] = family
            if self._armed:
                self._baseline[name] = family.captures()

    @property
    def mode(self) -> str:
        return _resolve_mode(self._mode_override)

    @property
    def armed(self) -> bool:
        return self._armed

    def arm(self) -> None:
        """Snapshot the current capture counts; growth beyond them is a
        finding.  Re-arming (after a deliberate re-warmup) resets the
        baselines and keeps the running counter."""
        self._baseline = {n: f.captures() for n, f in self._fams.items()}
        self._armed = True

    def disarm(self) -> None:
        self._armed = False

    # -- checking -------------------------------------------------------
    def check(self, context: str = "") -> int:
        """Compare capture counts to the armed baseline.  Returns the
        number of NEW captures observed this call (each counted once)."""
        if not self._armed or self.mode == "off":
            return 0
        grew = []
        new = 0
        for name, fam in self._fams.items():
            size = fam.captures()
            base = self._baseline.get(name, size)
            if size > base:
                grew.append(f"{name}: {base} -> {size}")
                new += size - base
                self._baseline[name] = size  # count each capture once
        if not grew:
            return 0
        self.steady_recompiles += new
        if self.mode == "raise":
            where = f" during {context}" if context else ""
            raise SteadyStateRecompile(
                f"steady-state recompile{where}: {'; '.join(grew)}: every "
                "step family and admission bucket must be captured by "
                "warmup()")
        return new

    # -- context-manager form -------------------------------------------
    def __enter__(self) -> "CompileGuard":
        self.arm()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.check("guarded block exit")
