"""Deprecation plumbing for the legacy (pre-Scenario) entry points.

The Scenario API made :class:`repro_torch.fabric.scenario.Scenario` the single front door:
one declarative spec validated eagerly, serialized to/from JSON, and run
through ``Scenario.run()``. The old entry points — ``simulate()`` and
direct ``FabricEngine`` / ``LifecycleEngine`` construction with stringly
policy kwargs — keep working bit-identically, but each points its caller
at the Scenario equivalent once per call site. The Scenario machinery
itself constructs the engines inside :func:`scenario_scope`, which
silences the pointer (the engines are its backend, not a legacy caller).
"""
from __future__ import annotations

import contextlib
import warnings
from typing import Iterator

_SUPPRESS = 0


@contextlib.contextmanager
def scenario_scope() -> Iterator[None]:
    """Dynamic extent in which engine construction is Scenario-internal
    (no legacy-entry-point warning)."""
    global _SUPPRESS
    _SUPPRESS += 1
    try:
        yield
    finally:
        _SUPPRESS -= 1


def warn_legacy(entry_point: str, equivalent: str) -> None:
    """Emit the deprecation pointer for a legacy entry point, unless the
    call is Scenario-internal."""
    if _SUPPRESS:
        return
    warnings.warn(
        f"{entry_point} is a legacy entry point kept for compatibility; "
        f"prefer the declarative Scenario API — {equivalent} — which "
        f"validates eagerly, serializes to JSON, and sweeps via "
        f"ScenarioGrid (see repro_torch.fabric.scenario)",
        DeprecationWarning, stacklevel=3)
