"""Reference-backend registrations: the existing Python code, as-is.

Nothing here is new arithmetic. Each registration points at the loop
implementation the rest of the repository already runs — the allocators
in :mod:`repro_torch.fabric.congestion`, the vectorized pacing bank in
:mod:`repro_torch.core.pacing`, the busy-segment accounting extracted from
``FabricEngine._contended_effs``, and ``Scenario``'s engine front door —
so selecting ``backend="reference"`` is bit-for-bit the pre-backend
behavior (``tests/golden/*.json`` and ``tests/baselines/*.json`` hold).
"""
from __future__ import annotations

from repro_torch.core.pacing import PacingBank
from repro_torch.fabric.backend import KernelType, register_kernel
from repro_torch.fabric.congestion import (drr_shares, maxmin_shares,
                                     offered_share, strict_priority_shares,
                                     wfq_shares)
from repro_torch.fabric.engine import link_overlaps

register_kernel("maxmin_shares", KernelType.REFERENCE, maxmin_shares)
register_kernel("wfq_shares", KernelType.REFERENCE, wfq_shares)
register_kernel("strict_priority_shares", KernelType.REFERENCE,
                strict_priority_shares)
register_kernel("drr_shares", KernelType.REFERENCE, drr_shares)
register_kernel("offered_share", KernelType.REFERENCE, offered_share)
register_kernel("segment_overlap", KernelType.REFERENCE, link_overlaps)


@register_kernel("pacing_decide", KernelType.REFERENCE)
def pacing_decide(bank: PacingBank):
    """One bounded-delay decision from a live :class:`PacingBank` —
    the bank *is* the reference window state, so the kernel is just its
    ``decide``. The torch kernel consumes the same window arrays."""
    return bank.decide()


@register_kernel("scenario", KernelType.REFERENCE)
def run_scenario(scenario, topo=None, device=None, dtype=None):
    """The sequential engine front door (`Scenario.run` dispatches here
    for ``backend="reference"``). The engine is host Python in double
    precision: ``device`` and ``dtype`` do not apply and are ignored."""
    return scenario._run_reference(topo)
