"""The paper's contribution as far as the fabric simulator consumes it:
per-phase instrumentation records and the bounded adaptive pacing of
early-arriving ranks (paper §4.3-§5.3), and the coordination agent that
wraps a step's dispatch with both (the serving and training loops use
it), and the failure-mode taxonomy diagnostics (paper §3.3-§5) that read
the records."""
from repro_torch.core.coordination import CoordinationAgent     # noqa: F401
from repro_torch.core.diagnostics import (DiagnosticReport,     # noqa: F401
                                          ModeScore, diagnose,
                                          diagnose_jobs,
                                          expected_max_factor)
from repro_torch.core.instrumentation import (CollectiveTrace,  # noqa: F401
                                              IterationRecord, LocalityInfo,
                                              PhaseRecorder, sample_locality,
                                              summarize)
from repro_torch.core.pacing import (PacingBank,                # noqa: F401
                                     PacingController, PacingDecision)
