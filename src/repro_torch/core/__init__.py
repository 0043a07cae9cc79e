"""The paper's contribution as far as the fabric simulator consumes it:
per-phase instrumentation records and the bounded adaptive pacing of
early-arriving ranks (paper §4.3-§5.3), and the coordination agent that
wraps a step's dispatch with both (the serving loop uses it). The
failure-mode diagnostics arrive with the training path."""
from repro_torch.core.coordination import CoordinationAgent     # noqa: F401
from repro_torch.core.instrumentation import (CollectiveTrace,  # noqa: F401
                                              IterationRecord, LocalityInfo,
                                              PhaseRecorder, summarize)
from repro_torch.core.pacing import (PacingBank,                # noqa: F401
                                     PacingController, PacingDecision)
