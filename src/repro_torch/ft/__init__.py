"""Fault tolerance: heartbeat failure detection, restart policy with
backoff, elastic re-mesh planning. Straggler mitigation is the paper's
pacing layer (repro_torch.core)."""
from repro_torch.ft.failure import (FailureDetector, HeartbeatConfig,  # noqa: F401
                              RecoveryEvent, RecoveryLog, RestartPolicy,
                              RestoreCostModel, plan_elastic_mesh,
                              simulated_clock_scope)
