"""Fabric study substrate: topology graphs, link-structural collective cost
models (per-call and compiled), congestion dynamics, straggler/locality
models, pluggable policy registries (fairness / scheduling / placement),
the shared-fabric BSP engine and event-driven lifecycle engine that step
tenant populations, and the declarative Scenario API that fronts them all
(``repro_torch.fabric.scenario``)."""
from repro_torch.fabric.collectives import (CollectiveCost,        # noqa: F401
                                            CompiledSchedule, all_reduce,
                                            compile_schedule,
                                            hierarchical_all_reduce,
                                            ring_all_reduce, select_algo,
                                            tree_all_reduce)
from repro_torch.fabric.congestion import (CongestionConfig,       # noqa: F401
                                           CongestionModel, drr_shares,
                                           maxmin_shares,
                                           strict_priority_shares,
                                           wfq_shares)
from repro_torch.fabric.policies import (FAIRNESS, PLACEMENTS,     # noqa: F401
                                         ROUTERS, FairnessPolicy,
                                         PolicyRegistry, RouterPolicy)
from repro_torch.fabric.engine import (FAIRNESS_MODES,             # noqa: F401
                                       EngineResult, FabricEngine,
                                       JobResult, JobSpec)
from repro_torch.fabric.events import (Arrival, Departure,         # noqa: F401
                                       LifecycleEngine, LifecycleResult,
                                       NodeFailure)
from repro_torch.fabric.placement import (POLICIES, place,         # noqa: F401
                                          spanning_groups)
from repro_torch.fabric.scheduling import (SCHEDULERS, Scheduler,  # noqa: F401
                                           make_scheduler)
from repro_torch.fabric.workloads import (InferenceSpec,           # noqa: F401
                                          InferenceTenant, Tenant,
                                          TrainingTenant)
from repro_torch.fabric.simulator import (SimConfig, SimResult,    # noqa: F401
                                          efficiency_curve, job_spec_from,
                                          scenario_from, simulate)
from repro_torch.fabric.stragglers import (ComputeModel,           # noqa: F401
                                           StragglerConfig)
from repro_torch.fabric.topology import (FatTree, Link, Topology,  # noqa: F401
                                         TpuPod, fat_tree, tpu_pod)
from repro_torch.fabric.scenario import (Policies, Result,         # noqa: F401
                                         Scenario, ScenarioError,
                                         ScenarioGrid, TopologySpec)
from repro_torch.fabric.trace import (Calibration, Trace,          # noqa: F401
                                      TraceError, TraceFit,
                                      TraceValidation, calibrate,
                                      fit_trace, load_trace)
