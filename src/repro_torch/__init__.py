"""PyTorch/CUDA port of the distributed-training fabric study.

This package stands beside the JAX package ``repro`` and imports nothing
of it. What it holds so far is the fabric simulator and its batched
multi-tenant what-if sweep (:mod:`repro_torch.fabric`), with the sweep's
allocator and segment-overlap kernels written in CUDA C++
(:mod:`repro_torch.fabric.backend.cuda_kernels`)."""
from repro_torch.fabric import (Policies, Result, Scenario,       # noqa: F401
                                ScenarioError, ScenarioGrid, TopologySpec)
