"""The port's copy of TACC's 4-layer task workflow abstraction, so that the
cluster manager runs the port's runtimes without importing ``repro``.

  schema.py    — layer 1: self-contained task specs (reproducibility hashes)
  compiler.py  — layer 2: spec -> ExecutionPlan, CAS delta caching
  scheduler.py — layer 3: fifo/backfill/fair/priority/goodput policies
  executor.py  — layer 4: torch_train / torch_serve / shell runtimes
  cluster.py   — pods/hosts/chips model, gang placement, failures, stragglers
  sim.py       — discrete-event simulator for the scheduler benchmarks
  service.py   — the real local control loop (drives actual torch work)
  tcloud.py    — lifecycle CLI (``python -m repro_torch.core.tcloud``)
"""
from repro_torch.core.schema import (ResourceSpec, RuntimeEnv, SpecError,
                                     TaskSpec)
from repro_torch.core.compiler import (ArtifactStore, ExecutionPlan,
                                       TaskCompiler)
from repro_torch.core.cluster import Cluster, Node, NodeHealth, TierConfig
from repro_torch.core.scheduler import (POLICIES, Job, JobState, Policy,
                                        Preempt, Resize, Start, TenantPlan,
                                        make_policy)
from repro_torch.core.sim import (ClusterSim, PredictiveOpsConfig, SimConfig,
                                  SimEvent)
from repro_torch.core.executor import LocalExecutor
from repro_torch.core.service import TACC
