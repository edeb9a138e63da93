"""TACC service: wires the 4 layers together for *real* local execution.

submit(TaskSpec) -> Compiler Layer -> queue -> Scheduling Layer (pluggable
policy) -> Execution Layer (real torch runtimes). One ``tick()`` = one
scheduling round + one quantum of real work for every running job. This is
what `tcloud` and the end-to-end examples drive.

The cluster model is virtual (chips are bookkeeping), the *work* is real:
training steps run on the local device regardless of the granted chip count,
which keeps the control-plane behavior (queueing, gang allocation,
preemption, failure restart, elastic resize) faithful while staying runnable
on one CPU.

The port's copy of ``repro/core/service.py``. ``TACC(..., device=)`` names
the device its runtimes run on: the card by default, where there is none
provisioning a torch job raises; ``device="cpu"`` runs the plain path.
"""
from __future__ import annotations

import itertools
import os
import time
from typing import Any, Callable, Dict, List, Optional

from repro_torch.core.cluster import Cluster
from repro_torch.core.compiler import ArtifactStore, TaskCompiler
from repro_torch.core.executor import LocalExecutor
from repro_torch.core.scheduler import (Job, JobState, Policy, Preempt,
                                        Resize, Start, make_policy)
from repro_torch.core.schema import TaskSpec
from repro_torch.device import DeviceLike


# executor control calls (checkpoint / deprovision) hit the local runtime's
# filesystem and process state; transient errors there must not wedge the
# whole control loop, but retries have to be *bounded* — an executor that
# keeps failing should surface the error, not spin forever
RETRY_LIMIT = 3
RETRY_BACKOFF_S = 0.05          # doubles per attempt ...
RETRY_BACKOFF_CAP_S = 2.0       # ... up to this ceiling


def _with_retry(op: str, fn: Callable[[], Any], *,
                sleep: Callable[[float], None] = time.sleep) -> Any:
    """Run ``fn`` with bounded exponential backoff; re-raise the final
    failure so callers never silently lose an executor error."""
    delay = RETRY_BACKOFF_S
    for attempt in range(RETRY_LIMIT):
        try:
            return fn()
        except Exception:
            if attempt == RETRY_LIMIT - 1:
                raise
            sleep(min(delay, RETRY_BACKOFF_CAP_S))
            delay *= 2.0


class TACC:
    def __init__(self, root: str, *, policy: str = "backfill",
                 cluster: Optional[Cluster] = None, quantum_steps: int = 10,
                 fail_injector: Optional[Callable[[Job, int], bool]] = None,
                 policy_kwargs: Optional[Dict[str, Any]] = None,
                 device: DeviceLike = "cuda"):
        os.makedirs(root, exist_ok=True)
        self.root = root
        self.store = ArtifactStore(os.path.join(root, "cas"))
        self.compiler = TaskCompiler(self.store, os.path.join(root, "work"))
        self.cluster = cluster or Cluster(n_pods=1, hosts_per_pod=2,
                                          chips_per_host=4)
        self.policy: Policy = make_policy(policy, **(policy_kwargs or {}))
        self.executor = LocalExecutor(self.store, quantum_steps,
                                      fail_injector, device)
        self.jobs: Dict[str, Job] = {}
        self._seq = itertools.count()
        self.ticks = 0

    # -- lifecycle API (what tcloud calls) -----------------------------------

    def submit(self, spec: TaskSpec) -> str:
        spec.validate()
        plan = self.compiler.compile(spec)
        job_id = f"job-{next(self._seq):04d}-{plan.plan_id[:6]}"
        job = Job(id=job_id, plan=plan, submit_time=time.time())
        self.jobs[job_id] = job
        job.log(time.time(), f"submitted (spec {spec.spec_hash()}, "
                f"cache: {plan.cache_report})")
        return job_id

    def kill(self, job_id: str) -> None:
        job = self.jobs[job_id]
        if job.state == JobState.RUNNING:
            _with_retry("deprovision",
                        lambda: self.executor.deprovision(job_id))
            self.cluster.release(job_id)
        job.state = JobState.KILLED
        job.end_time = time.time()

    def logs(self, job_id: str, tail: int = 20) -> List[str]:
        return self.executor.logs(self.jobs[job_id], tail)

    def status(self) -> List[Dict[str, Any]]:
        return [{"id": j.id, "name": j.spec.name, "tenant": j.tenant,
                 "state": j.state.value, "chips": j.chips,
                 "progress": f"{int(j.progress)}/{j.total_steps}",
                 "preempt": j.preemptions, "restarts": j.restarts}
                for j in self.jobs.values()]

    # -- control loop ---------------------------------------------------------

    def _running(self) -> List[Job]:
        return [j for j in self.jobs.values() if j.state == JobState.RUNNING]

    def _pending(self) -> List[Job]:
        return [j for j in self.jobs.values() if j.state == JobState.PENDING]

    def tick(self) -> Dict[str, Any]:
        self.ticks += 1
        actions = self.policy.schedule(time.time(), self._pending(),
                                       self._running(), self.cluster)
        for a in actions:
            job = self.jobs[a.job_id]
            if isinstance(a, Start) and job.state == JobState.PENDING:
                job.place_reliable = a.reliable
                if job.fractional:
                    # mirror the sim: sub-chip tiers go through the
                    # multi-resource allocator, one chip max
                    alloc = self.cluster.try_allocate_fractional(
                        job.id, job.isolation, job.quanta, a.reliable)
                else:
                    alloc = self.cluster.try_allocate(
                        job.id, a.chips,
                        job.spec.resources.prefer_single_pod, a.reliable)
                if alloc is not None:
                    job.state = JobState.RUNNING
                    job.chips = a.chips
                    job.start_time = time.time()
                    if job.first_start is None:
                        job.first_start = job.start_time
            elif isinstance(a, Preempt) and job.state == JobState.RUNNING:
                # checkpoint-then-preempt
                _with_retry("checkpoint",
                            lambda j=job: self.executor.checkpoint(j.id))
                _with_retry("deprovision",
                            lambda j=job: self.executor.deprovision(j.id))
                self.cluster.release(job.id)
                job.preemptions += 1
                job.state = JobState.PENDING
                job.chips = 0
            elif isinstance(a, Resize) and job.state == JobState.RUNNING \
                    and not job.fractional:
                _with_retry("checkpoint",
                            lambda j=job: self.executor.checkpoint(j.id))
                self.cluster.release(job.id)
                if self.cluster.try_allocate(
                        job.id, a.chips,
                        job.spec.resources.prefer_single_pod,
                        job.place_reliable) is not None:
                    job.chips = a.chips
                else:
                    job.state = JobState.PENDING
                    job.chips = 0
        metrics = self.executor.tick(self._running())
        self.policy.account(1.0, self._running())
        # release cluster state for jobs the executor finished/failed/requeued
        for jid, job in self.jobs.items():
            if job.state != JobState.RUNNING and (
                    jid in self.cluster.allocations
                    or self.cluster.frac_allocation(jid) is not None):
                self.cluster.release(jid)
                job.chips = 0
        return metrics

    def run_until_done(self, max_ticks: int = 10000) -> List[Dict[str, Any]]:
        for _ in range(max_ticks):
            self.tick()
            if all(j.state in (JobState.COMPLETED, JobState.FAILED,
                               JobState.KILLED) for j in self.jobs.values()):
                break
        return self.status()
