"""Discrete-event cluster simulator.

Drives a :class:`Policy` against the :class:`Cluster` model with the
operational behaviors of the Execution Layer: checkpoint-then-preempt,
node-failure restart from the last checkpoint, straggler detection +
drain/reallocate, elastic resizes, and the incident/repair lifecycle
(an ``incident`` event fails a node and the sim schedules its
repair-completion — exact in the heap engine, next tick in the legacy
engine; ``Start.reliable`` routes placement through the cluster's
failure-aware order). Used by the scheduler benchmarks (the paper's
shared-cluster-efficiency claims) and by the property tests.  Metrics
include the reliability columns (failures, observed MTTF, repair-hours,
restarts avoided, per-tenant admission rate) — see
``bench_scheduler.py --help`` for the column glossary.

The sim binds the policy's full incremental driver protocol
(``bind_incremental`` + ``bind_queues``) and feeds the queue hooks at every
transition — ``job_added`` on submit/requeue, ``job_removed``/``job_started``
on start, ``job_stopped`` on completion/failure/preemption, and
``job_progressed`` whenever settled progress moves — so policies schedule
off ordered indexed views instead of re-sorting the pending set each
instant (see ``core/scheduler.py``).

Two engines share the same workload API, action application and metrics:

``event`` (default)
    A true discrete-event engine: one heap-ordered queue holds arrivals,
    injected operational events (failures / recoveries / speed changes),
    checkpoint starts, pause expirations and *predicted* job completions.
    Virtual time jumps straight to the next event, so cost is O(events)
    instead of O(horizon / tick) — multi-day diurnal traces simulate in
    milliseconds. Job progress is accrued lazily from a per-job rate
    (``steps_per_s * node speed``); whenever a job's chip count, placement,
    node speed or pause state changes the accrued progress is settled and
    its pending completion/checkpoint events are invalidated via a per-job
    generation counter and re-predicted. The policy runs only at
    state-changing instants (arrival, completion, failure, recovery,
    straggler drain) plus an optional periodic wake-up advertised by
    ``Policy.wakeup_interval()`` (how ``GoodputElastic.rebalance_every``
    keeps firing without a tick clock).

``tick`` (legacy)
    The original fixed-step loop (``SimConfig.tick`` seconds per step),
    kept as a parity oracle — the benchmarks expose it via
    ``--legacy-tick`` and tests assert both engines agree on a seeded
    trace. Driving :meth:`ClusterSim.step` directly always uses this
    engine regardless of ``SimConfig.engine``.

Virtual time; nothing here touches JAX.

The port's copy of ``repro/core/sim.py``, verbatim apart from its imports;
``tests/test_torch_sim.py`` holds its metrics and per-job outcomes equal
to the reference's on the same traces.
"""
from __future__ import annotations

import heapq
import itertools
import math
import random
from dataclasses import dataclass
from typing import Dict, Iterable, Iterator, List, Optional, Set, Tuple

from repro_torch.ckpt.cost import CheckpointCostModel
from repro_torch.core.cluster import Cluster
from repro_torch.core.scheduler import (Job, JobState, Policy, Preempt,
                                        Resize, Start)


@dataclass(frozen=True)
class PredictiveOpsConfig:
    """Predictive-operations knobs: act on the hazard belief, not the
    failure (ROADMAP direction 3).  A periodic sweep drains nodes whose
    believed hazard crossed the knee, checkpoint-requeues their gangs,
    and schedules *planned* maintenance — a short repair (parts staged,
    no diagnosis) after which the node returns as new (age and failure
    history reset).  All inert at ``SimConfig.predictive=None``: the
    unsignalled fleet replays byte-identically."""
    hazard_knee_per_day: float = 4.0e-3   # believed failures/day knee
    fail_count_knee: int = 2              # ... or this many observed fails
    sweep_interval_s: float = 3600.0
    max_concurrent: int = 4               # planned repairs in flight
    min_free_chips: int = 64              # headroom needed to vacate safely
    repair_planned_s: Tuple[float, float] = (1800.0, 0.4)  # lognorm med, sigma


@dataclass
class SimConfig:
    tick: float = 1.0                     # legacy engine step size
    checkpoint_interval_s: float = 30.0
    checkpoint_cost_s: float = 2.0        # pause while snapshotting
    restart_cost_s: float = 10.0          # provisioning + restore
    straggler_mitigation: bool = True
    straggler_threshold: float = 0.75
    seed: int = 0
    max_time: float = 200000.0
    engine: str = "event"                 # "event" | "tick"
    # memory bounds for year-scale replay (both default to the historical
    # unbounded behavior so existing runs stay byte-identical):
    # record_events=False drops the per-job/state-transition logs (the sim
    # trace and Job.events grow O(transitions) — ~5M tuples on a 1M-job
    # year); compact_completed=True folds each completed job into scalar
    # metric accumulators and frees its Job/plan/clock state, so retained
    # memory tracks the *live* job set, not every job ever run.  Metric
    # sums then accrue in completion order rather than admission order, so
    # float aggregates can differ from the unbounded path in the last ulps
    # (counts and per-job values are exact) — a compacted point gets its
    # own baseline, it is not byte-compared against an unbounded one.
    record_events: bool = True
    compact_completed: bool = False
    # predictive operations (None = off: reactive-only, byte-identical to
    # the historical behavior) and the size/interval-dependent checkpoint
    # cost model (None = the flat checkpoint_cost_s / restart_cost_s
    # constants above; set, it also charges a restore pause on restarts)
    predictive: Optional[PredictiveOpsConfig] = None
    ckpt_model: Optional[CheckpointCostModel] = None


@dataclass
class SimEvent:
    time: float
    kind: str        # fail_node | recover_node | set_speed | incident | renew_node
    node: str
    value: float = 0.0       # set_speed: factor; incident: repair seconds
    info: str = ""           # incident: "transient" | "hard"


@dataclass
class _JobClock:
    """Event-engine runtime record for one running job."""
    rate: float = 0.0              # steps/s at current chips/speed; 0 = paused
    accrue_from: float = 0.0       # progress settled up to this instant
    next_ckpt: float = float("inf")
    pause_until: float = 0.0


class ClusterSim:
    def __init__(self, cluster: Cluster, policy: Policy,
                 cfg: SimConfig = SimConfig()):
        self.cluster = cluster
        self.policy = policy
        self.policy.bind_incremental()
        self.policy.bind_queues()
        self.cfg = cfg
        self.now = 0.0
        self.jobs: Dict[str, Job] = {}
        # live-set indices: every state transition moves jobs between these,
        # so scheduling instants are O(live) instead of O(all jobs ever)
        self._pending_jobs: Dict[str, Job] = {}
        self._running_jobs: Dict[str, Job] = {}
        self.pending_events: List[SimEvent] = []
        self.trace: List[Tuple[float, str, str]] = []
        self._arrivals: List[Tuple[float, Job]] = []
        self._pause_until: Dict[str, float] = {}
        self._last_ckpt: Dict[str, float] = {}
        # event-engine state
        self._clock: Dict[str, _JobClock] = {}
        self._gen: Dict[str, int] = {}        # per-job event generation
        self._heap: List[tuple] = []
        self._seq = itertools.count()
        self._acct_t = 0.0
        self._n_external = 0                  # arrivals+injects still queued
        self._event_mode = False
        self._workload_dirty = False          # unsorted submits/injects
        # reliability accounting (fed by fail_node/incident/repair events)
        self._n_failures = 0                  # node-failure events observed
        self._failures_idle = 0               # ... that hit zero running jobs
        self._repair_s = 0.0                  # summed incident repair time
        self._repair_until: Dict[str, float] = {}    # node -> repair end
        # isolation-tier accounting: spot reclaims plus time-weighted
        # shared-slot occupancy and fractional-chip fragmentation.  The
        # integrals accrue whenever the clock advances, BEFORE any state
        # mutation at the new instant — occupancy is piecewise-constant
        # between mutations, so this is exact (all zero untiered).
        # predictive-operations state (all inert when cfg.predictive is
        # None: the rng is never drawn, the sets stay empty, the counters
        # stay zero — so legacy replays are byte-identical)
        self._pred_rng = random.Random(cfg.seed)      # planned-repair times
        self._maint_nodes: Set[str] = set()           # planned repairs live
        self._renewed: Set[str] = set()               # renewed-as-new nodes
        self._next_sweep = (cfg.predictive.sweep_interval_s
                            if cfg.predictive is not None else 0.0)
        self._drains_proactive = 0
        self._goodput_saved_s = 0.0   # uncheckpointed chip-s saved by drains
        self._ckpt_overhead_s = 0.0   # chip-s paused saving/restoring state
        self._lost_work_s = 0.0       # uncheckpointed chip-s lost to failures
        self._spot_preempts = 0
        self._tier_t = 0.0                    # metrics clock
        self._occ_shared_s = 0.0              # integral of shared_occupancy
        self._frag_chip_s = 0.0               # integral of frag_chips
        # lazy arrival source (ClusterSim.feed): jobs pulled one at a time
        # so the heap / _arrivals never hold a year-1M workload up front
        self._feed: Optional[Iterator[Job]] = None
        self._feed_head: Optional[Job] = None     # tick-engine lookahead
        # compact_completed accumulators (scalar folds of completed jobs)
        self._done_n = 0
        self._done_wait_sum = 0.0
        self._done_wait_n = 0
        self._done_jcts: List[float] = []
        self._done_makespan = 0.0
        self._done_chip_s = 0.0
        self._done_preemptions = 0
        self._done_restarts = 0
        self._done_submitted: Dict[str, int] = {}
        self._done_admitted: Dict[str, int] = {}

    # -- workload ------------------------------------------------------------
    # submit/inject only append: sorting a 50k-job month trace once per
    # submission is O(n^2); the event engine heap-orders everything anyway
    # and the tick engine sorts lazily on its next step.

    def submit(self, job: Job, at: Optional[float] = None) -> None:
        t = job.submit_time if at is None else at
        job.submit_time = t
        self._arrivals.append((t, job))
        self._workload_dirty = True

    def inject(self, event: SimEvent) -> None:
        self.pending_events.append(event)
        self._workload_dirty = True

    def feed(self, jobs: Iterable[Job]) -> None:
        """Attach a lazy arrival source: an iterator of Jobs in
        nondecreasing ``submit_time`` order (a streamed trace replay).
        Jobs are pulled one at a time — the next arrival only — as the sim
        advances, so the arrival backlog never materializes; combine with
        ``SimConfig.compact_completed`` for a fully bounded year-scale
        replay.  One source per sim; ``submit`` still works alongside it
        (pre-registered jobs, tests)."""
        if self._feed is not None:
            raise RuntimeError("a job source is already attached")
        self._feed = iter(jobs)
        self._feed_head = next(self._feed, None)

    def _feed_pull(self) -> Optional[Job]:
        """Advance the lookahead by one job (None once exhausted)."""
        head, self._feed_head = self._feed_head, None
        if head is not None:
            self._feed_head = next(self._feed, None)
        return head

    def _sort_workload(self) -> None:
        if self._workload_dirty:
            self._arrivals.sort(key=lambda x: x[0])
            self.pending_events.sort(key=lambda e: e.time)
            self._workload_dirty = False

    # -- helpers -------------------------------------------------------------

    def _running(self) -> List[Job]:
        return list(self._running_jobs.values())

    def _pending(self) -> List[Job]:
        return list(self._pending_jobs.values())

    def _admit(self, job: Job) -> None:
        self.jobs[job.id] = job
        self._pending_jobs[job.id] = job
        self.policy.note_change()
        self.policy.job_added(job)
        self._log(job, "submitted")

    def _log(self, job: Job, msg: str) -> None:
        if not self.cfg.record_events:
            return      # year-scale replay: O(transitions) logs stay off
        job.log(self.now, msg)
        self.trace.append((self.now, job.id, msg))

    def _save_cost_s(self, job: Job) -> float:
        """Pause for one checkpoint save: flat ``checkpoint_cost_s`` without
        a cost model, size- and gang-dependent with one."""
        m = self.cfg.ckpt_model
        if m is None:
            return self.cfg.checkpoint_cost_s
        return m.save_cost_s(m.job_size_gb(job.spec.resources),
                             float(job.chips))

    def _restore_cost_s(self, job: Job) -> float:
        """Extra pause a restart pays to load its last checkpoint (zero
        without a cost model — the flat ``restart_cost_s`` then stands in
        for provisioning *and* restore, as it always has)."""
        m = self.cfg.ckpt_model
        if m is None or not (job.restarts or job.preemptions):
            return 0.0
        return m.restore_cost_s(m.job_size_gb(job.spec.resources),
                                float(job.chips))

    def _start(self, job: Job, chips: int, reliable: bool = False) -> None:
        job.place_reliable = reliable
        if job.fractional:
            # sub-chip tiers route through the multi-resource allocator:
            # best-fit onto a single mig/shared chip's free quanta
            alloc = self.cluster.try_allocate_fractional(
                job.id, job.isolation, job.quanta, reliable)
        else:
            alloc = self.cluster.try_allocate(
                job.id, chips, job.spec.resources.prefer_single_pod, reliable)
        if alloc is None:
            # grant couldn't be applied: flag the divergence so a cadence
            # policy retries instead of skipping the next rebalance
            self.policy.note_change()
            return
        job.state = JobState.RUNNING
        job.chips = chips
        self._pending_jobs.pop(job.id, None)
        self._running_jobs[job.id] = job
        if not job.fractional:
            # fractional grants are mig/shared quanta, outside the
            # exclusive-chip tenant aggregate (quotas/usage pricing)
            self.policy.grant_delta(job.tenant, chips, spot=job.spot)
        self.policy.job_removed(job)
        self.policy.job_started(job)
        job.start_time = self.now
        if job.first_start is None:
            job.first_start = self.now
        restore_s = self._restore_cost_s(job)
        if restore_s > 0:
            self._ckpt_overhead_s += restore_s * float(job.chips)
        self._pause_until[job.id] = self.now + restore_s + (
            self.cfg.restart_cost_s if job.restarts or job.preemptions else 0.0)
        self._last_ckpt[job.id] = self.now
        self._log(job, f"start chips={chips} pods={self.cluster.job_pods(job.id)}")
        if self._event_mode:
            self._clock[job.id] = _JobClock(
                accrue_from=self.now,
                next_ckpt=self.now + self.cfg.checkpoint_interval_s,
                pause_until=self._pause_until[job.id])
            self._resched(job)

    def _stop(self, job: Job, state: JobState, *, checkpoint: bool,
              reason: str = "") -> None:
        if self._event_mode:
            self._settle(job)
            self._clock.pop(job.id, None)
            self._gen[job.id] = self._gen.get(job.id, 0) + 1
        if checkpoint:
            job.ckpt_progress = job.progress
        else:
            lost = job.progress - job.ckpt_progress    # lose uncheckpointed work
            if lost > 0:
                self._lost_work_s += lost \
                    * job.spec.entry.get("work_per_step", 1.0)
            job.progress = job.ckpt_progress
        self.cluster.release(job.id)
        if not job.fractional:
            self.policy.grant_delta(job.tenant, -job.chips, spot=job.spot)
        self.policy.note_change()
        self._running_jobs.pop(job.id, None)
        self.policy.job_stopped(job)
        job.chips = 0
        job.state = state
        if state == JobState.PENDING:
            self._pending_jobs[job.id] = job
            self.policy.job_added(job)
        self._log(job, f"stop -> {state.value} {reason}")
        if state == JobState.COMPLETED and self.cfg.compact_completed:
            self._compact(job)

    def _compact(self, job: Job) -> None:
        """Fold a completed job into the scalar metric accumulators and
        drop every reference the sim holds to it, so retained memory is
        O(live jobs) on a year-scale replay instead of O(jobs ever run)."""
        self._done_n += 1
        self._done_submitted[job.tenant] = \
            self._done_submitted.get(job.tenant, 0) + 1
        if job.first_start is not None:
            self._done_wait_sum += job.first_start - job.submit_time
            self._done_wait_n += 1
            self._done_admitted[job.tenant] = \
                self._done_admitted.get(job.tenant, 0) + 1
        if job.end_time:
            self._done_jcts.append(job.end_time - job.submit_time)
            self._done_makespan = max(self._done_makespan, job.end_time)
        self._done_chip_s += job.total_steps \
            * job.spec.entry.get("work_per_step", 1.0)
        self._done_preemptions += job.preemptions
        self._done_restarts += job.restarts
        del self.jobs[job.id]
        self._pause_until.pop(job.id, None)
        self._last_ckpt.pop(job.id, None)
        # _fresh treats a missing job as stale, so any heap events still
        # queued under the old generation die on pop
        self._gen.pop(job.id, None)

    def _apply(self, actions) -> None:
        for a in actions:
            if isinstance(a, Start):
                job = self.jobs[a.job_id]
                if job.state == JobState.PENDING:
                    self._start(job, a.chips, a.reliable)
            elif isinstance(a, Preempt):
                job = self.jobs[a.job_id]
                if job.state == JobState.RUNNING:
                    job.preemptions += 1
                    if job.spot:
                        self._spot_preempts += 1
                    self._stop(job, JobState.PENDING, checkpoint=True,
                               reason=f"preempt({a.reason})")
            elif isinstance(a, Resize):
                job = self.jobs[a.job_id]
                if job.fractional:
                    continue    # sub-chip grants are fixed-size
                if job.state == JobState.RUNNING and a.chips != job.chips:
                    # checkpoint-resize-resume
                    if self._event_mode:
                        self._settle(job)
                    job.ckpt_progress = job.progress
                    self.cluster.release(job.id)
                    rel = job.place_reliable
                    alloc = self.cluster.try_allocate(
                        job.id, a.chips, job.spec.resources.prefer_single_pod,
                        rel)
                    if alloc is None:   # rollback
                        self.policy.note_change()   # grant not applied
                        alloc = self.cluster.try_allocate(
                            job.id, job.chips,
                            job.spec.resources.prefer_single_pod, rel)
                        if alloc is None:
                            self.policy.grant_delta(job.tenant, -job.chips)
                            self._running_jobs.pop(job.id, None)
                            self.policy.job_stopped(job)
                            job.state = JobState.PENDING
                            job.chips = 0
                            self._pending_jobs[job.id] = job
                            self.policy.job_added(job)
                            if self._event_mode:
                                self._clock.pop(job.id, None)
                                self._gen[job.id] = \
                                    self._gen.get(job.id, 0) + 1
                        elif self._event_mode:
                            self._resched(job)
                        continue
                    self._log(job, f"resize {job.chips} -> {a.chips}")
                    self.policy.grant_delta(job.tenant, a.chips - job.chips)
                    job.chips = a.chips
                    self._pause_until[job.id] = self.now + self.cfg.restart_cost_s
                    if self._event_mode:
                        self._clock[job.id].pause_until = \
                            self._pause_until[job.id]
                        self._resched(job)

    def _straggler_sweep(self) -> bool:
        """Drain + checkpoint-requeue jobs gated on slow nodes. True if any.

        A straggler node is by definition slower than (threshold x) the
        median of its job's nodes, so it must have speed != 1.0 — only jobs
        touching an abnormal node can be hit, and the sweep is O(1) on the
        healthy steady state instead of rescanning every running job.
        """
        if not self.cluster.abnormal_nodes:
            return False
        cand: set = set()
        for nid in sorted(self.cluster.abnormal_nodes):
            cand.update(self.cluster.jobs_on_node(nid))
        hit = False
        for jid in sorted(cand):
            job = self._running_jobs.get(jid)
            if job is None:
                continue
            slow = self.cluster.straggler_nodes(
                job.id, self.cfg.straggler_threshold)
            if slow:
                for nid in slow:
                    self.cluster.drain(nid)
                job.restarts += 1
                self._stop(job, JobState.PENDING, checkpoint=True,
                           reason=f"straggler-drain({','.join(slow)})")
                hit = True
        return hit

    def _predictive_sweep(self) -> bool:
        """Predictive draining: vacate and proactively repair nodes whose
        believed hazard crossed the knee, *before* the wear-out failure
        lands.  Unlike a failure, a drain is graceful — gangs settle and
        checkpoint, so uncheckpointed progress survives (that delta is the
        goodput saved) — and the repair is planned (short distribution,
        node returns as new).  Returns True if any node was drained."""
        pred = self.cfg.predictive
        hit = False
        for nid, node in self.cluster.nodes.items():
            if len(self._maint_nodes) >= pred.max_concurrent:
                break
            if not node.healthy or node.draining or nid in self._renewed:
                continue
            if self.cluster.hazard_per_day(nid) < pred.hazard_knee_per_day \
                    and node.fail_count < pred.fail_count_knee:
                continue
            if self.cluster.free_chips() < pred.min_free_chips:
                break           # not enough headroom to vacate safely
            self.cluster.drain(nid)
            for jid in self.cluster.jobs_on_node(nid):
                job = self._running_jobs.get(jid)
                if job is None:
                    continue
                if self._event_mode:
                    self._settle(job)
                saved = max(0.0, job.progress - job.ckpt_progress)
                self._goodput_saved_s += saved \
                    * job.spec.entry.get("work_per_step", 1.0)
                job.restarts += 1
                self._stop(job, JobState.PENDING, checkpoint=True,
                           reason=f"predictive-drain({nid})")
            self._drains_proactive += 1
            # planned maintenance: parts staged ahead of time, so the
            # repair-time distribution is the short one in the trace's
            # reliability model; renew_node fires when it completes
            self.cluster.begin_maintenance(nid)
            med, sigma = pred.repair_planned_s
            repair_s = self._pred_rng.lognormvariate(math.log(med), sigma)
            self._repair_s += repair_s
            self._repair_until[nid] = self.now + repair_s
            self._maint_nodes.add(nid)
            if self._event_mode:
                self._push(self.now + repair_s, "renew_done", nid)
            else:
                self.pending_events.append(SimEvent(
                    self.now + repair_s, "renew_node", nid))
                self._workload_dirty = True
            hit = True
        if hit:
            self.policy.note_change()
        return hit

    def _renew(self, node_id: str) -> None:
        """Planned-maintenance completion: the node returns as new."""
        self._maint_nodes.discard(node_id)
        self._repair_until.pop(node_id, None)
        self.cluster.renew_node(node_id)
        self._renewed.add(node_id)

    def _apply_injected(self, ev: SimEvent) -> None:
        self.policy.note_change()
        if ev.kind in ("fail_node", "incident"):
            if ev.kind == "incident" and ev.node in self._renewed:
                # proactive maintenance already replaced the worn part this
                # incident was sampled from: the wear-out failure no longer
                # happens (memoryless fail_node events still apply)
                return
            if not self.cluster.nodes[ev.node].healthy:
                return          # already down: a dead node cannot fail again
            victims = self.cluster.fail_node(ev.node)
            self._n_failures += 1
            if not victims:
                # the failure landed on a node no job was placed on: with
                # failure-aware placement these are the restarts avoided
                self._failures_idle += 1
            for jid in victims:
                job = self.jobs[jid]
                job.restarts += 1
                self._stop(job, JobState.PENDING, checkpoint=False,
                           reason=f"node-failure({ev.node})")
            if ev.kind == "incident":
                # age-model incident: the trace carries the sampled repair
                # time; the sim owns the repair-completion event (exact in
                # the heap engine, next tick in the legacy engine) and the
                # node stays down until it fires — an unrelated memoryless
                # recover event must not resurrect it mid-repair
                repair_s = max(0.0, float(ev.value))
                self._repair_s += repair_s
                self._repair_until[ev.node] = self.now + repair_s
                if self._event_mode:
                    self._push(self.now + repair_s, "repair_done", ev.node)
                else:
                    self.pending_events.append(SimEvent(
                        self.now + repair_s, "recover_node", ev.node))
                    self._workload_dirty = True
        elif ev.kind == "recover_node":
            if self.now < self._repair_until.get(ev.node, 0.0):
                return          # an incident repair still owns this node
            self._repair_until.pop(ev.node, None)
            self.cluster.recover_node(ev.node)
        elif ev.kind == "renew_node":
            # tick-engine planned-maintenance completion (the event engine
            # uses its own heap event, "renew_done")
            if ev.node in self._maint_nodes:
                self._renew(ev.node)
        elif ev.kind == "set_speed":
            # snapshot each affected running job's effective speed first: a
            # job whose rate is gated elsewhere (min over its nodes) keeps a
            # valid prediction, so its generation counter — and every event
            # already queued for it — stays live and no re-predict is needed
            affected = []
            if self._event_mode:
                for jid in self.cluster.jobs_on_node(ev.node):
                    job = self._running_jobs.get(jid)
                    if job is not None:
                        affected.append((job, self.cluster.job_speed(jid)))
            self.cluster.set_speed(ev.node, ev.value)
            if ev.value >= 0.99:                  # recovered: undrain
                self.cluster.drain(ev.node, False)
            for job, speed0 in affected:
                if self.cluster.job_speed(job.id) != speed0:
                    self._settle(job)
                    self._resched(job)

    # -- legacy tick engine ---------------------------------------------------

    def step(self) -> None:
        """One fixed tick of the legacy engine (parity oracle)."""
        dt = self.cfg.tick
        self._accrue_tier_metrics()   # before this tick's mutations land
        self._sort_workload()
        # arrivals
        while self._arrivals and self._arrivals[0][0] <= self.now:
            _, job = self._arrivals.pop(0)
            self._admit(job)
        while self._feed_head is not None \
                and self._feed_head.submit_time <= self.now:
            self._admit(self._feed_pull())
        # injected events
        while self.pending_events and self.pending_events[0].time <= self.now:
            self._apply_injected(self.pending_events.pop(0))
        # predictive draining sweep (same cadence as the event engine)
        if self.cfg.predictive is not None and self.now >= self._next_sweep:
            self._next_sweep = self.now + self.cfg.predictive.sweep_interval_s
            self._predictive_sweep()
        # straggler mitigation: drain + checkpoint-restart without the node
        if self.cfg.straggler_mitigation:
            self._straggler_sweep()
        # progress
        for job in self._running():
            if self.now < self._pause_until.get(job.id, 0.0):
                continue
            if self.now - self._last_ckpt.get(job.id, 0.0) >= \
                    self.cfg.checkpoint_interval_s:
                job.ckpt_progress = job.progress
                self._last_ckpt[job.id] = self.now
                cost = self._save_cost_s(job)
                self._ckpt_overhead_s += cost * float(job.chips)
                self._pause_until[job.id] = self.now + cost
                continue
            sps = job.steps_per_s(job.chips,
                                  self.cluster.crosses_pods(job.id))
            job.progress += dt * sps * self.cluster.job_speed(job.id)
            self.policy.job_progressed(job)
            if job.progress >= job.total_steps:
                job.progress = job.total_steps
                job.end_time = self.now
                self._stop(job, JobState.COMPLETED, checkpoint=True)
        # scheduling
        self.policy.account(dt, self._running())
        actions = self.policy.schedule(self.now, self._pending(),
                                       self._running(), self.cluster)
        self._apply(actions)
        self.now += dt

    # -- event engine ----------------------------------------------------------

    def _push(self, t: float, kind: str, payload=None) -> None:
        heapq.heappush(self._heap, (t, next(self._seq), kind, payload))

    def _settle(self, job: Job) -> None:
        """Accrue progress for a running job up to ``now``."""
        clk = self._clock.get(job.id)
        if clk is None:
            return
        dt = self.now - clk.accrue_from
        if dt > 0 and clk.rate > 0:
            job.progress = min(float(job.total_steps),
                               job.progress + dt * clk.rate)
            self.policy.job_progressed(job)
        clk.accrue_from = self.now

    def _resched(self, job: Job) -> None:
        """Re-predict the job's next intrinsic event (progress settled)."""
        clk = self._clock[job.id]
        gen = self._gen[job.id] = self._gen.get(job.id, 0) + 1
        if self.now < clk.pause_until:
            clk.rate = 0.0
            self._push(clk.pause_until, "pause_end", (job.id, gen))
            return
        clk.rate = job.steps_per_s(job.chips,
                                   self.cluster.crosses_pods(job.id)) \
            * self.cluster.job_speed(job.id)
        t_ckpt = max(clk.next_ckpt, self.now)
        if clk.rate > 0:
            t_done = self.now + \
                max(0.0, job.total_steps - job.progress) / clk.rate
            if t_done <= t_ckpt:
                self._push(t_done, "complete", (job.id, gen))
                return
        self._push(t_ckpt, "ckpt_start", (job.id, gen))

    def _fresh(self, payload) -> Optional[Job]:
        jid, gen = payload
        job = self.jobs.get(jid)
        if job is None or job.state != JobState.RUNNING:
            return None
        if gen != self._gen.get(jid):
            return None
        return job

    def _handle(self, kind: str, payload) -> bool:
        """Process one event; returns True if the policy should run."""
        if kind == "arrival":
            self._admit(payload)
            self._n_external -= 1
            return True
        if kind == "arrival_next":
            # lazy arrival source: admit, then pull exactly one more job so
            # the heap only ever holds the next arrival, not the backlog
            self._admit(payload)
            self._n_external -= 1
            nxt = self._feed_pull()
            if nxt is not None:
                self._push(max(nxt.submit_time, self.now),
                           "arrival_next", nxt)
                self._n_external += 1
            return True
        if kind == "inject":
            self._apply_injected(payload)
            self._n_external -= 1
            return True
        if kind == "wakeup":
            live = bool(self._pending_jobs or self._running_jobs)
            if live or self._n_external > 0:
                self._push(self.now + payload, "wakeup", payload)
            return True
        if kind == "pred_sweep":
            live = bool(self._pending_jobs or self._running_jobs)
            if live or self._n_external > 0 or self._maint_nodes:
                self._push(self.now + payload, "pred_sweep", payload)
            return self._predictive_sweep()
        if kind == "renew_done":
            if payload not in self._maint_nodes:
                return False
            self._renew(payload)
            self.policy.note_change()
            return True
        if kind == "ckpt_start":
            job = self._fresh(payload)
            if job is None:
                return False
            self._settle(job)
            clk = self._clock[job.id]
            job.ckpt_progress = job.progress
            self._last_ckpt[job.id] = self.now
            clk.next_ckpt = self.now + self.cfg.checkpoint_interval_s
            cost = self._save_cost_s(job)
            self._ckpt_overhead_s += cost * float(job.chips)
            clk.pause_until = self.now + cost
            self._pause_until[job.id] = clk.pause_until
            self._resched(job)
            return False
        if kind == "pause_end":
            job = self._fresh(payload)
            if job is None:
                return False
            self._settle(job)
            self._resched(job)
            return False
        if kind == "complete":
            job = self._fresh(payload)
            if job is None:
                return False
            self._settle(job)
            job.progress = float(job.total_steps)
            job.end_time = self.now
            self._stop(job, JobState.COMPLETED, checkpoint=True)
            return True
        if kind == "repair_done":
            self._repair_until.pop(payload, None)
            self.cluster.recover_node(payload)
            self.policy.note_change()
            return True
        raise ValueError(kind)

    def _accrue_tier_metrics(self) -> None:
        """Advance the tier-metrics clock to ``self.now``, accruing the
        elapsed interval at the *current* (pre-mutation) occupancy.  Call
        sites sit right after the clock moves and before event handlers /
        tick bookkeeping touch cluster state, so the piecewise-constant
        integral is exact in the event engine."""
        dt = self.now - self._tier_t
        self._tier_t = self.now
        if dt > 0 and self.cluster.tier_capacity("shared") \
                + self.cluster.tier_capacity("mig"):
            self._occ_shared_s += dt * self.cluster.shared_occupancy()
            self._frag_chip_s += dt * self.cluster.frag_chips()

    def _schedule_now(self) -> None:
        if self.cfg.straggler_mitigation:
            self._straggler_sweep()
        dt = self.now - self._acct_t
        self._acct_t = self.now
        # pass the live-set dict views directly: with bound queue hooks the
        # policy never materializes them, so an instant with a deep pending
        # queue (e.g. a head-blocked FIFO month trace) stays O(work done)
        # instead of O(live jobs) just to build throwaway lists
        pending, running = self._pending_jobs.values(), \
            self._running_jobs.values()
        self.policy.account(dt, running)
        self._apply(self.policy.schedule(self.now, pending, running,
                                         self.cluster))
        # a fresh allocation may have landed on a slow node; requeue it now
        # (the tick engine would catch this on its next step)
        if self.cfg.straggler_mitigation and self._straggler_sweep():
            self._apply(self.policy.schedule(self.now, pending, running,
                                             self.cluster))

    def _run_events(self, until: float) -> Dict[str, float]:
        self._event_mode = True
        self._acct_t = self.now
        self._sort_workload()   # same-instant ties keep submission order
        for t, job in self._arrivals:
            self._push(t, "arrival", job)
            self._n_external += 1
        self._arrivals = []
        for ev in self.pending_events:
            self._push(ev.time, "inject", ev)
            self._n_external += 1
        self.pending_events = []
        if self._feed_head is not None:
            nxt = self._feed_pull()
            self._push(max(nxt.submit_time, self.now), "arrival_next", nxt)
            self._n_external += 1
        wake = self.policy.wakeup_interval()
        if wake:
            self._push(self.now + wake, "wakeup", wake)
        if self.cfg.predictive is not None:
            self._push(self.now + self.cfg.predictive.sweep_interval_s,
                       "pred_sweep", self.cfg.predictive.sweep_interval_s)
        self._schedule_now()            # jobs registered before run()
        while self._heap:
            t = self._heap[0][0]
            if t > until:
                self.now = until
                break
            self.now = t
            self._accrue_tier_metrics()   # before this instant's handlers
            need_sched = False
            while self._heap and self._heap[0][0] <= t:
                _, _, kind, payload = heapq.heappop(self._heap)
                need_sched |= self._handle(kind, payload)
            if need_sched:
                self._schedule_now()
            if self._all_done() and self._n_external == 0:
                break
        self._event_mode = False
        return self.metrics()

    # -- main loop -----------------------------------------------------------

    def run(self, until: Optional[float] = None) -> Dict[str, float]:
        until = until if until is not None else self.cfg.max_time
        if self.cfg.engine == "event":
            return self._run_events(until)
        while self.now < until:
            self.step()
            if self._all_done() and not self.pending_events:
                break
        return self.metrics()

    def _all_done(self) -> bool:
        return (not self._arrivals and self._feed_head is None
                and bool(self.jobs or self._done_n)
                and not self._pending_jobs and not self._running_jobs)

    # -- metrics ---------------------------------------------------------------

    def metrics(self) -> Dict[str, float]:
        # every aggregate below merges the compact_completed accumulators
        # with the jobs still resident; on the default (unbounded) path the
        # accumulators are exact zeros / empties, so the arithmetic — and
        # therefore the floats — are identical to the historical ones
        self._accrue_tier_metrics()       # flush the tail interval
        done = [j for j in self.jobs.values() if j.state == JobState.COMPLETED]
        waits = [(j.first_start - j.submit_time) for j in done
                 if j.first_start is not None]
        jcts = self._done_jcts \
            + [(j.end_time - j.submit_time) for j in done if j.end_time]
        makespan = max((j.end_time for j in done if j.end_time),
                       default=self._done_makespan)
        total_chip_s = self._done_chip_s \
            + sum(j.total_steps * j.spec.entry.get("work_per_step", 1.0)
                  for j in done)
        wait_sum = self._done_wait_sum + sum(waits)
        wait_n = self._done_wait_n + len(waits)
        # reliability: fleet MTTF observed over the run, repair debt, and the
        # failures that hit empty nodes (with failure-aware placement, the
        # restarts avoided); per-tenant admission = share of a tenant's
        # submissions that got chips at least once
        submitted: Dict[str, int] = dict(self._done_submitted)
        admitted: Dict[str, int] = dict(self._done_admitted)
        for j in self.jobs.values():
            submitted[j.tenant] = submitted.get(j.tenant, 0) + 1
            if j.first_start is not None:
                admitted[j.tenant] = admitted.get(j.tenant, 0) + 1
        rel = {
            "failures": float(self._n_failures),
            "mttf_hours": (len(self.cluster.nodes) * self.now / 3600.0
                           / self._n_failures) if self._n_failures else 0.0,
            "repair_hours": self._repair_s / 3600.0,
            "restarts_avoided": float(self._failures_idle),
            # predictive-operations columns: node drains taken ahead of a
            # believed failure, the uncheckpointed chip-hours those drains
            # preserved, chip-hours paused saving/restoring checkpoints,
            # and uncheckpointed chip-hours actually lost to failures
            "drains_proactive": float(self._drains_proactive),
            "goodput_saved_hours": self._goodput_saved_s / 3600.0,
            "ckpt_overhead_hours": self._ckpt_overhead_s / 3600.0,
            "restart_work_lost_hours": self._lost_work_s / 3600.0,
        }
        for t in sorted(submitted):
            rel[f"admission_rate_{t}"] = admitted.get(t, 0) / submitted[t]
        return {
            **rel,
            "spot_preemptions": float(self._spot_preempts),
            "shared_occupancy": self._occ_shared_s / max(self.now, 1e-9),
            "frag_chips": self._frag_chip_s / max(self.now, 1e-9),
            "completed": self._done_n + len(done),
            "jobs": self._done_n + len(self.jobs),
            "makespan": makespan,
            "avg_wait": wait_sum / wait_n if wait_n else 0.0,
            "avg_jct": sum(jcts) / len(jcts) if jcts else 0.0,
            "p95_jct": sorted(jcts)[int(0.95 * (len(jcts) - 1))] if jcts else 0.0,
            "preemptions": self._done_preemptions
            + sum(j.preemptions for j in self.jobs.values()),
            "restarts": self._done_restarts
            + sum(j.restarts for j in self.jobs.values()),
            "useful_chip_seconds": total_chip_s,
            "cluster_chip_seconds": self.cluster.total_chips * max(self.now, 1e-9),
            "utilization_proxy": total_chip_s
            / (self.cluster.total_chips * max(makespan, 1e-9)),
        }
