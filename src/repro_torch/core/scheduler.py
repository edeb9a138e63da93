"""Scheduling Layer (TACC §3.1, layer 3).

Online multi-tenant queue with pluggable policies — the set the paper names
from its Slurm backbone, implemented natively so they compose with the
checkpoint-based preemption of the Execution Layer:

  - ``fifo``            strict arrival order (exposes head-of-line blocking)
  - ``backfill``        EASY backfill: reservation for the head job from
                        runtime estimates; later jobs may jump the queue only
                        if they cannot delay the reservation
  - ``fair``            weighted fair-share across tenants (lowest normalized
                        decayed usage first) + per-tenant quotas
  - ``priority``        priority scheduling with checkpoint-then-preempt of
                        lower-priority preemptible jobs
  - ``goodput``         Pollux-style goodput-aware elastic sizing: chips are
                        assigned by greedy marginal-goodput, jobs resize live

Policies return Actions; the driver (sim or real executor) applies them, so a
policy never mutates cluster state directly. Drivers are not tick-based:
``account`` receives the elapsed virtual time since the previous scheduling
instant (any dt, not a fixed cadence), and a policy that wants to be invoked
on a timer even when no job state changes advertises it via
``wakeup_interval()`` (the event-driven simulator turns that into periodic
wake-up events — how ``GoodputElastic.rebalance_every`` keeps firing).

Indexed pending queues: a driver that opts in with ``bind_queues()`` and
feeds the ``job_added`` / ``job_removed`` / ``job_started`` / ``job_stopped``
/ ``job_progressed`` / ``usage_decayed`` hooks lets every policy keep an
*ordered view* of its queue (arrival order for fifo/backfill/goodput-admit,
per-tenant arrival order for fair, priority order for priority-preempt, and
an incremental release-time index for the EASY-backfill reservation), so a
scheduling instant costs O(work done) instead of re-sorting all pending
jobs.  Hook-fed and scan-based scheduling emit byte-identical actions (the
parity property tests pin this); callers that never bind — e.g. the real
TACC control loop — keep the original sorting paths.

Isolation tiers + tenant plans: sub-chip (``mig`` / ``shared``) jobs bypass
the exclusive-gang policy loops entirely and start through a common
*fractional interactive lane* — FIFO by submit time into per-tier slot
capacity — so a 1/7-chip notebook never waits behind a 64-chip training
gang (the paper's small-interactive-job majority).  A
:class:`TenantPlan` adds per-tenant knobs on top of quotas: per-tier max
concurrency, a priority boost, and the tenant's spot price floor.  ``spot``
jobs run on spare exclusive capacity: any blocked non-spot job may reclaim
their chips (newest spot lease first), and their usage is priced by
observed preemption risk — ``max(floor, 1 - preempts/starts)`` — so a
tenant pays less for capacity that keeps getting taken back.  All of it is
fed through the same incremental driver protocol; with no fractional/spot
jobs and no plans every policy's actions are byte-identical to before.

The port's copy of ``repro/core/scheduler.py``, verbatim apart from its
imports and the ``# repolint: disable=hook-discipline`` marks on the lines
that write the bookkeeping fields this module owns (repolint names the
reference's path as their owner); ``tests/test_torch_core.py`` holds it
to the reference's decisions.
"""
from __future__ import annotations

import bisect
import heapq
import itertools
from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.ckpt.cost import CheckpointCostModel
from repro_torch.core.cluster import FRACTIONAL_TIERS, Cluster
from repro_torch.core.compiler import ExecutionPlan


class JobState(str, Enum):
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    COMPLETED = "COMPLETED"
    FAILED = "FAILED"
    KILLED = "KILLED"


@dataclass
class Job:
    id: str
    plan: ExecutionPlan
    submit_time: float
    state: JobState = JobState.PENDING
    chips: int = 0                    # currently granted
    progress: float = 0.0             # steps completed
    ckpt_progress: float = 0.0        # last checkpointed step
    start_time: Optional[float] = None
    first_start: Optional[float] = None
    end_time: Optional[float] = None
    preemptions: int = 0
    restarts: int = 0
    # placement preference of the job's latest Start action; drivers reuse
    # it when they re-allocate without a fresh policy decision (resizes)
    place_reliable: bool = False
    events: List[Tuple[float, str]] = field(default_factory=list)

    # -- derived -------------------------------------------------------------

    @property
    def spec(self):
        return self.plan.spec

    @property
    def tenant(self) -> str:
        return self.spec.tenant

    @property
    def priority(self) -> int:
        return self.spec.resources.priority

    @property
    def requested(self) -> int:
        return self.plan.mesh_request["chips"]

    @property
    def isolation(self) -> str:
        return self.plan.mesh_request.get("isolation", "exclusive")

    @property
    def fractional(self) -> bool:
        return self.isolation != "exclusive"

    @property
    def quanta(self) -> int:
        """The demand in integer tier quanta (== chips for exclusive)."""
        return self.plan.mesh_request.get("quanta", self.requested)

    @property
    def spot(self) -> bool:
        return bool(self.plan.mesh_request.get("spot", False))

    @property
    def min_chips(self) -> int:
        return min(self.plan.mesh_request["min_chips"], self.requested)

    @property
    def total_steps(self) -> int:
        return self.spec.total_steps

    @property
    def elastic(self) -> bool:
        return self.min_chips < self.requested

    def log(self, t: float, msg: str) -> None:
        self.events.append((t, msg))

    def remaining_estimate(self, now: float) -> float:
        """Estimated absolute completion time (for backfill reservations)."""
        frac = 1.0 - (self.progress / max(self.total_steps, 1))
        return now + max(frac, 0.0) * self.spec.estimated_duration_s

    # throughput model: steps/s at n chips. W = per-step chip-seconds of
    # compute; alpha = communication fraction (from the roofline collective
    # term when available); cross-pod collectives pay 2x.
    def steps_per_s(self, n: int, cross_pod: bool = False) -> float:
        if n <= 0:
            return 0.0
        entry = self.spec.entry
        w = float(entry.get("work_per_step", 1.0))
        alpha = float(entry.get("comm_frac", 0.05))
        # no collective term on a single (or fractional) chip: (n-1)/n is 0
        # at n == 1 and would go negative for sub-chip Fraction grants
        comm = w * alpha * (n - 1) / n * (2.0 if cross_pod else 1.0) \
            if n > 1 else 0.0
        return 1.0 / (w * (1 - alpha) / n + comm + 1e-12)


# ---------------------------------------------------------------------------
# Actions
# ---------------------------------------------------------------------------

@dataclass
class Start:
    job_id: str
    chips: int
    # ask the driver for failure-aware placement (reliability-ordered pods /
    # nodes); emitted by reliability-aware policies for long, wide jobs
    reliable: bool = False


@dataclass
class Preempt:
    job_id: str
    reason: str = "priority"


@dataclass
class Resize:
    job_id: str
    chips: int


Action = object


# ---------------------------------------------------------------------------
# Indexed queue views
# ---------------------------------------------------------------------------

class OrderedJobView:
    """Sorted, lazily-compacted view over a mutating job set.

    Entries are ``(key(job) + (seq,), job)`` kept sorted by ``bisect.insort``;
    ``seq`` is the driver-wide admission counter, so ties replay the exact
    stable-sort order of the scan-based reference (dict insertion order).
    ``discard`` is O(1) lazy: stale entries are skipped on iteration and the
    list is compacted once they outnumber the live ones.
    """

    __slots__ = ("_key", "_entries", "_live")

    def __init__(self, key):
        self._key = key               # job -> sort-key tuple (seq appended)
        self._entries: List[tuple] = []
        self._live: Dict[str, int] = {}      # job_id -> seq of live entry

    def add(self, job: Job, seq: int) -> None:
        self._live[job.id] = seq
        bisect.insort(self._entries, (self._key(job) + (seq,), job))

    def discard(self, job_id: str) -> None:
        if self._live.pop(job_id, None) is None:
            return
        if len(self._entries) > 64 and \
                len(self._entries) > 2 * len(self._live):
            self._entries = [e for e in self._entries
                             if self._live.get(e[1].id) == e[0][-1]]

    def __contains__(self, job_id: str) -> bool:
        return job_id in self._live

    def __len__(self) -> int:
        return len(self._live)

    def items(self):
        """Yield live ``(sort_key, job)`` in key order (O(1) per step +
        amortized stale-entry cleanup)."""
        live = self._live
        for entry in self._entries:
            if live.get(entry[1].id) == entry[0][-1]:
                yield entry

    def jobs(self):
        for _, job in self.items():
            yield job


# ---------------------------------------------------------------------------
# Policies
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TenantPlan:
    """Per-tenant service plan on top of chip quotas.

    ``max_per_tier`` caps *concurrently running jobs* per isolation tier
    (e.g. at most 8 shared notebook slots for lab-a); ``priority_boost`` is
    added to every job priority the tenant submits; ``spot_price_floor`` is
    the lowest usage discount factor spot capacity can reach for this
    tenant.  An absent plan (or absent tier key) means unlimited.
    """
    max_per_tier: Dict[str, int] = field(default_factory=dict)
    priority_boost: int = 0
    spot_price_floor: float = 0.25


class Policy:
    name = "base"

    # failure-aware placement: a reliability-aware policy asks the driver to
    # place *long, wide* gangs on high-reliability pods/nodes (they have the
    # most restart work to lose); short/narrow jobs keep the default packing
    RELIABLE_MIN_CHIPS = 16
    RELIABLE_MIN_EST_S = 600.0
    # default spot price floor for tenants without a plan
    SPOT_PRICE_FLOOR = 0.25
    # hazard-fed admission control (opt-in via ``admission_control``): a
    # long+wide gang is held back while its survival probability on the
    # current fleet sits below the floor — it has the most restart work to
    # lose on a degraded fleet, and predictive maintenance is actively
    # renewing nodes, so waiting is cheaper than restarting.  The rate
    # floor is the fairness valve: once a tenant's rolling admission rate
    # (starts per submission, decayed in ``account``) drops to it, the
    # tenant's gangs pass regardless — throttling defers, never starves.
    ADMIT_SURVIVAL_FLOOR = 0.98
    ADMIT_RATE_FLOOR = 0.5
    # optimistic prior on the rolling rate: a tenant with no history reads
    # as fully admitted (rate 1.0), and the floor only trips after more
    # than ADMIT_RATE_PRIOR recent submissions went unstarted — without it
    # a cold-start tenant's very first wide gang would bypass the throttle
    ADMIT_RATE_PRIOR = 3.0

    def __init__(self, quotas: Optional[Dict[str, int]] = None,
                 tenant_weights: Optional[Dict[str, float]] = None,
                 reliability_aware: bool = False,
                 plans: Optional[Dict[str, TenantPlan]] = None,
                 admission_control: bool = False,
                 ckpt_model: Optional[CheckpointCostModel] = None,
                 ckpt_interval_s: float = 60.0):
        self.quotas = quotas or {}
        self.weights = tenant_weights or {}
        self.reliability_aware = reliability_aware
        self.admission_control = admission_control
        # checkpoint cost model: when set, reliability-aware decisions trade
        # survival probability against the checkpoint tax (save overhead at
        # the driver's checkpoint interval, restore cost on restart)
        self.ckpt_model = ckpt_model
        self.ckpt_interval_s = ckpt_interval_s
        self.plans = plans or {}
        # rolling admission counters (decayed submissions / starts per
        # tenant) — only maintained when admission_control is on
        self._adm_sub: Dict[str, float] = {}
        self._adm_start: Dict[str, float] = {}
        self.usage: Dict[str, float] = {}     # decayed chip-seconds / tenant
        # spot pricing signal: leases handed out vs leases reclaimed, counted
        # at action-emit time so every driver path sees the same history
        self.spot_starts = 0
        self.spot_preempts = 0
        # running-job counts per (tenant, tier) — fed by the driver's
        # job_started/job_stopped hooks; authoritative whenever incremental
        # aggregates are bound (unbound callers scan ``running`` instead)
        self._plan_counts: Dict[Tuple[str, str], int] = {}
        # incremental-driver state: None until a driver binds (legacy callers
        # that invoke schedule()/account() directly keep the scanning paths)
        self._tenant_chips: Optional[Dict[str, int]] = None  # repolint: disable=hook-discipline
        self._tenant_spot: Dict[str, int] = {}
        self._dirty = True                    # job/cluster state changed since
                                              # the last full rebalance
        self._queues: Optional[List[OrderedJobView]] = None
        self._frac_view: Optional[OrderedJobView] = None
        self._admit_seq = itertools.count()   # shared across all views

    # -- incremental driver protocol -----------------------------------------
    # A driver (the simulator or a real control loop) that applies this
    # policy's actions can keep the per-tenant grant aggregate and a change
    # flag up to date, making ``account`` O(tenants) instead of O(running)
    # and letting cadence policies skip no-op rebalances entirely.

    def bind_incremental(self) -> None:
        """Opt in to driver-maintained aggregates (idempotent)."""
        if self._tenant_chips is None:
            self._tenant_chips = {}  # repolint: disable=hook-discipline

    def grant_delta(self, tenant: str, delta: int,
                    spot: bool = False) -> None:
        """Driver hook: ``delta`` chips were granted (+) / released (-);
        ``spot`` marks spot-lease capacity (priced separately)."""
        if self._tenant_chips is not None and delta:
            # repolint: disable=hook-discipline
            self._tenant_chips[tenant] = \
                self._tenant_chips.get(tenant, 0) + delta
            if spot:
                self._tenant_spot[tenant] = \
                    self._tenant_spot.get(tenant, 0) + delta

    def note_change(self) -> None:
        """Driver hook: job/cluster state changed outside this policy's own
        applied actions (arrival, completion, failure, recovery, rollback)."""
        self._dirty = True

    # -- indexed queue protocol ----------------------------------------------
    # A driver that also calls ``bind_queues()`` and then reports every
    # pending/running transition lets the policy keep ordered queue views, so
    # ``schedule`` never sorts the full pending set.  The driver MUST then
    # report *every* transition (add on submit/requeue, remove on start,
    # started/stopped for the running set, progressed whenever a running
    # job's settled progress changes) or the views drift from reality.

    def bind_queues(self) -> None:
        """Opt in to driver-fed ordered queue views (idempotent)."""
        if self._queues is None:
            self._queues = self._make_queues()
            # fractional (mig/shared) jobs route to one shared arrival view
            # for the interactive lane instead of the policy's own queues
            self._frac_view = OrderedJobView(lambda j: (j.submit_time,))

    def _make_queues(self) -> List[OrderedJobView]:
        """Build the policy's pending-membership views (subclass hook)."""
        return []

    def _views_for(self, job: Job) -> Iterable[OrderedJobView]:
        return self._queues

    def job_added(self, job: Job) -> None:
        """Driver hook: ``job`` entered the pending queue (new or requeued)."""
        if self.admission_control:
            self._adm_sub[job.tenant] = \
                self._adm_sub.get(job.tenant, 0.0) + 1.0
        if self._queues is None:
            return
        seq = next(self._admit_seq)
        if job.fractional:
            self._frac_view.add(job, seq)
            return
        for v in self._views_for(job):
            v.add(job, seq)

    def job_removed(self, job: Job) -> None:
        """Driver hook: ``job`` left the pending queue (started/terminal)."""
        if self._queues is None:
            return
        if job.fractional:
            self._frac_view.discard(job.id)
            return
        for v in self._views_for(job):
            v.discard(job.id)

    def job_started(self, job: Job) -> None:
        """Driver hook: ``job`` entered the running set (chips granted).
        Subclass overrides must call super() — the base keeps the per-
        (tenant, tier) running counts TenantPlan concurrency caps use."""
        if self.admission_control:
            self._adm_start[job.tenant] = \
                self._adm_start.get(job.tenant, 0.0) + 1.0
        key = (job.tenant, job.isolation)
        self._plan_counts[key] = self._plan_counts.get(key, 0) + 1

    def job_stopped(self, job: Job) -> None:
        """Driver hook: ``job`` left the running set (see job_started)."""
        key = (job.tenant, job.isolation)
        self._plan_counts[key] = self._plan_counts.get(key, 0) - 1

    def job_progressed(self, job: Job) -> None:
        """Driver hook: a running job's settled progress changed (its
        remaining-time estimate — and any view keyed on it — moved)."""

    def usage_decayed(self, dt: float) -> None:
        """Driver hook, fired by ``account`` after usage decay/accrual: any
        view keyed on per-tenant usage shares must re-key.  The built-in
        FairShare keys its views by (submit_time, seq) *within* a tenant and
        resolves the cross-tenant share order at schedule time, so it needs
        no re-keying; the hook is the seam for policies that cache one."""

    def _tenant_used(self, tenant: str, running: Iterable[Job]) -> int:
        if self._tenant_chips is not None:
            return self._tenant_chips.get(tenant, 0)
        return sum(j.chips for j in running
                   if j.tenant == tenant and not j.fractional)

    # bookkeeping called by the driver with the virtual time elapsed since
    # the last scheduling instant (dt is arbitrary, not a fixed tick)
    def account(self, dt: float, running: Iterable[Job],
                decay: float = 0.999):
        for t in self.usage:
            self.usage[t] *= decay ** dt
        if self.admission_control and dt > 0:
            # same decay clock as usage pricing: the admission rate is a
            # *rolling* starts-per-submission signal, so old history fades
            f = decay ** dt
            for t in self._adm_sub:
                self._adm_sub[t] *= f
            for t in self._adm_start:
                self._adm_start[t] *= f
        if self._tenant_chips is not None:
            for t, c in self._tenant_chips.items():
                if c:
                    sc = self._tenant_spot.get(t, 0)
                    if sc:   # spot capacity accrues at the discounted price
                        c = c - sc + sc * self.spot_price_factor(t)
                    self.usage[t] = self.usage.get(t, 0.0) + c * dt
        else:
            for j in running:
                if j.fractional:
                    continue     # sub-chip quanta are outside chip pricing
                c = j.chips
                if j.spot:
                    c = c * self.spot_price_factor(j.tenant)
                self.usage[j.tenant] = \
                    self.usage.get(j.tenant, 0.0) + c * dt
        self.usage_decayed(dt)

    def spot_price_factor(self, tenant: Optional[str] = None) -> float:
        """Usage price of a spot chip relative to on-demand, in
        [floor, 1]: 1 minus the observed preemption risk (reclaims per
        lease), floored by the tenant's plan."""
        plan = self.plans.get(tenant) if tenant is not None else None
        floor = plan.spot_price_floor if plan is not None \
            else self.SPOT_PRICE_FLOOR
        if not self.spot_starts:
            return 1.0
        return max(floor, 1.0 - self.spot_preempts / self.spot_starts)

    def wakeup_interval(self) -> Optional[float]:
        """Seconds between periodic invocations the policy wants even when no
        job/cluster state changes; None = event-driven invocation only."""
        return None

    def admission_rate(self, tenant: str) -> float:
        """Rolling share of a tenant's recent submissions that started,
        smoothed by the optimistic prior (1.0 with no recent history)."""
        sub = self._adm_sub.get(tenant, 0.0)
        start = self._adm_start.get(tenant, 0.0)
        return min(1.0, (start + self.ADMIT_RATE_PRIOR)
                   / (sub + self.ADMIT_RATE_PRIOR))

    def _admission_ok(self, job: Job, cluster: Cluster) -> bool:
        """Hazard-fed admission throttle (True unless ``admission_control``):
        hold a long+wide gang back while the fleet it would land on gives it
        a survival probability below the floor, unless the tenant's rolling
        admission rate already fell to the fairness floor."""
        if not self.admission_control:
            return True
        if job.requested < self.RELIABLE_MIN_CHIPS or \
                job.spec.estimated_duration_s < self.RELIABLE_MIN_EST_S:
            return True
        surv = cluster.survival_probability(
            job.spec.estimated_duration_s, job.requested)
        if surv >= self.ADMIT_SURVIVAL_FLOOR:
            return True
        return self.admission_rate(job.tenant) < self.ADMIT_RATE_FLOOR

    def _restart_tax_s(self, job: Job) -> float:
        """Seconds a preempted ``job`` would pay to restore from its last
        checkpoint (0 without a cost model): checkpoint-aware victim
        selection prefers victims that are cheap to resume."""
        if self.ckpt_model is None:
            return 0.0
        return self.ckpt_model.restore_cost_s(
            self.ckpt_model.job_size_gb(job.spec.resources),
            float(job.chips or job.requested))

    def _mk_start(self, job: Job, chips: int) -> Start:
        """Start action; flags failure-aware placement for long, wide jobs
        when this policy is reliability-aware."""
        if job.spot:
            self.spot_starts += 1
        return Start(job.id, chips,
                     reliable=self.reliability_aware
                     and job.requested >= self.RELIABLE_MIN_CHIPS
                     and job.spec.estimated_duration_s
                     >= self.RELIABLE_MIN_EST_S)

    def _emit_preempt(self, job: Job, reason: str = "priority") -> Preempt:
        """Preempt action; records spot reclaims for the pricing signal."""
        if job.spot:
            self.spot_preempts += 1
        return Preempt(job.id, reason)

    def job_priority(self, job: Job) -> int:
        """Submitted priority plus the tenant plan's boost."""
        plan = self.plans.get(job.tenant)
        return job.priority + (plan.priority_boost if plan is not None else 0)

    def _quota_ok(self, job: Job, running: Iterable[Job], chips: int,
                  started: Optional[Dict[str, int]] = None) -> bool:
        """Would granting ``chips`` keep ``job``'s tenant inside its quota?

        ``started`` accumulates chips granted earlier in this same scheduling
        instant (per tenant), so one instant cannot overshoot the quota.  With
        driver-fed aggregates the check is O(1); unbound callers fall back to
        scanning ``running``.
        """
        q = self.quotas.get(job.tenant)
        if q is None:
            return True
        used = self._tenant_used(job.tenant, running)
        if started:
            used += started.get(job.tenant, 0)
        return used + chips <= q

    def _plan_ok(self, job: Job, running: Iterable[Job],
                 stier: Optional[Dict[Tuple[str, str], int]] = None) -> bool:
        """Would starting ``job`` keep its tenant inside the plan's per-tier
        running-job cap?  ``stier`` accumulates (tenant, tier) starts granted
        earlier in this same instant.  O(1) with driver-fed counts; unbound
        callers scan ``running``."""
        plan = self.plans.get(job.tenant)
        if plan is None:
            return True
        cap = plan.max_per_tier.get(job.isolation)
        if cap is None:
            return True
        if self._tenant_chips is not None:
            used = self._plan_counts.get((job.tenant, job.isolation), 0)
        else:
            used = sum(1 for j in running if j.tenant == job.tenant
                       and j.isolation == job.isolation)
        if stier:
            used += stier.get((job.tenant, job.isolation), 0)
        return used < cap

    def _note_started(self, job: Job, chips,
                      started: Dict[str, int],
                      stier: Optional[Dict[Tuple[str, str], int]] = None
                      ) -> None:
        """Record an intra-instant grant in the quota + plan accumulators."""
        started[job.tenant] = started.get(job.tenant, 0) + chips
        if self.plans and stier is not None:
            k = (job.tenant, job.isolation)
            stier[k] = stier.get(k, 0) + 1

    @staticmethod
    def _exclusive(pending: Iterable[Job]) -> Iterable[Job]:
        """Whole-chip jobs only (the scan-based queue source; bound views
        never contain fractional jobs in the first place)."""
        return (j for j in pending if not j.fractional)

    def _spot_victims(self, running: Iterable[Job],
                      preempted: set) -> List[Job]:
        """Running spot jobs available for reclaim, newest lease first (the
        shortest-held lease loses; id breaks same-instant ties)."""
        return sorted(
            (j for j in running
             if j.spot and not j.fractional and j.id not in preempted),
            key=lambda j: (-(j.start_time if j.start_time is not None
                             else 0.0), j.id))

    def _spot_reclaim(self, job: Job, running: Iterable[Job], free: int,
                      preempted: set) -> Optional[Tuple[List[Job], int]]:
        """Pick spot victims so a blocked non-spot ``job`` fits.  Returns
        (victims, chips_free_after_reclaim) or None if even reclaiming every
        spot lease leaves the gang short.  No-op for spot jobs themselves —
        spot never preempts spot."""
        if job.spot or job.fractional:
            return None
        victims = self._spot_victims(running, preempted)
        if not victims:
            return None
        gain = free
        chosen: List[Job] = []
        for v in victims:
            chosen.append(v)
            gain += v.chips
            if gain >= job.requested:
                return chosen, gain
        return None

    # -- scheduling ----------------------------------------------------------

    def schedule(self, now: float, pending: List[Job], running: List[Job],
                 cluster: Cluster) -> List[Action]:
        """Exclusive-tier policy pass, then the shared fractional lane."""
        actions = self._schedule_exclusive(now, pending, running, cluster)
        self._frac_pass(pending, running, cluster, actions)
        return actions

    def _frac_pass(self, pending, running, cluster: Cluster,
                   actions: List[Action]) -> None:
        """Fractional interactive lane (all policies share it): mig/shared
        sub-chip jobs start FIFO by submit time into per-tier slot capacity,
        independent of the exclusive policy above, so small interactive jobs
        never queue behind training gangs."""
        if self._queues is not None:
            if not len(self._frac_view):
                return
            queue = self._frac_view.jobs()
        else:
            frac = [j for j in pending if j.fractional]
            if not frac:
                return
            queue = iter(sorted(frac, key=lambda j: j.submit_time))
        free = {t: cluster.free_slots(t) for t in FRACTIONAL_TIERS}
        stier: Dict[Tuple[str, str], int] = {}
        for job in queue:
            # tenant chip quotas govern the exclusive tier only; the
            # fractional lane is capped by the plan's per-tier limits
            if job.quanta <= free[job.isolation] and \
                    self._plan_ok(job, running, stier):
                actions.append(self._mk_start(job, job.requested))
                if self.plans:
                    k = (job.tenant, job.isolation)
                    stier[k] = stier.get(k, 0) + 1
                free[job.isolation] -= job.quanta

    def _schedule_exclusive(self, now: float, pending: List[Job],
                            running: List[Job], cluster: Cluster
                            ) -> List[Action]:
        raise NotImplementedError


class FIFO(Policy):
    name = "fifo"

    def _make_queues(self):
        self._arrival = OrderedJobView(lambda j: (j.submit_time,))
        return [self._arrival]

    def _schedule_exclusive(self, now, pending, running, cluster):
        actions: List[Action] = []
        free = cluster.free_chips()
        started: Dict[str, int] = {}          # tenant -> chips this instant
        stier: Dict[Tuple[str, str], int] = {}
        preempted: set = set()
        queue = self._arrival.jobs() if self._queues is not None \
            else sorted(self._exclusive(pending), key=lambda j: j.submit_time)
        for job in queue:
            if not self._admission_ok(job, cluster):
                continue     # throttled, not blocked: later jobs may pass
            ok = self._quota_ok(job, running, job.requested, started) and \
                self._plan_ok(job, running, stier)
            if ok and job.requested <= free:
                actions.append(self._mk_start(job, job.requested))
                self._note_started(job, job.requested, started, stier)
                free -= job.requested
                continue
            if ok and job.requested > free:
                # head blocked on capacity: reclaim spot leases if enough
                rec = self._spot_reclaim(job, running, free, preempted)
                if rec is not None:
                    victims, gain = rec
                    for v in victims:
                        actions.append(self._emit_preempt(v, "spot-reclaim"))
                        preempted.add(v.id)
                    actions.append(self._mk_start(job, job.requested))
                    self._note_started(job, job.requested, started, stier)
                    free = gain - job.requested
                    continue
            break                          # strict FIFO: no overtaking
        return actions


class EASYBackfill(Policy):
    name = "backfill"

    def _make_queues(self):
        self._arrival = OrderedJobView(lambda j: (j.submit_time,))
        # release-time index over *running* jobs: keyed by the remaining-time
        # constant (remaining_estimate(now) = now + key for every job between
        # progress settlements), fed by job_started/job_stopped/job_progressed
        self._release = OrderedJobView(lambda j: (j.remaining_estimate(0.0),))
        return [self._arrival]

    def job_started(self, job):
        super().job_started(job)
        # fractional jobs never block an exclusive head's reservation, so
        # their (sub-chip) releases stay out of the index
        if self._queues is not None and not job.fractional:
            self._release.add(job, next(self._admit_seq))

    def job_stopped(self, job):
        super().job_stopped(job)
        if self._queues is not None:
            self._release.discard(job.id)

    def job_progressed(self, job):
        if self._queues is not None and job.id in self._release:
            self._release.discard(job.id)
            self._release.add(job, next(self._admit_seq))

    def _schedule_exclusive(self, now, pending, running, cluster):
        actions: List[Action] = []
        free = cluster.free_chips()
        started: Dict[str, int] = {}
        stier: Dict[Tuple[str, str], int] = {}
        preempted: set = set()
        queue = self._arrival.jobs() if self._queues is not None \
            else iter(sorted(self._exclusive(pending),
                             key=lambda j: j.submit_time))
        head: Optional[Job] = None
        for job in queue:                  # start the queue head while it fits
            if not self._admission_ok(job, cluster):
                continue      # throttled jobs neither start nor become head
            if job.requested <= free and \
                    self._quota_ok(job, running, job.requested, started) and \
                    self._plan_ok(job, running, stier):
                actions.append(self._mk_start(job, job.requested))
                self._note_started(job, job.requested, started, stier)
                free -= job.requested
            else:
                head = job
                break
        if head is None:
            return actions
        # capacity-blocked head: reclaim spot leases before reserving
        if head.requested > free and \
                self._quota_ok(head, running, head.requested, started) and \
                self._plan_ok(head, running, stier):
            rec = self._spot_reclaim(head, running, free, preempted)
            if rec is not None:
                victims, gain = rec
                for v in victims:
                    actions.append(self._emit_preempt(v, "spot-reclaim"))
                    preempted.add(v.id)
                actions.append(self._mk_start(head, head.requested))
                self._note_started(head, head.requested, started, stier)
                return actions     # next instant resumes reservation service
        # reservation: when will enough chips free up for the head job?
        if self._queues is not None:
            releases = ((now + key[0], job.chips)
                        for key, job in self._release.items())
        else:
            releases = iter(sorted(
                (j.remaining_estimate(now), j.chips) for j in running
                if j.chips > 0 and not j.fractional))
        avail = free
        reserve_at = float("inf")
        for t_rel, chips in releases:
            avail += chips
            if avail >= head.requested:
                reserve_at = t_rel
                break
        # backfill: a later job may start iff it fits now AND finishes
        # before the reservation (or uses chips the head doesn't need)
        shadow_free = free
        for job in queue:                  # continues after the head
            if shadow_free == 0:
                break
            if not self._admission_ok(job, cluster):
                continue
            fits = job.requested <= shadow_free
            ends_before = now + job.spec.estimated_duration_s <= reserve_at
            spare = shadow_free - head.requested >= job.requested
            if fits and (ends_before or spare) and \
                    self._quota_ok(job, running, job.requested, started) and \
                    self._plan_ok(job, running, stier):
                actions.append(self._mk_start(job, job.requested))
                self._note_started(job, job.requested, started, stier)
                shadow_free -= job.requested
        return actions


class FairShare(Policy):
    name = "fair"

    def _make_queues(self):
        self._tenant_views: Dict[str, OrderedJobView] = {}
        return []                          # views are created per tenant

    def _views_for(self, job):
        view = self._tenant_views.get(job.tenant)
        if view is None:
            view = self._tenant_views[job.tenant] = \
                OrderedJobView(lambda j: (j.submit_time,))
        return (view,)

    def _share(self, tenant: str) -> float:
        w = self.weights.get(tenant, 1.0)
        return self.usage.get(tenant, 0.0) / max(w, 1e-9)

    def _schedule_exclusive(self, now, pending, running, cluster):
        actions: List[Action] = []
        free = cluster.free_chips()
        started: Dict[str, int] = {}
        stier: Dict[Tuple[str, str], int] = {}
        if self._queues is not None:
            # k-way merge of the per-tenant arrival views, keyed by the
            # tenant's *current* share: identical order to the scan-based
            # stable sort, at O(scanned * log tenants)
            def stream(share, view):
                return ((share + key, job) for key, job in view.items())
            streams = [stream((self._share(t),), view)
                       for t, view in self._tenant_views.items() if view]
            queue = (job for _, job in heapq.merge(*streams))
        else:
            queue = iter(sorted(
                self._exclusive(pending),
                key=lambda j: (self._share(j.tenant), j.submit_time)))
        for job in queue:
            if free == 0:
                break                      # nothing can start any more
            if not self._admission_ok(job, cluster):
                continue
            if job.requested <= free and \
                    self._quota_ok(job, running, job.requested, started) and \
                    self._plan_ok(job, running, stier):
                actions.append(self._mk_start(job, job.requested))
                self._note_started(job, job.requested, started, stier)
                free -= job.requested
        return actions


class PriorityPreempt(Policy):
    name = "priority"

    def _make_queues(self):
        self._prio = OrderedJobView(
            lambda j: (-self.job_priority(j), j.submit_time))
        return [self._prio]

    def _schedule_exclusive(self, now, pending, running, cluster):
        actions: List[Action] = []
        free = cluster.free_chips()
        preempted: set = set()
        started: Dict[str, int] = {}
        stier: Dict[Tuple[str, str], int] = {}
        queue = self._prio.jobs() if self._queues is not None \
            else iter(sorted(
                self._exclusive(pending),
                key=lambda j: (-self.job_priority(j), j.submit_time)))
        victims: Optional[List[Job]] = None   # sorted once, on first demand
        has_spot = False
        floor: Optional[float] = None         # lowest preemptible priority
        for job in queue:
            if not self._admission_ok(job, cluster):
                continue
            if not (self._quota_ok(job, running, job.requested, started)
                    and self._plan_ok(job, running, stier)):
                continue
            if job.requested <= free:
                actions.append(self._mk_start(job, job.requested))
                self._note_started(job, job.requested, started, stier)
                free -= job.requested
                continue
            if job.spot:
                continue      # spot starts into free capacity only
            # try checkpoint-then-preempt: spot leases rank below every
            # priority, then strictly lower-priority preemptible jobs
            if floor is None:
                floor = min((self.job_priority(j) for j in running
                             if j.spec.resources.preemptible
                             and not j.spot and not j.fractional),
                            default=float("inf"))
                has_spot = any(j.spot and not j.fractional for j in running)
            prio = self.job_priority(job)
            if prio <= floor and not has_spot:
                if free == 0 and floor == float("inf"):
                    break                  # no fit and nothing preemptible
                continue                   # no strictly-lower victims exist
            if victims is None:
                # within a (spot, priority) class, checkpoint-aware victim
                # selection takes the gang cheapest to resume first (the
                # restart tax is 0.0 for every job without a cost model, so
                # the historical newest-first order is unchanged then)
                victims = sorted(
                    (j for j in running if not j.fractional
                     and (j.spec.resources.preemptible or j.spot)),
                    key=lambda j: (0 if j.spot else 1, self.job_priority(j),
                                   self._restart_tax_s(j),
                                   -j.start_time if j.start_time is not None
                                   else 0.0))
            gain = free
            chosen = []
            for v in victims:
                if v.id in preempted:
                    continue
                if not v.spot and self.job_priority(v) >= prio:
                    continue
                chosen.append(v)
                gain += v.chips
                if gain >= job.requested:
                    break
            if gain >= job.requested:
                for v in chosen:
                    actions.append(self._emit_preempt(v))
                    preempted.add(v.id)
                actions.append(self._mk_start(job, job.requested))
                self._note_started(job, job.requested, started, stier)
                free = gain - job.requested
        return actions


class GoodputElastic(Policy):
    """Pollux-style: distribute chips by greedy marginal goodput; elastic jobs
    resize live (checkpoint-resize-resume in the execution layer).

    When ``reliability_aware``, marginal goodput is weighted by *pod locality
    x survival probability over the job's predicted remaining runtime*: an
    extra chip is worth less on a gang that is likely to lose it to a node
    failure before finishing (wide + long on an aged fleet), and less again
    once the grant spills across pods.  The weighting is deterministic and
    rides the same incremental driver protocol — failures already flip the
    change flag, so clean cadence wakeups still skip recomputation."""
    name = "goodput"

    CROSS_POD_LOCALITY = 0.5      # discount once a grant no longer fits a pod

    def __init__(self, *args, rebalance_every: float = 30.0, **kw):
        super().__init__(*args, **kw)
        self.rebalance_every = rebalance_every
        self._last = -1e9

    def _grant_score(self, job: Job, chips: int, cluster: Cluster) -> float:
        """Pod locality x P(gang survives its predicted remaining runtime)."""
        rate = job.steps_per_s(chips, chips > cluster.pod_capacity_chips)
        remaining_s = max(0.0, job.total_steps - job.progress) \
            / max(rate, 1e-12)
        score = cluster.survival_probability(remaining_s, chips)
        if chips > cluster.pod_capacity_chips:
            score *= self.CROSS_POD_LOCALITY
        if self.ckpt_model is not None:
            # checkpoint tax: the wall-time fraction a gang of this size
            # spends saving state instead of stepping — survival gained by
            # going wider is traded against the barrier cost of the width
            score *= 1.0 - self.ckpt_model.overhead_fraction(
                self.ckpt_model.job_size_gb(job.spec.resources), chips,
                self.ckpt_interval_s)
        return score

    def _marginal(self, job: Job, chips: int, cluster: Cluster) -> float:
        """Goodput gain of chip ``chips+1``, reliability-weighted when on."""
        d = job.steps_per_s(chips + 1) - job.steps_per_s(chips)
        if self.reliability_aware:
            d *= self._grant_score(job, chips + 1, cluster)
        return d

    def wakeup_interval(self):
        return self.rebalance_every

    def _make_queues(self):
        self._arrival = OrderedJobView(lambda j: (j.submit_time,))
        return [self._arrival]

    def _admit_only(self, pending, running, cluster):
        """Between rebalances: start new arrivals into *free* capacity only.
        Resizes/preemptions of running jobs wait for the cadence, so a
        checkpoint-resize storm can't happen on every scheduling instant."""
        actions: List[Action] = []
        free = cluster.free_chips()
        if not pending or free <= 0:
            return actions
        granted: Dict[str, int] = {}          # tenant -> chips this round
        stier: Dict[Tuple[str, str], int] = {}
        queue = self._arrival.jobs() if self._queues is not None \
            else sorted(self._exclusive(pending),
                        key=lambda j: j.submit_time)
        for j in queue:
            if free <= 0:
                break
            if not self._admission_ok(j, cluster):
                continue
            need = j.min_chips if j.elastic else j.requested
            if not 0 < need <= free:
                continue
            if not self._plan_ok(j, running, stier):
                continue
            grant = min(free, j.requested) if j.elastic else j.requested
            q = self.quotas.get(j.tenant)
            if q is not None:
                used = self._tenant_used(j.tenant, running) \
                    + granted.get(j.tenant, 0)
                if j.elastic:                 # shrink into quota headroom
                    grant = min(grant, q - used)
                if grant < need or used + grant > q:
                    continue
            actions.append(self._mk_start(j, grant))
            self._note_started(j, grant, granted, stier)
            free -= grant
        return actions

    def _schedule_exclusive(self, now, pending, running, cluster):
        if now - self._last < self.rebalance_every:
            return self._admit_only(pending, running, cluster)
        self._last = now
        # Incremental fast path: when a driver keeps the change flag and
        # nothing happened since the last rebalance, the job set and cluster
        # capacity are unchanged, so the (deterministic) grant computation
        # would reproduce the allocation that is already in place — skip it.
        if self._tenant_chips is not None and not self._dirty:
            return []
        self._dirty = False
        # fractional jobs live outside the goodput budget: they consume
        # mig/shared quanta, not the exclusive chips rebalanced here
        # admission control holds *pending* throttled gangs out of the
        # rebalance entirely (running jobs are never revoked by it —
        # admission throttles entry, it does not evict)
        jobs = [j for j in itertools.chain(running, pending)
                if j.state in (JobState.RUNNING, JobState.PENDING)
                and not j.fractional
                and (j.state == JobState.RUNNING
                     or self._admission_ok(j, cluster))]
        if not jobs:
            return []
        total = cluster.exclusive_capacity()
        grant = {j.id: 0 for j in jobs}
        # seed each job with min_chips in arrival order while they fit;
        # spot jobs seed last — they only hold capacity nobody else wants
        budget = total
        for j in sorted(jobs, key=lambda j: (j.spot, j.submit_time)):
            need = j.min_chips if j.elastic else j.requested
            if need <= budget:
                grant[j.id] = need
                budget -= need
        # greedy marginal goodput on elastic jobs
        heap = []
        for j in jobs:
            if j.elastic and grant[j.id] and grant[j.id] < j.requested:
                d = self._marginal(j, grant[j.id], cluster)
                heapq.heappush(heap, (-d, j.submit_time, j.id))
        by_id = {j.id: j for j in jobs}
        while budget > 0 and heap:
            _, _, jid = heapq.heappop(heap)
            j = by_id[jid]
            grant[jid] += 1
            budget -= 1
            if grant[jid] < j.requested:
                d = self._marginal(j, grant[jid], cluster)
                heapq.heappush(heap, (-d, j.submit_time, jid))
        actions: List[Action] = []
        stier: Dict[Tuple[str, str], int] = {}
        for j in running:
            g = grant.get(j.id, j.chips)
            if g == 0:
                actions.append(self._emit_preempt(j, "goodput-rebalance"))
            elif g != j.chips:
                actions.append(Resize(j.id, g))
        for j in pending:
            if grant.get(j.id, 0) > 0 and self._plan_ok(j, running, stier):
                actions.append(self._mk_start(j, grant[j.id]))
                if self.plans:
                    k = (j.tenant, j.isolation)
                    stier[k] = stier.get(k, 0) + 1
        return actions


POLICIES = {p.name: p for p in
            (FIFO, EASYBackfill, FairShare, PriorityPreempt, GoodputElastic)}


def make_policy(name: str, **kw) -> Policy:
    return POLICIES[name](**kw)
