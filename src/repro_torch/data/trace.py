"""Trace-driven campus workload layer for the cluster simulator.

The scheduler benchmarks reproduce the paper's shared-cluster claims by
replaying *traces*: a serializable bundle of job arrivals plus operational
events (node failures, recoveries, straggler slowdowns). A trace is either
synthesized from :class:`TraceConfig` — paper-shaped campus workloads with
diurnal Poisson arrivals, heavy-tailed job widths, a weighted tenant mix,
elastic/priority fractions and configurable failure/straggler processes
(including correlated rack failures that take out a contiguous host group)
— or hand-built from explicit :class:`TraceJob` rows, and can be saved to /
loaded from JSON so a policy comparison replays byte-identical workloads
across engines, seeds and future PRs.

Trace JSON format (``Trace.to_dict``)::

    {"format": 3,
     "meta":   {...TraceConfig echo or free-form...},
     "jobs":   [{id, submit_time, chips, total_steps, tenant, min_chips,
                 priority, preemptible, work_per_step, comm_frac,
                 estimated_duration_s, isolation, spot}, ...],
     "events": [{time, kind, node, value, info}, ...],
     "incidents": [{node, start, kind, repair_s, age_days}, ...],
     "node_ages": {node_id: age_days, ...}}

Format 2 adds the reliability layer: per-node install ages, an
age-dependent Weibull failure process (hazard grows with node age — the
campus fleets' wear-out curve, à la the Meta reliability study), lognormal
repair times split into *transient* restarts and *hard* repairs, and
first-class :class:`Incident` records next to the flat event list.

Format 3 adds the isolation-tier mix: each job row carries an
``isolation`` tier (``exclusive`` whole chips / ``mig`` fractional
partitions / ``shared`` time-sliced slots) and a ``spot`` flag, and
``chips`` may be an exact ``"p/q"`` fraction of one chip for sub-chip
interactive jobs.  :class:`TraceConfig` grows matching knobs
(``interactive_frac`` / ``spot_frac`` / per-host tier pools) that draw new
randoms *only when enabled*, so format-1/2 configs resynthesize
byte-identically and their committed artifacts keep replaying unchanged.
Format 1/2 traces still load, with tier defaults filled in.

``Trace.install(sim, compiler)`` compiles each row into a TaskSpec ->
ExecutionPlan -> Job and submits it together with the injected events, and
installs the per-node install ages into the sim's cluster so failure-aware
placement sees the age signal from t=0.

Streaming (year-1M scale): everything above also exists as a constant-memory
path that never materializes the job list.  :func:`synthesize_stream` wraps
a config in a :class:`StreamTrace` whose ``iter_jobs()`` regenerates rows on
demand from the seed (the ops events are recovered by replaying the rng
stream once with the rows discarded, so streamed and materialized synthesis
are byte-identical); :func:`write_trace` writes job rows incrementally into
the same byte-stable gzip container ``Trace.save`` produces;
:class:`TraceReader` pull-parses an artifact row by row; and
``install_stream``/:class:`StreamTrace.install` feed the sim's lazy arrival
source (``ClusterSim.feed``) through the same memoized spec compilation as
``Trace.install``, so a 1M-job year replays without the flat job list, the
per-row Job graph, or the full event heap ever being resident at once.

Virtual-time only; nothing here touches JAX.

The port's copy of ``repro/data/trace.py``, verbatim apart from its
imports; ``tests/test_torch_trace.py`` holds its artifacts byte-equal to
the reference's and its replays equal.
"""
from __future__ import annotations

import dataclasses
import gzip
import itertools
import json
import math
import random
from dataclasses import dataclass, field
from fractions import Fraction
from typing import (Dict, IO, Iterable, Iterator, List, Optional, Sequence,
                    Tuple, Union)

from repro_torch.core.schema import (TIER_QUANTA, ResourceSpec,
                                     RuntimeEnv, TaskSpec, chips_repr,
                                     parse_chips)
from repro_torch.core.scheduler import Job
from repro_torch.core.sim import SimEvent

TRACE_FORMAT = 3            # current write format
_READ_FORMATS = (1, 2, 3)   # still-loadable formats


@dataclass
class TraceJob:
    """One job row of a workload trace (pure data, compiler-independent)."""
    id: str
    submit_time: float
    chips: Union[int, str]            # int, or "p/q" chip fraction (sub-chip)
    total_steps: int
    tenant: str = "default"
    min_chips: int = 0                # >0 and < chips => elastic
    priority: int = 0
    preemptible: bool = True
    work_per_step: float = 1.0        # per-step chip-seconds of compute
    comm_frac: float = 0.05
    estimated_duration_s: float = 0.0
    isolation: str = "exclusive"      # exclusive | mig | shared
    spot: bool = False                # priced by preemption risk, reclaimable

    def to_spec(self) -> TaskSpec:
        return TaskSpec(
            name=self.id, tenant=self.tenant,
            resources=ResourceSpec(chips=self.chips, min_chips=self.min_chips,
                                   priority=self.priority,
                                   preemptible=self.preemptible,
                                   isolation=self.isolation, spot=self.spot),
            runtime=RuntimeEnv(backend="shell"),
            entry={"work_per_step": self.work_per_step,
                   "comm_frac": self.comm_frac},
            total_steps=self.total_steps,
            estimated_duration_s=self.estimated_duration_s
            or float(self.total_steps))


@dataclass
class ReliabilityConfig:
    """Age-dependent node-failure model (Weibull hazard + lognormal repair).

    Each node draws an install age uniformly from ``age_days``; failures are
    then sampled from the Weibull hazard at the node's (advancing) age via
    thinning, so old nodes fail more often than young ones whenever
    ``weibull_shape > 1`` (wear-out).  Every failure becomes an
    :class:`Incident`: *transient* (process wedge / restart, short lognormal
    repair) with probability ``transient_frac``, else *hard* (part swap, long
    lognormal repair); the node is down until its repair completes and
    cannot fail again meanwhile.
    """
    age_days: Tuple[float, float] = (30.0, 1460.0)   # install-age range
    weibull_shape: float = 1.5        # >1: hazard increases with age
    weibull_scale_days: float = 600.0  # characteristic life
    transient_frac: float = 0.7
    repair_transient_s: Tuple[float, float] = (300.0, 0.6)   # median, sigma
    repair_hard_s: Tuple[float, float] = (10800.0, 0.9)      # median, sigma
    # planned-maintenance repair time (median, sigma): what a *proactive*
    # drain pays instead of a reactive hard repair — parts staged, no
    # diagnosis, scheduled off-peak.  Consumed by the sim's predictive-ops
    # layer only (never drawn during synthesis), so the trace rng stream,
    # artifact bytes and replay of unsignalled fleets are all unchanged.
    repair_planned_s: Tuple[float, float] = (1800.0, 0.4)


def hazard_per_day(age_days: float, shape: float,
                   scale_days: float) -> float:
    """Weibull hazard h(t) = (k/l) * (t/l)^(k-1) in failures/day.

    Monotonically increasing in age for shape > 1 (wear-out), decreasing for
    shape < 1 (infant mortality), constant at 1/scale for shape == 1.
    """
    t = max(age_days, 1e-9) / scale_days
    return (shape / scale_days) * t ** (shape - 1.0)


def mtbf_days(age_days: float, shape: float, scale_days: float) -> float:
    """Instantaneous MTBF at the given node age (1 / hazard)."""
    return 1.0 / hazard_per_day(age_days, shape, scale_days)


@dataclass
class Incident:
    """One node-failure incident of a trace (pure data)."""
    node: str
    start: float              # sim time of the failure
    kind: str                 # "transient" | "hard"
    repair_s: float           # sampled repair duration
    age_days: float           # node age when it failed


@dataclass
class TraceConfig:
    """Knobs for :func:`synthesize` (paper-shaped campus workload)."""
    n_jobs: int = 60
    seed: int = 0
    # arrivals: Poisson at rate 1/mean_gap_s, optionally modulated by a
    # sinusoidal diurnal factor 1 + A*sin(2*pi*t/period) (thinning sampler)
    mean_gap_s: float = 18.0
    diurnal_amplitude: float = 0.0    # 0 = homogeneous Poisson
    diurnal_period_s: float = 86400.0
    # widths: sampled from `widths`; with width_alpha set, P(w) ~ w^-alpha
    # over the distinct widths (heavy tail), else uniform over the list
    widths: Tuple[int, ...] = (4, 4, 8, 8, 8, 16, 16, 32, 64, 128, 256)
    width_alpha: Optional[float] = None
    steps_min: int = 60
    steps_max: int = 600
    tenants: Tuple[Tuple[str, float], ...] = (("lab-a", 2.0), ("lab-b", 1.0),
                                              ("lab-c", 1.0))
    elastic_frac: float = 0.4         # fraction of jobs that may run shrunk
    priority_frac: float = 0.1        # fraction submitted as high priority
    high_priority: int = 5
    work_per_chip: float = 0.9        # work_per_step = chips * work_per_chip
    comm_frac: float = 0.06
    est_noise: Tuple[float, float] = (0.9, 1.4)   # runtime-estimate error
    # operational events over [ops_start, ops_start + ops_window]
    n_failures: int = 4
    rack_failure_frac: float = 0.0    # fraction of failures hitting a rack
    rack_size: int = 4                # contiguous hosts per correlated failure
    recover_s: Tuple[float, float] = (120.0, 600.0)
    n_stragglers: int = 4
    slow_factor: Tuple[float, float] = (0.15, 0.5)
    slow_duration_s: Tuple[float, float] = (200.0, 800.0)
    ops_start: float = 200.0
    ops_window: float = 3800.0
    # age-dependent failure model; None keeps the memoryless n_failures
    # process only (both can coexist: uniform failures model e.g. operator
    # error, the reliability model age-driven hardware wear)
    reliability: Optional[ReliabilityConfig] = None
    # format-3 tier mix.  All randoms behind these knobs are drawn only when
    # the knob is enabled, so configs with the defaults resynthesize
    # byte-identically to format 1/2.
    interactive_frac: float = 0.0     # fraction of jobs that are sub-chip
    interactive_shared_frac: float = 0.5   # of those: shared (vs mig) tier
    interactive_steps: Tuple[int, int] = (20, 120)
    spot_frac: float = 0.0            # fraction of batch jobs run as spot
    # per-host chip pools carved out for the fractional tiers; the bench
    # builds its cluster from these so trace + cluster shape travel together
    mig_chips_per_host: int = 0
    shared_chips_per_host: int = 0


@dataclass
class Trace:
    jobs: List[TraceJob]
    events: List[SimEvent] = field(default_factory=list)
    meta: Dict = field(default_factory=dict)
    incidents: List[Incident] = field(default_factory=list)
    node_ages: Dict[str, float] = field(default_factory=dict)

    # -- replay --------------------------------------------------------------

    def materialize(self, compiler) -> List[Job]:
        """Compile every row into a Job (see :func:`compile_jobs`)."""
        return list(compile_jobs(self.jobs, compiler))

    def install(self, sim, compiler, chunk: int = 2048) -> None:
        """Submit every job, inject every event, and install node install
        ages into a ClusterSim's cluster.  Jobs are compiled and submitted
        in chunks straight off the row list — the full Job list of
        ``materialize`` is never built, so peak memory during install is
        one chunk of compiled jobs plus whatever the sim retains."""
        for nid, age in self.node_ages.items():
            if nid in sim.cluster.nodes:
                sim.cluster.set_node_age(nid, age)
        it = compile_jobs(self.jobs, compiler)
        while True:
            batch = list(itertools.islice(it, chunk))
            if not batch:
                break
            for job in batch:
                sim.submit(job)
        for ev in self.events:
            sim.inject(SimEvent(ev.time, ev.kind, ev.node, ev.value, ev.info))

    # -- (de)serialization ---------------------------------------------------

    def to_dict(self) -> Dict:
        # round-trip meta through JSON so tuples normalize to lists and
        # to_dict() compares equal before and after save/load
        return {"format": TRACE_FORMAT,
                "meta": json.loads(json.dumps(self.meta)),
                "jobs": [dataclasses.asdict(j) for j in self.jobs],
                "events": [dataclasses.asdict(e) for e in self.events],
                "incidents": [dataclasses.asdict(i) for i in self.incidents],
                "node_ages": dict(self.node_ages)}

    @classmethod
    def from_dict(cls, d: Dict) -> "Trace":
        if d.get("format") not in _READ_FORMATS:
            raise ValueError(f"unsupported trace format {d.get('format')!r}")
        return cls(jobs=[TraceJob(**j) for j in d["jobs"]],
                   events=[SimEvent(**e) for e in d["events"]],
                   meta=d.get("meta", {}),
                   incidents=[Incident(**i) for i in d.get("incidents", [])],
                   node_ages=d.get("node_ages", {}))

    def save(self, path: str) -> None:
        """Write the trace as JSON; a ``.gz`` suffix selects a byte-stable
        gzip container (mtime pinned to 0, compact separators) so committed
        trace artifacts don't churn when regenerated.  The ``.gz`` path
        routes through the incremental :func:`write_trace` writer — the
        same bytes a streamed save produces."""
        if path.endswith(".gz"):
            write_trace(path, self.jobs, events=self.events,
                        incidents=self.incidents, meta=self.meta,
                        node_ages=self.node_ages)
        else:
            with open(path, "w") as f:
                json.dump(self.to_dict(), f, indent=1, sort_keys=True)

    @classmethod
    def load(cls, path: str) -> "Trace":
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as f:
            return cls.from_dict(json.load(f))


# ---------------------------------------------------------------------------
# Streaming replay: memoized row compilation + lazy sim feed
# ---------------------------------------------------------------------------

def compile_jobs(rows: Iterable[TraceJob], compiler) -> Iterator[Job]:
    """Compile trace rows into Jobs lazily, memoizing plan compilation
    across rows that differ only in name/steps/estimate.  Synthetic traces
    have a few hundred distinct (chips, tenant, flags) shapes across 50k+
    rows — compiling one template per shape and ``dataclasses.replace``-ing
    the per-row fields cuts install time from ~30s to well under 1s at
    month scale without changing any scheduler-visible field.  Lazy so a
    streamed year-1M replay never holds the compiled job list."""
    templates: Dict[tuple, object] = {}
    for tj in rows:
        key = (tj.chips, tj.min_chips, tj.priority, tj.preemptible,
               tj.work_per_step, tj.comm_frac, tj.tenant, tj.isolation,
               tj.spot)
        tmpl = templates.get(key)
        if tmpl is None:
            tmpl = templates[key] = compiler.compile(tj.to_spec())
        spec = dataclasses.replace(
            tmpl.spec, name=tj.id, total_steps=tj.total_steps,
            estimated_duration_s=tj.estimated_duration_s
            or float(tj.total_steps))
        yield Job(id=tj.id, plan=dataclasses.replace(tmpl, spec=spec),
                  submit_time=tj.submit_time)


def _install_ops(sim, events: Sequence[SimEvent],
                 node_ages: Dict[str, float]) -> None:
    """The non-job half of an install: node ages + injected events."""
    for nid, age in node_ages.items():
        if nid in sim.cluster.nodes:
            sim.cluster.set_node_age(nid, age)
    for ev in events:
        sim.inject(SimEvent(ev.time, ev.kind, ev.node, ev.value, ev.info))


# ---------------------------------------------------------------------------
# Scale presets
# ---------------------------------------------------------------------------
# The paper's operational analysis covers months of multi-tenant campus load;
# these presets scale the synthetic workload from the 60-job smoke default to
# day- and week-shaped traces (diurnal arrival modulation, heavy-tailed
# widths, correlated rack failures) for the simulator scale benchmarks.

SCALE_PRESETS: Dict[str, TraceConfig] = {
    # the original benchmark workload (~0.3 day, homogeneous Poisson)
    "default": TraceConfig(),
    # one day on campus: 600 jobs over ~84000 s with a strong diurnal cycle,
    # a heavy-tailed width mix and a quarter of failures hitting whole racks
    "day-600": TraceConfig(
        n_jobs=600, mean_gap_s=140.0, diurnal_amplitude=0.6,
        width_alpha=1.1, n_failures=24, rack_failure_frac=0.25,
        n_stragglers=24, ops_start=1800.0, ops_window=80000.0),
    # one week: 6000 jobs over ~600000 s, deeper diurnal swing, more (and
    # more correlated) failures — the 100x scale gate for policy studies
    "week-6000": TraceConfig(
        n_jobs=6000, mean_gap_s=100.0, diurnal_amplitude=0.7,
        width_alpha=1.2, n_failures=120, rack_failure_frac=0.3,
        n_stragglers=96, ops_start=3600.0, ops_window=590000.0),
    # one month: 50000 jobs over ~2.6e6 s — the paper's operations-analysis
    # horizon.  The seed-0 synthesis is committed as a gzip artifact
    # (benchmarks/traces/) and replayed byte-identically across PRs, so the
    # month point's metrics are comparable between snapshots even if the
    # synthesizer changes later.
    "month-50k": TraceConfig(
        n_jobs=50000, mean_gap_s=52.0, diurnal_amplitude=0.7,
        width_alpha=1.2, n_failures=480, rack_failure_frac=0.3,
        n_stragglers=400, ops_start=3600.0, ops_window=2550000.0),
    # the month workload under the age-dependent reliability model: no
    # memoryless failures — every outage is an Incident sampled from the
    # per-node Weibull hazard (mixed-age fleet, wear-out shape), with
    # transient restarts vs multi-hour hard repairs.  Benchmarked with
    # reliability-aware policies (failure-aware placement + survival-weighted
    # goodput); the seed-0 synthesis is a committed artifact like month-50k.
    "month-50k-rel": TraceConfig(
        n_jobs=50000, mean_gap_s=52.0, diurnal_amplitude=0.7,
        width_alpha=1.2, n_failures=0, rack_failure_frac=0.0,
        n_stragglers=400, ops_start=3600.0, ops_window=2550000.0,
        reliability=ReliabilityConfig(
            age_days=(30.0, 1460.0), weibull_shape=1.7,
            weibull_scale_days=200.0, transient_frac=0.7,
            repair_transient_s=(600.0, 0.6), repair_hard_s=(10800.0, 0.9))),
    # the month-50k-rel workload replayed under predictive operations: the
    # TraceConfig is an exact clone of month-50k-rel (same seed-0 bytes —
    # the bench reuses the committed rel artifact via an alias), but the
    # bench harness enables predictive draining, the checkpoint cost model
    # and hazard-fed admission control for this point, so the pred-vs-rel
    # metric deltas (repair_hours, restart_work_lost_hours) isolate what
    # acting on the hazard belief buys over reacting to failures.
    "month-50k-pred": TraceConfig(
        n_jobs=50000, mean_gap_s=52.0, diurnal_amplitude=0.7,
        width_alpha=1.2, n_failures=0, rack_failure_frac=0.0,
        n_stragglers=400, ops_start=3600.0, ops_window=2550000.0,
        reliability=ReliabilityConfig(
            age_days=(30.0, 1460.0), weibull_shape=1.7,
            weibull_scale_days=200.0, transient_frac=0.7,
            repair_transient_s=(600.0, 0.6), repair_hard_s=(10800.0, 0.9))),
    # the month workload as a format-3 tier mix: every host carves one chip
    # into MIG slices and one into time-sliced shared slots, ~30% of jobs
    # are small interactive sub-chip sessions (the campus notebook/teaching
    # load) and 10% of the batch jobs run as spot, priced by preemption
    # risk.  Widths cap at 128 so the heavy tail still fits the reduced
    # exclusive pool.  The seed-0 synthesis is a committed artifact like
    # month-50k.
    "month-50k-mixed": TraceConfig(
        n_jobs=50000, mean_gap_s=52.0, diurnal_amplitude=0.7,
        widths=(4, 4, 8, 8, 8, 16, 16, 32, 64, 128),
        width_alpha=1.2, n_failures=480, rack_failure_frac=0.3,
        n_stragglers=400, ops_start=3600.0, ops_window=2550000.0,
        interactive_frac=0.3, interactive_shared_frac=0.5,
        interactive_steps=(200, 2400),
        spot_frac=0.1, mig_chips_per_host=1, shared_chips_per_host=1),
    # one year at a million jobs over ~3.15e7 s — the streaming-scale gate.
    # mean_gap 31.5 s puts steady-state load near 20% of the 512-chip fleet
    # (vs ~12% for month-50k), so queues stay stable over the full horizon.
    # Failures come from the age-dependent reliability model only (the
    # memoryless injector would need ~6k sorted events; the Weibull hazard
    # already yields a realistic year of incidents) and the preset is above
    # STREAM_JOBS_THRESHOLD, so synthesis, the committed seed-0 artifact and
    # replay all go through the streaming path: rows are generated/parsed
    # one at a time, arrivals feed the sim lazily, and completed jobs
    # compact to scalar accumulators — resident memory stays bounded for
    # the whole year.  Compacted metrics sum in completion order, so this
    # point carries its own baseline (see SimConfig.compact_completed).
    "year-1M": TraceConfig(
        n_jobs=1_000_000, mean_gap_s=31.5, diurnal_amplitude=0.7,
        widths=(4, 4, 8, 8, 8, 16, 16, 32, 64, 128),
        width_alpha=1.2, n_failures=0, rack_failure_frac=0.0,
        n_stragglers=2000, ops_start=3600.0, ops_window=31400000.0,
        reliability=ReliabilityConfig(
            age_days=(30.0, 1460.0), weibull_shape=1.7,
            weibull_scale_days=200.0, transient_frac=0.7,
            repair_transient_s=(600.0, 0.6), repair_hard_s=(10800.0, 0.9))),
}


def scale_preset(name: str, *, seed: int = 0) -> TraceConfig:
    """A copy of the named preset with the requested seed."""
    try:
        cfg = SCALE_PRESETS[name]
    except KeyError:
        raise ValueError(f"unknown scale preset {name!r}; "
                         f"choose from {sorted(SCALE_PRESETS)}") from None
    return dataclasses.replace(cfg, seed=seed)


def horizon(trace: Trace, slack: float = 200000.0) -> float:
    """A ``run(until=...)`` bound that comfortably covers the trace: last
    arrival/event plus drain slack (the sim stops early once all jobs end)."""
    t_job = max((j.submit_time for j in trace.jobs), default=0.0)
    t_ev = max((e.time for e in trace.events), default=0.0)
    return max(t_job, t_ev) + slack


# ---------------------------------------------------------------------------
# Synthesis
# ---------------------------------------------------------------------------

def _arrival_times(cfg: TraceConfig, rng: random.Random) -> List[float]:
    """(In)homogeneous Poisson arrivals via thinning."""
    rate = 1.0 / cfg.mean_gap_s
    amp = max(0.0, min(cfg.diurnal_amplitude, 1.0))
    lam_max = rate * (1.0 + amp)
    times, t = [], 0.0
    while len(times) < cfg.n_jobs:
        t += rng.expovariate(lam_max)
        lam_t = rate * (1.0 + amp * math.sin(2.0 * math.pi * t
                                             / cfg.diurnal_period_s))
        if rng.random() * lam_max <= lam_t:
            times.append(t)
    return times


def _sample_width(cfg: TraceConfig, rng: random.Random) -> int:
    if cfg.width_alpha is None:
        return rng.choice(cfg.widths)
    distinct = sorted(set(cfg.widths))
    weights = [w ** -cfg.width_alpha for w in distinct]
    return rng.choices(distinct, weights)[0]


def synthesize(cfg: TraceConfig, nodes: Sequence[str] = ()) -> Trace:
    """Generate a campus-shaped trace. ``nodes`` (cluster node ids, in rack
    order) is required when the config injects failures or stragglers."""
    rng = random.Random(cfg.seed)
    jobs = list(_synth_jobs(cfg, rng))
    events, incidents, node_ages = _synth_ops(cfg, rng, nodes)
    return Trace(jobs=jobs, events=events,
                 meta={"config": dataclasses.asdict(cfg)},
                 incidents=incidents, node_ages=node_ages)


def _synth_jobs(cfg: TraceConfig, rng: random.Random) -> Iterator[TraceJob]:
    """Yield the job rows of a synthesis, consuming the rng stream exactly
    as :func:`synthesize` always has (arrival times first, then per-job
    draws), so a streamed generation is byte-identical to a materialized
    one.  Ops synthesis (:func:`_synth_ops`) continues on the same rng
    *after* this generator is exhausted."""
    tenant_names = [t for t, _ in cfg.tenants]
    tenant_weights = [w for _, w in cfg.tenants]
    for i, t in enumerate(_arrival_times(cfg, rng)):
        # interactive sub-chip arm: short-circuits before drawing, so with
        # interactive_frac == 0 (every format-1/2 config) the rng stream is
        # untouched and legacy artifacts resynthesize byte-identically
        if cfg.interactive_frac > 0 and rng.random() < cfg.interactive_frac:
            tier = "shared" if rng.random() < cfg.interactive_shared_frac \
                else "mig"
            per = TIER_QUANTA[tier]
            frac = Fraction(rng.randint(1, per), per)
            steps = rng.randint(*cfg.interactive_steps)
            yield TraceJob(
                id=f"j{i}", submit_time=t,
                chips=chips_repr(parse_chips(frac)), total_steps=steps,
                tenant=rng.choices(tenant_names, tenant_weights)[0],
                work_per_step=float(frac) * cfg.work_per_chip,
                comm_frac=0.0,
                estimated_duration_s=steps * cfg.work_per_chip
                * rng.uniform(*cfg.est_noise),
                isolation=tier)
            continue
        chips = _sample_width(cfg, rng)
        steps = rng.randint(cfg.steps_min, cfg.steps_max)
        tenant = rng.choices(tenant_names, tenant_weights)[0]
        min_chips = chips // 2 if rng.random() < cfg.elastic_frac else 0
        priority = cfg.high_priority \
            if rng.random() < cfg.priority_frac else 0
        est = steps * cfg.work_per_chip * rng.uniform(*cfg.est_noise)
        spot = cfg.spot_frac > 0 and rng.random() < cfg.spot_frac
        yield TraceJob(
            id=f"j{i}", submit_time=t, chips=chips, total_steps=steps,
            tenant=tenant, min_chips=min_chips, priority=priority,
            work_per_step=chips * cfg.work_per_chip,
            comm_frac=cfg.comm_frac, estimated_duration_s=est, spot=spot)


def _synth_ops(cfg: TraceConfig, rng: random.Random, nodes: Sequence[str]
               ) -> Tuple[List[SimEvent], List[Incident], Dict[str, float]]:
    """The operational half of a synthesis: failures / incidents /
    stragglers / node ages.  Consumes the rng stream immediately after
    :func:`_synth_jobs` exhausted it."""
    events: List[SimEvent] = []
    incidents: List[Incident] = []
    node_ages: Dict[str, float] = {}
    nodes = list(nodes)
    if (cfg.n_failures or cfg.n_stragglers or cfg.reliability) and not nodes:
        raise ValueError("node ids are required to synthesize ops events")
    if cfg.reliability is not None:
        rel = cfg.reliability
        for nid in nodes:
            node_ages[nid] = rng.uniform(*rel.age_days)
        end = cfg.ops_start + cfg.ops_window
        for nid in nodes:
            age0 = node_ages[nid]
            # thinning against the per-second hazard; the bound covers the
            # whole window for wear-out shapes (hazard only grows) and the
            # window start for infant-mortality shapes (hazard only falls)
            lam_max = max(
                hazard_per_day(age0 + cfg.ops_start / 86400.0,
                               rel.weibull_shape, rel.weibull_scale_days),
                hazard_per_day(age0 + end / 86400.0,
                               rel.weibull_shape, rel.weibull_scale_days),
            ) / 86400.0
            if lam_max <= 0:
                continue
            t = cfg.ops_start
            while True:
                t += rng.expovariate(lam_max)
                if t >= end:
                    break
                lam_t = hazard_per_day(age0 + t / 86400.0, rel.weibull_shape,
                                       rel.weibull_scale_days) / 86400.0
                if rng.random() * lam_max > lam_t:
                    continue
                hard = rng.random() >= rel.transient_frac
                med, sigma = rel.repair_hard_s if hard \
                    else rel.repair_transient_s
                repair_s = rng.lognormvariate(math.log(med), sigma)
                kind = "hard" if hard else "transient"
                incidents.append(Incident(nid, t, kind, repair_s,
                                          age0 + t / 86400.0))
                events.append(SimEvent(t, "incident", nid, repair_s, kind))
                t += repair_s          # down while repairing: no re-failure
    for _ in range(cfg.n_failures):
        t = rng.uniform(cfg.ops_start, cfg.ops_start + cfg.ops_window)
        back = t + rng.uniform(*cfg.recover_s)
        if rng.random() < cfg.rack_failure_frac:
            # correlated rack failure: a contiguous host group goes together
            lo = rng.randrange(0, max(1, len(nodes) - cfg.rack_size + 1))
            group = nodes[lo:lo + cfg.rack_size]
        else:
            group = [rng.choice(nodes)]
        for n in group:
            events.append(SimEvent(t, "fail_node", n))
            events.append(SimEvent(back, "recover_node", n))
    for _ in range(cfg.n_stragglers):
        n = rng.choice(nodes)
        t = rng.uniform(cfg.ops_start, cfg.ops_start + cfg.ops_window)
        events.append(SimEvent(t, "set_speed", n, rng.uniform(*cfg.slow_factor)))
        events.append(SimEvent(t + rng.uniform(*cfg.slow_duration_s),
                               "set_speed", n, 1.0))
    events.sort(key=lambda e: e.time)
    incidents.sort(key=lambda i: i.start)
    return events, incidents, node_ages


# ---------------------------------------------------------------------------
# Streaming synthesis / serialization
# ---------------------------------------------------------------------------
# A year-1M trace is ~30x the month artifacts; these paths generate, write,
# read and install it without the flat job list (or the per-row dicts of a
# whole-file json load) ever being resident at once.

def _dumpc(obj) -> str:
    """Compact sorted-key JSON — the exact serialization ``Trace.save``
    uses, applied piecewise so concatenated pieces are byte-identical to a
    whole-dict dump."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def write_trace(path: str, jobs: Iterable[TraceJob], *,
                events: Sequence[SimEvent] = (),
                incidents: Sequence[Incident] = (),
                meta: Optional[Dict] = None,
                node_ages: Optional[Dict[str, float]] = None) -> int:
    """Incrementally write a ``.json.gz`` trace artifact, one job row at a
    time.  Produces byte-for-byte the container ``Trace.save`` writes (gzip
    mtime pinned to 0, empty member filename, compact sorted-key JSON with
    top-level keys in sorted order), so streamed and materialized saves of
    the same trace are indistinguishable on disk.  Returns the row count."""
    if not path.endswith(".gz"):
        raise ValueError("write_trace streams gzip artifacts; "
                         "use Trace.save for plain JSON")
    n = 0
    with open(path, "wb") as f:
        with gzip.GzipFile(fileobj=f, mode="wb", mtime=0, filename="") as gz:
            w = gz.write
            w(b'{"events":')
            w(_dumpc([dataclasses.asdict(e) for e in events]).encode())
            w(b',"format":%d,"incidents":' % TRACE_FORMAT)
            w(_dumpc([dataclasses.asdict(i) for i in incidents]).encode())
            w(b',"jobs":[')
            for tj in jobs:
                if n:
                    w(b",")
                w(_dumpc(dataclasses.asdict(tj)).encode())
                n += 1
            w(b'],"meta":')
            # round-trip meta through JSON like Trace.to_dict (tuples -> lists)
            w(_dumpc(json.loads(json.dumps(meta or {}))).encode())
            w(b',"node_ages":')
            w(_dumpc(dict(node_ages or {})).encode())
            w(b"}")
    return n


@dataclass
class TraceTail:
    """Everything in a trace artifact *except* the job rows, plus the
    aggregates a streamed replay needs up front (``read_tail``)."""
    format: int
    events: List[SimEvent]
    incidents: List[Incident]
    meta: Dict
    node_ages: Dict[str, float]
    n_jobs: int = 0
    t_last_job: float = 0.0

    def horizon(self, slack: float = 200000.0) -> float:
        t_ev = max((e.time for e in self.events), default=0.0)
        return max(self.t_last_job, t_ev) + slack


class TraceReader:
    """Pull-parser for trace artifacts: decodes the job array one row at a
    time off the (gzip) byte stream, so peak memory is one row plus the
    (small) events/incidents/meta/node_ages sections regardless of trace
    size.  Key order inside the artifact is sorted (``events`` .. ``jobs``
    .. ``node_ages``), so sections before ``jobs`` are available right
    after construction; sections after it only once ``iter_jobs`` is
    exhausted (``read_tail`` wraps the skim when only those are needed).

    Accepts any artifact ``Trace.save`` / ``write_trace`` produced (compact
    or indented, .gz or plain)."""

    _CHUNK = 1 << 20

    def __init__(self, path: str):
        self._f: IO[str] = (gzip.open if path.endswith(".gz")
                            else open)(path, "rt")
        self._dec = json.JSONDecoder()
        self._buf = ""
        self._pos = 0
        self._eof = False
        self.header: Dict = {}       # sections seen before "jobs"
        self.tail: Dict = {}         # sections after "jobs" (post-iteration)
        self.n_jobs = 0
        self.t_last_job = 0.0
        self._expect("{")
        self._in_jobs = False
        self._done = False
        self._parse_sections()
        fmt = self.header.get("format")
        if fmt not in _READ_FORMATS:
            raise ValueError(f"unsupported trace format {fmt!r}")

    # -- byte-stream plumbing ----------------------------------------------

    def _fill(self) -> bool:
        if self._eof:
            return False
        if self._pos > self._CHUNK:      # compact consumed prefix
            self._buf = self._buf[self._pos:]
            self._pos = 0
        chunk = self._f.read(self._CHUNK)
        if not chunk:
            self._eof = True
            return False
        self._buf += chunk
        return True

    def _skip_ws(self) -> None:
        while True:
            while self._pos < len(self._buf) \
                    and self._buf[self._pos] in " \t\n\r":
                self._pos += 1
            if self._pos < len(self._buf) or not self._fill():
                return

    def _peek(self) -> str:
        self._skip_ws()
        if self._pos >= len(self._buf):
            raise ValueError("truncated trace artifact")
        return self._buf[self._pos]

    def _expect(self, ch: str) -> None:
        got = self._peek()
        if got != ch:
            raise ValueError(f"malformed trace artifact: "
                             f"expected {ch!r}, got {got!r}")
        self._pos += 1

    def _decode(self):
        """One JSON value off the stream (refilling until it parses)."""
        self._skip_ws()
        while True:
            try:
                val, end = self._dec.raw_decode(self._buf, self._pos)
            except json.JSONDecodeError:
                # may just be truncated mid-value: pull more bytes first
                if self._fill():
                    continue
                raise
            # a value flush against the buffer end may still be a prefix of
            # a longer one (e.g. a number split across chunks): refill once
            # more before trusting it
            if end == len(self._buf) and self._fill():
                continue
            self._pos = end
            return val

    # -- document structure -------------------------------------------------

    def _parse_sections(self) -> None:
        """Parse ``"key": value`` sections into header/tail, stopping at
        the opening of the jobs array (pre-jobs) or the document end."""
        store = self.tail if self._in_jobs else self.header
        while True:
            if self._peek() == "}":
                self._pos += 1
                self._done = True
                return
            key = self._decode()
            self._expect(":")
            if key == "jobs" and not self._in_jobs:
                self._in_jobs = True
                self._expect("[")
                return
            store[key] = self._decode()
            if self._peek() == ",":
                self._pos += 1

    def iter_jobs(self) -> Iterator[TraceJob]:
        """Yield rows; on exhaustion the post-jobs sections land in
        ``tail`` and the underlying file is closed."""
        if not self._in_jobs:
            return
        if self._peek() != "]":
            while True:
                d = self._decode()
                self.n_jobs += 1
                self.t_last_job = d.get("submit_time", 0.0)
                yield TraceJob(**d)
                if self._peek() == ",":
                    self._pos += 1
                else:
                    break
        self._expect("]")
        if self._peek() == ",":
            self._pos += 1
        self._parse_sections()
        self.close()

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "TraceReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_tail(path: str) -> TraceTail:
    """Skim an artifact for everything but the job rows (constant memory:
    rows are decoded and discarded).  A streamed install needs the node
    ages, events and job count before replay starts, and they live *after*
    the job array in the byte stream — this is the first pass of the
    two-pass streamed replay."""
    with TraceReader(path) as r:
        for _ in r.iter_jobs():
            pass
        return TraceTail(
            format=r.header.get("format", 0),
            events=[SimEvent(**e) for e in r.header.get("events", [])],
            incidents=[Incident(**i)
                       for i in r.header.get("incidents", [])],
            meta=r.tail.get("meta", {}),
            node_ages=r.tail.get("node_ages", {}),
            n_jobs=r.n_jobs, t_last_job=r.t_last_job)


def install_stream(path: str, sim, compiler,
                   tail: Optional[TraceTail] = None) -> TraceTail:
    """Streamed replay of an artifact: apply node ages + injected events
    from the (skimmed) tail, then attach the lazily-compiled job rows as
    the sim's arrival source — ``ClusterSim.feed`` pulls them one at a
    time during ``run``, so neither the row list, the compiled Job list
    nor the full arrival heap ever materializes."""
    if tail is None:
        tail = read_tail(path)
    _install_ops(sim, tail.events, tail.node_ages)
    reader = TraceReader(path)
    sim.feed(compile_jobs(reader.iter_jobs(), compiler))
    return tail


class StreamTrace:
    """A synthesized-but-not-materialized trace: regenerates its job rows
    from the config seed on every pass (`synthesize_stream`).  The ops
    sections are recovered by replaying the rng stream once with the rows
    discarded — :func:`_synth_jobs` draws exactly what :func:`synthesize`
    draws, so ``save()`` here and ``synthesize(cfg).save()`` produce the
    same bytes."""

    def __init__(self, cfg: TraceConfig, nodes: Sequence[str] = ()):
        self.cfg = cfg
        self.nodes = list(nodes)
        self.meta = {"config": dataclasses.asdict(cfg)}
        self._ops: Optional[Tuple[List[SimEvent], List[Incident],
                                  Dict[str, float]]] = None
        self._t_last_job = 0.0

    def iter_jobs(self) -> Iterator[TraceJob]:
        return _synth_jobs(self.cfg, random.Random(self.cfg.seed))

    def ops(self) -> Tuple[List[SimEvent], List[Incident], Dict[str, float]]:
        """(events, incidents, node_ages) — computed once by running the
        job draws to exhaustion (discarded) to position the rng stream."""
        if self._ops is None:
            rng = random.Random(self.cfg.seed)
            for tj in _synth_jobs(self.cfg, rng):
                self._t_last_job = tj.submit_time
            self._ops = _synth_ops(self.cfg, rng, self.nodes)
        return self._ops

    def horizon(self, slack: float = 200000.0) -> float:
        events, _, _ = self.ops()
        t_ev = max((e.time for e in events), default=0.0)
        return max(self._t_last_job, t_ev) + slack

    def save(self, path: str) -> int:
        events, incidents, node_ages = self.ops()
        return write_trace(path, self.iter_jobs(), events=events,
                           incidents=incidents, meta=self.meta,
                           node_ages=node_ages)

    def install(self, sim, compiler) -> None:
        """Streamed install: ops applied eagerly, job rows attached as the
        sim's lazy arrival source (see :func:`install_stream`)."""
        events, _, node_ages = self.ops()
        _install_ops(sim, events, node_ages)
        sim.feed(compile_jobs(self.iter_jobs(), compiler))


def synthesize_stream(cfg: TraceConfig,
                      nodes: Sequence[str] = ()) -> StreamTrace:
    """Streaming counterpart of :func:`synthesize`: same rng stream, same
    rows, same artifact bytes — but nothing materialized until pulled."""
    if (cfg.n_failures or cfg.n_stragglers or cfg.reliability) \
            and not list(nodes):
        raise ValueError("node ids are required to synthesize ops events")
    return StreamTrace(cfg, nodes)
