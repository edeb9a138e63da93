"""The port's discrete-event simulator (``repro_torch/core/sim.py``) against
the reference's: each side builds its own cluster, compiler, policy and
trace from the same seeded config and replays it; ``sim.run()``'s metrics,
every job's (id, state, start, end, preemptions, restarts) and the sim's
event log must be EQUAL, since the code and the seeds are the same, and
``Cluster.check_counters`` must hold on both sides. Covered: the five
policies x both engines on ``day-600`` (the tick engine's in
``test_torch_sim_tick.py``) and a small trace, failures and
stragglers, elastic resizes, predictive operations, and the MIG, shared
and spot tiers."""
import dataclasses
import types

import pytest

pytest.importorskip("torch")

import repro.ckpt.cost as ref_cost
import repro.core as ref_core
import repro.core.compiler as ref_compiler
import repro.core.scheduler as ref_scheduler
import repro.data.trace as ref_trace
import repro_torch.ckpt.cost as port_cost
import repro_torch.core as port_core
import repro_torch.core.compiler as port_compiler
import repro_torch.core.scheduler as port_scheduler
import repro_torch.data.trace as port_trace

SIDES = {
    "ref": types.SimpleNamespace(core=ref_core, compiler=ref_compiler,
                                 scheduler=ref_scheduler, trace=ref_trace,
                                 cost=ref_cost),
    "port": types.SimpleNamespace(core=port_core, compiler=port_compiler,
                                  scheduler=port_scheduler, trace=port_trace,
                                  cost=port_cost),
}
POLICIES = ["fifo", "backfill", "fair", "priority", "goodput"]
ENGINES = ["event", "tick"]
# wall-clock fields a metrics dict may carry; everything else is compared
NOT_COMPARED = ("wall_s", "max_rss_mb")


def _small_cfg(seed=0):
    """``tests/test_sim_event.py``'s small trace."""
    return dict(n_jobs=14, seed=seed, mean_gap_s=30.0,
                widths=(4, 4, 8, 8, 16), steps_min=40, steps_max=200,
                elastic_frac=0.0, priority_frac=0.2,
                n_failures=1, n_stragglers=1,
                ops_start=100.0, ops_window=400.0,
                recover_s=(100.0, 200.0),
                slow_duration_s=(100.0, 200.0))


@dataclasses.dataclass
class Scenario:
    """How both sides build one replay: the trace config's fields (or a
    scale preset), the cluster's shape, the policy's and SimConfig's
    keyword arguments; ``predictive``/``ckpt_model`` switch on the
    predictive-operations stack."""
    trace: dict = None
    preset: str = None
    cluster: dict = dataclasses.field(default_factory=lambda: dict(
        n_pods=2, hosts_per_pod=4, chips_per_host=4))
    tiers: dict = None
    policy: dict = dataclasses.field(default_factory=dict)
    sim: dict = dataclasses.field(default_factory=lambda: dict(
        tick=1.0, checkpoint_interval_s=20, checkpoint_cost_s=2,
        restart_cost_s=10))
    predictive: dict = None
    ckpt_model: bool = False
    plans: bool = False
    reliability: dict = None


# the scheduler bench's fleet, policy knobs and SimConfig
BENCH = dict(cluster=dict(n_pods=2, hosts_per_pod=64, chips_per_host=4),
             policy=dict(quotas={"lab-c": 192},
                         tenant_weights={"lab-a": 2, "lab-b": 1, "lab-c": 1},
                         ckpt_interval_s=60),
             sim=dict(tick=2.0, checkpoint_interval_s=60,
                      checkpoint_cost_s=3, restart_cost_s=15))

SCENARIOS = {
    "day-600": Scenario(preset="day-600", **BENCH),
    "small": Scenario(trace=_small_cfg()),
    # failures hitting racks, stragglers, and elastic gangs to resize
    "failures-elastic": Scenario(trace=dict(
        n_jobs=12, seed=11, mean_gap_s=25.0, widths=(4, 8, 8, 16),
        steps_min=40, steps_max=160, elastic_frac=0.6, n_failures=3,
        rack_failure_frac=0.5, rack_size=2, n_stragglers=2, ops_start=50.0,
        ops_window=500.0, recover_s=(80.0, 150.0),
        slow_duration_s=(80.0, 150.0)),
        policy=dict(rebalance_every=20), sim=dict(tick=1.0)),
    # an aged fleet under the Weibull hazard, with predictive draining,
    # the checkpoint cost model and hazard-fed admission control
    "predictive": Scenario(
        trace=dict(n_jobs=24, seed=0, mean_gap_s=25.0, widths=(4, 8, 16),
                   steps_min=40, steps_max=200, elastic_frac=0.3,
                   n_failures=0, n_stragglers=1, ops_start=50.0,
                   ops_window=2500.0),
        reliability=dict(age_days=(1200.0, 2400.0), weibull_shape=1.7,
                         weibull_scale_days=200.0, transient_frac=0.5,
                         repair_transient_s=(120.0, 0.4),
                         repair_hard_s=(4000.0, 0.6),
                         repair_planned_s=(300.0, 0.2)),
        policy=dict(reliability_aware=True, admission_control=True,
                    ckpt_interval_s=30),
        sim=dict(tick=2.0, checkpoint_interval_s=30, checkpoint_cost_s=2,
                 restart_cost_s=10),
        predictive=dict(sweep_interval_s=200.0, min_free_chips=0,
                        repair_planned_s=(300.0, 0.2)),
        ckpt_model=True),
    # exclusive, MIG, shared and spot jobs on a tiered fleet, with the
    # bench's tenant plans
    "tiers": Scenario(
        trace=dict(n_jobs=24, seed=5, mean_gap_s=25.0, widths=(2, 2, 4, 4),
                   steps_min=40, steps_max=160, elastic_frac=0.0,
                   priority_frac=0.2, interactive_frac=0.4,
                   interactive_steps=(20, 80), spot_frac=0.3,
                   mig_chips_per_host=1, shared_chips_per_host=1,
                   n_failures=1, n_stragglers=1, ops_start=100.0,
                   ops_window=400.0, recover_s=(100.0, 200.0),
                   slow_duration_s=(100.0, 200.0)),
        tiers=dict(mig_chips_per_host=1, shared_chips_per_host=1),
        plans=True),
}


def replay(side: str, sc: Scenario, policy: str, engine: str, root):
    """One side's replay: (metrics less the wall-clock fields, per-job
    outcomes, event log, the trace's dict)."""
    s = SIDES[side]
    comp = s.compiler.TaskCompiler(
        s.compiler.ArtifactStore(str(root / side / "cas")),
        str(root / side / "work"))
    tiers = s.core.TierConfig(**sc.tiers) if sc.tiers else None
    cluster = s.core.Cluster(**sc.cluster, tiers=tiers)
    if sc.preset:
        tcfg = s.trace.scale_preset(sc.preset, seed=0)
    else:
        rel = (s.trace.ReliabilityConfig(**sc.reliability)
               if sc.reliability else None)
        tcfg = s.trace.TraceConfig(**sc.trace, reliability=rel)
    ckpt = s.cost.CheckpointCostModel() if sc.ckpt_model else None
    pkw = dict(sc.policy)
    if sc.plans:
        pkw["plans"] = {
            "lab-a": s.scheduler.TenantPlan(priority_boost=1),
            "lab-c": s.scheduler.TenantPlan(
                max_per_tier={"shared": 24, "mig": 24})}
    if ckpt is not None:
        pkw["ckpt_model"] = ckpt
    pol = s.core.make_policy(policy, **pkw)
    pred = (s.core.PredictiveOpsConfig(**sc.predictive)
            if sc.predictive else None)
    sim = s.core.ClusterSim(cluster, pol, s.core.SimConfig(
        **sc.sim, engine=engine, predictive=pred, ckpt_model=ckpt))
    tr = s.trace.synthesize(tcfg, list(cluster.nodes))
    tr.install(sim, comp)
    m = sim.run(until=s.trace.horizon(tr))
    cluster.check_counters()
    for k in NOT_COMPARED:
        m.pop(k, None)
    jobs = sorted((j.id, j.state.value, j.start_time, j.end_time,
                   j.preemptions, j.restarts) for j in sim.jobs.values())
    return m, jobs, list(sim.trace), tr.to_dict()


def _assert_equal_replays(name, policy, engine, tmp_path):
    sc = SCENARIOS[name]
    ref = replay("ref", sc, policy, engine, tmp_path)
    port = replay("port", sc, policy, engine, tmp_path)
    assert port[3] == ref[3]                  # the same trace
    assert port[0] == ref[0]                  # every metric, exactly
    assert port[1] == ref[1]                  # every job's outcome
    assert port[2] == ref[2]                  # the event log
    assert ref[0]["jobs"] > 0 and ref[1]
    return ref


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("policy", POLICIES)
def test_small_trace_equals_reference(policy, engine, tmp_path):
    m, _, _, _ = _assert_equal_replays("small", policy, engine, tmp_path)
    assert m["completed"] > 0


@pytest.mark.parametrize("policy", POLICIES)
def test_day600_event_engine_equals_reference(policy, tmp_path):
    """The event engine on ``day-600``; the tick engine's replays, some
    seconds each, are in ``test_torch_sim_tick.py``."""
    check_day600(policy, "event", tmp_path)


def check_day600(policy, engine, tmp_path):
    m, _, _, _ = _assert_equal_replays("day-600", policy, engine, tmp_path)
    assert m["jobs"] == 600 and m["completed"] > 0 and m["failures"] > 0


@pytest.mark.parametrize("engine", ENGINES)
def test_sim_failures_and_elastic_resizes_equal_reference(engine, tmp_path):
    m, _, log, _ = _assert_equal_replays("failures-elastic", "goodput",
                                         engine, tmp_path)
    assert m["failures"] > 0 and m["restarts"] > 0
    assert any(msg.startswith("resize") for _, _, msg in log)


@pytest.mark.parametrize("engine", ENGINES)
def test_sim_predictive_ops_equal_reference(engine, tmp_path):
    m, _, _, _ = _assert_equal_replays("predictive", "fifo", engine,
                                       tmp_path)
    assert m["drains_proactive"] > 0


@pytest.mark.parametrize("policy", ["backfill", "priority"])
@pytest.mark.parametrize("engine", ENGINES)
def test_sim_tiers_equal_reference(engine, policy, tmp_path):
    m, _, _, tr = _assert_equal_replays("tiers", policy, engine, tmp_path)
    assert {j["isolation"] for j in tr["jobs"]} == {"exclusive", "mig",
                                                    "shared"}
    assert any(j["spot"] for j in tr["jobs"])
    assert m["shared_occupancy"] > 0


def test_sim_exports_match_reference():
    for name in ("ClusterSim", "PredictiveOpsConfig", "SimConfig",
                 "SimEvent"):
        assert getattr(port_core, name).__module__ == "repro_torch.core.sim"
    assert [f.name for f in dataclasses.fields(port_core.SimConfig)] == \
        [f.name for f in dataclasses.fields(ref_core.SimConfig)]
    assert dataclasses.asdict(port_core.PredictiveOpsConfig()) == \
        dataclasses.asdict(ref_core.PredictiveOpsConfig())
