"""The port's cluster traces (``repro_torch/data/trace.py``) against the
reference's: synthesis (materialized and streamed) gives equal rows, saved
artifacts are byte-equal, the committed month artifacts read identically
row by row and in their tails, rows compile to the same spec hashes and
plan ids, and installing a trace into each side's simulator gives the
same metrics."""
import dataclasses
import gzip
import itertools
import os

import pytest

pytest.importorskip("torch")

import repro.core as ref_core
import repro.core.compiler as ref_compiler
import repro.data.trace as ref_trace
import repro_torch.core as port_core
import repro_torch.core.compiler as port_compiler
import repro_torch.data.trace as port_trace
from repro_torch import data as port_data

TRACE_DIR = os.path.join(os.path.dirname(__file__), os.pardir, "benchmarks",
                         "traces")
MONTHS = ["month-50k", "month-50k-rel", "month-50k-mixed"]
SIDES = {"ref": (ref_core, ref_compiler, ref_trace),
         "port": (port_core, port_compiler, port_trace)}
NODES = [f"pod{p}/host{h:03d}" for p in range(2) for h in range(4)]

CONFIGS = {
    "default": dict(),
    "ops": dict(n_jobs=30, seed=3, n_failures=3, rack_failure_frac=0.5,
                rack_size=2, n_stragglers=2),
    "reliability": dict(n_jobs=30, seed=1, n_failures=0,
                        reliability=dict(age_days=(30.0, 1460.0),
                                         weibull_shape=1.7,
                                         weibull_scale_days=200.0)),
    "mixed": dict(n_jobs=40, seed=5, widths=(2, 2, 4, 4),
                  interactive_frac=0.4, spot_frac=0.3, mig_chips_per_host=1,
                  shared_chips_per_host=1, diurnal_amplitude=0.6),
}


def _cfg(side, name):
    kw = dict(CONFIGS[name])
    rel = kw.pop("reliability", None)
    tr = SIDES[side][2]
    return tr.TraceConfig(
        **kw, reliability=tr.ReliabilityConfig(**rel) if rel else None)


def _row(tj):
    return dataclasses.asdict(tj)


def _tail(t):
    return dataclasses.asdict(t)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_synthesize_equals_reference(name):
    ref = ref_trace.synthesize(_cfg("ref", name), NODES)
    port = port_trace.synthesize(_cfg("port", name), NODES)
    assert port.to_dict() == ref.to_dict()
    assert port_trace.horizon(port) == ref_trace.horizon(ref)
    st = port_trace.synthesize_stream(_cfg("port", name), NODES)
    rst = ref_trace.synthesize_stream(_cfg("ref", name), NODES)
    assert [_row(j) for j in st.iter_jobs()] == \
        [_row(j) for j in rst.iter_jobs()] == ref.to_dict()["jobs"]
    assert [[dataclasses.asdict(x) for x in part] if isinstance(part, list)
            else part for part in st.ops()] == \
        [[dataclasses.asdict(x) for x in part] if isinstance(part, list)
         else part for part in rst.ops()]
    assert st.horizon() == rst.horizon()


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_saved_artifacts_are_byte_equal(name, tmp_path):
    paths = {}
    for side in SIDES:
        tr = SIDES[side][2]
        t = tr.synthesize(_cfg(side, name), NODES)
        paths[side] = [tmp_path / f"{side}.json.gz", tmp_path / f"{side}.json",
                       tmp_path / f"{side}-stream.json.gz",
                       tmp_path / f"{side}-write.json.gz"]
        t.save(str(paths[side][0]))
        t.save(str(paths[side][1]))
        tr.synthesize_stream(_cfg(side, name), NODES).save(
            str(paths[side][2]))
        tr.write_trace(str(paths[side][3]), t.jobs, events=t.events,
                       incidents=t.incidents, meta=t.meta,
                       node_ages=t.node_ages)
    for p, r in zip(paths["port"], paths["ref"]):
        assert p.read_bytes() == r.read_bytes(), p.name
    # the gzip container itself: mtime 0, empty member name
    raw = paths["port"][0].read_bytes()
    assert raw[4:8] == b"\0\0\0\0"
    assert paths["port"][2].read_bytes() == raw
    with gzip.open(paths["port"][0]) as f:
        assert f.read(10) == b'{"events":'
    back = port_trace.Trace.load(str(paths["port"][0]))
    assert back.to_dict() == ref_trace.Trace.load(
        str(paths["ref"][0])).to_dict()


@pytest.mark.parametrize("name", MONTHS)
def test_committed_month_artifact_reads_identically(name):
    """All 50,000 rows, row by row, and the tail after them."""
    path = os.path.join(TRACE_DIR, f"{name}-seed0.json.gz")
    with port_trace.TraceReader(path) as p, ref_trace.TraceReader(path) as r:
        assert p.header == r.header
        n = 0
        for a, b in itertools.zip_longest(p.iter_jobs(), r.iter_jobs()):
            assert a is not None and b is not None
            assert _row(a) == _row(b)
            n += 1
        assert n == p.n_jobs == r.n_jobs == 50000
        assert p.tail == r.tail and p.t_last_job == r.t_last_job
    tail, ref_tail = port_trace.read_tail(path), ref_trace.read_tail(path)
    assert _tail(tail) == _tail(ref_tail)
    assert tail.horizon() == ref_tail.horizon()


def test_rows_compile_to_the_reference_plans(tmp_path):
    """``TraceJob.to_spec`` builds shell specs, which hash the same in both
    packages: spec hashes and plan ids of every row are equal."""
    ref = ref_trace.synthesize(_cfg("ref", "mixed"), NODES)
    port = port_trace.synthesize(_cfg("port", "mixed"), NODES)
    got = {}
    for side, t in (("ref", ref), ("port", port)):
        comp_mod = SIDES[side][1]
        comp = comp_mod.TaskCompiler(
            comp_mod.ArtifactStore(str(tmp_path / side / "cas")),
            str(tmp_path / side / "work"))
        jobs = t.materialize(comp)
        got[side] = [(j.id, j.spec.spec_hash(), j.plan.plan_id, j.chips,
                      j.total_steps) for j in jobs]
        got[side + "-specs"] = [tj.to_spec().spec_hash() for tj in t.jobs]
    assert got["port"] == got["ref"]
    assert got["port-specs"] == got["ref-specs"]


def _sim(side, root, tiers=False):
    core, comp_mod, _ = SIDES[side]
    comp = comp_mod.TaskCompiler(comp_mod.ArtifactStore(str(root / "cas")),
                                 str(root / "work"))
    tc = (core.TierConfig(mig_chips_per_host=1, shared_chips_per_host=1)
          if tiers else None)
    cluster = core.Cluster(n_pods=2, hosts_per_pod=4, chips_per_host=4,
                           tiers=tc)
    sim = core.ClusterSim(cluster, core.make_policy("backfill"),
                          core.SimConfig(tick=1.0, checkpoint_interval_s=20,
                                         checkpoint_cost_s=2,
                                         restart_cost_s=10))
    return sim, comp


@pytest.mark.parametrize("how", ["install", "stream", "install_stream"])
@pytest.mark.parametrize("name", ["ops", "mixed"])
def test_install_into_the_sim_equals_reference(name, how, tmp_path):
    """``Trace.install``, ``StreamTrace.install`` and ``install_stream`` of
    the reference's saved artifact give each side the same metrics."""
    art = tmp_path / "trace.json.gz"
    ref_trace.synthesize(_cfg("ref", name), NODES).save(str(art))
    metrics = {}
    for side in SIDES:
        tr = SIDES[side][2]
        sim, comp = _sim(side, tmp_path / side, tiers=name == "mixed")
        if how == "install":
            t = tr.Trace.load(str(art))
            t.install(sim, comp)
            until = tr.horizon(t)
        elif how == "stream":
            st = tr.synthesize_stream(_cfg(side, name), NODES)
            st.install(sim, comp)
            until = st.horizon()
        else:
            until = tr.install_stream(str(art), sim, comp).horizon()
        metrics[side] = sim.run(until=until)
        sim.cluster.check_counters()
    assert metrics["port"] == metrics["ref"]
    assert metrics["ref"]["completed"] > 0


def test_data_package_exports_match_reference():
    import repro.data as ref_data
    names = sorted(n for n in dir(ref_data) if not n.startswith("_")
                   and getattr(getattr(ref_data, n), "__module__", "")
                   == "repro.data.trace")
    assert names and all(hasattr(port_data, n) for n in names)
    assert port_data.SCALE_PRESETS.keys() == ref_trace.SCALE_PRESETS.keys()
    for k in ref_trace.SCALE_PRESETS:
        assert dataclasses.asdict(port_data.SCALE_PRESETS[k]) == \
            dataclasses.asdict(ref_trace.SCALE_PRESETS[k])


@pytest.mark.slow
def test_year_artifact_reads_identically():
    path = os.path.join(TRACE_DIR, "year-1M-seed0.json.gz")
    with port_trace.TraceReader(path) as p, ref_trace.TraceReader(path) as r:
        assert p.header == r.header
        for a, b in itertools.zip_longest(p.iter_jobs(), r.iter_jobs()):
            assert _row(a) == _row(b)
        assert p.n_jobs == r.n_jobs == 1_000_000
        assert p.tail == r.tail


@pytest.mark.slow
def test_month_replay_equals_reference(tmp_path):
    """The committed month-50k artifact replayed through ``install_stream``
    under one policy, each side on the scheduler bench's fleet."""
    path = os.path.join(TRACE_DIR, "month-50k-seed0.json.gz")
    metrics = {}
    for side in SIDES:
        core, comp_mod, tr = SIDES[side]
        comp = comp_mod.TaskCompiler(
            comp_mod.ArtifactStore(str(tmp_path / side / "cas")),
            str(tmp_path / side / "work"))
        cluster = core.Cluster(n_pods=2, hosts_per_pod=64, chips_per_host=4)
        sim = core.ClusterSim(cluster, core.make_policy(
            "backfill", quotas={"lab-c": 192},
            tenant_weights={"lab-a": 2, "lab-b": 1, "lab-c": 1},
            ckpt_interval_s=60), core.SimConfig(
                tick=2.0, checkpoint_interval_s=60, checkpoint_cost_s=3,
                restart_cost_s=15))
        until = tr.install_stream(path, sim, comp).horizon()
        metrics[side] = sim.run(until=until)
        cluster.check_counters()
    assert metrics["port"] == metrics["ref"]
    assert metrics["ref"]["jobs"] == 50000
