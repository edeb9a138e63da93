"""The port's copy of the TACC control plane against the reference: the
same scheduling decisions under every policy, the schema's backends, and
every case of ``tests/test_service_e2e.py`` run on the port's torch
runtimes on the CPU."""
import time
import types

import pytest

torch = pytest.importorskip("torch")

from repro.core import Cluster as RefCluster
from repro.core import ResourceSpec as RefResourceSpec
from repro.core import RuntimeEnv as RefRuntimeEnv
from repro.core import TACC as RefTACC
from repro.core import TaskSpec as RefTaskSpec
from repro.core import TierConfig as RefTierConfig
from repro.core import executor as ref_executor
from repro.core import service as ref_service
from repro.core.scheduler import POLICIES as REF_POLICIES
from repro_torch.core import (POLICIES, TACC, Cluster, JobState, ResourceSpec,
                              RuntimeEnv, SpecError, TaskSpec, TierConfig)
from repro_torch.core import executor as port_executor
from repro_torch.core import service as port_service


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Smoke-size ops run as fast on one thread, and the suite's workers
    share the machine's cores: more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the scheduler copy makes the reference's decisions ----------------------

# (tick it arrives at, spec fields): exclusive gangs of 1-8 chips, every QoS
# class, priorities, an elastic job (min_chips), a spot job, and sub-chip
# mig and shared jobs
ARRIVALS = [
    (0, dict(name="big", tenant="a", chips=8, priority=0, qos="batch",
             steps=30, est=900)),
    (0, dict(name="small", tenant="b", chips=1, priority=2, qos="besteffort",
             steps=10, est=120)),
    (1, dict(name="elastic", tenant="c", chips=6, min_chips=2, priority=1,
             qos="batch", steps=25, est=600)),
    (1, dict(name="notebook", tenant="b", chips="1/7", isolation="mig",
             qos="realtime", steps=10, est=60)),
    (2, dict(name="urgent", tenant="a", chips=4, priority=9, qos="realtime",
             steps=10, est=60)),
    (2, dict(name="shared", tenant="c", chips="1/4", isolation="shared",
             qos="besteffort", steps=15, est=90)),
    (3, dict(name="spot", tenant="b", chips=2, spot=True, qos="besteffort",
             steps=20, est=300)),
    (4, dict(name="mid", tenant="c", chips=3, priority=3, qos="batch",
             steps=15, est=200)),
    (6, dict(name="late", tenant="a", chips=5, priority=5, qos="realtime",
             steps=10, est=100)),
    (6, dict(name="tiny", tenant="c", chips=2, priority=0, qos="besteffort",
             steps=5, est=30)),
]


def _shell_spec(mod, fields) -> object:
    f = dict(fields)
    res = {k: f.pop(k) for k in ("chips", "priority", "qos", "min_chips",
                                 "isolation", "spot") if k in f}
    steps, est = f.pop("steps"), f.pop("est")
    return mod["TaskSpec"](
        name=f["name"], tenant=f["tenant"],
        resources=mod["ResourceSpec"](**res),
        runtime=mod["RuntimeEnv"](backend="shell"),
        artifacts={"main": f"print('{f['name']}')"},
        total_steps=steps, estimated_duration_s=est)


def _stepping(base):
    """The shell runtime, advancing by the quantum instead of finishing at
    once, so that jobs hold their chips over several ticks (the same stub
    in both executors)."""
    class Stepping(base):
        def run_quantum(self, steps):
            self._done = min(self._done + steps, self.plan.spec.total_steps)
            self.log(f"step {self._done}")
            return {"done": float(self._done)}
    return Stepping


@pytest.mark.parametrize("policy", sorted(REF_POLICIES))
def test_port_tacc_makes_the_reference_decisions(tmp_path, monkeypatch,
                                                 policy):
    """The reference's TACC and the port's, each with its own cluster of 4
    hosts (2 exclusive, 1 mig and 1 shared chip each), take the same shell
    specs at the same ticks on one fake clock (60 s a tick, ``time`` patched
    in both service and executor modules), and one injected failure of the
    same job: ``status()`` is identical after every tick, and every spec
    hashes alike."""
    assert sorted(POLICIES) == sorted(REF_POLICIES)
    clock = {"t": 1.0e6}
    fake = types.SimpleNamespace(time=lambda: clock["t"],
                                 strftime=time.strftime,
                                 sleep=lambda s: None)
    for mod in (ref_service, ref_executor, port_service, port_executor):
        monkeypatch.setattr(mod, "time", fake)
    for mod in (ref_executor, port_executor):
        monkeypatch.setattr(mod, "ShellRuntime", _stepping(mod.ShellRuntime))

    def fail_once():
        armed = {"on": True}

        def inject(job, step):
            if armed["on"] and job.spec.name == "mid" and step >= 5:
                armed["on"] = False
                return True
            return False
        return inject

    tiers = dict(mig_chips_per_host=1, shared_chips_per_host=1)
    ref = RefTACC(str(tmp_path / "ref"), policy=policy, quantum_steps=5,
                  fail_injector=fail_once(),
                  cluster=RefCluster(n_pods=1, hosts_per_pod=4,
                                     chips_per_host=4,
                                     tiers=RefTierConfig(**tiers)))
    port = TACC(str(tmp_path / "port"), policy=policy, quantum_steps=5,
                fail_injector=fail_once(), device="cpu",
                cluster=Cluster(n_pods=1, hosts_per_pod=4, chips_per_host=4,
                                tiers=TierConfig(**tiers)))
    ref_mod = {"TaskSpec": RefTaskSpec, "ResourceSpec": RefResourceSpec,
               "RuntimeEnv": RefRuntimeEnv}
    port_mod = {"TaskSpec": TaskSpec, "ResourceSpec": ResourceSpec,
                "RuntimeEnv": RuntimeEnv}
    for tick in range(200):
        for at, fields in ARRIVALS:
            if at == tick:
                rs, ps = _shell_spec(ref_mod, fields), _shell_spec(port_mod,
                                                                   fields)
                assert rs.spec_hash() == ps.spec_hash()
                assert rs.canonical_json() == ps.canonical_json()
                assert ref.submit(rs) == port.submit(ps)
        ref.tick()
        port.tick()
        assert port.status() == ref.status(), (policy, tick)
        clock["t"] += 60.0
        if tick > ARRIVALS[-1][0] and all(
                j["state"] in ("COMPLETED", "FAILED", "KILLED")
                for j in ref.status()):
            break
    states = {j["name"]: j["state"] for j in port.status()}
    assert set(states.values()) == {"COMPLETED"}, states
    assert any(j["restarts"] for j in port.status())


# -- the schema --------------------------------------------------------------

def test_schema_refuses_the_reference_backends():
    """``validate`` refuses ``jax_train`` and ``jax_serve`` and accepts
    ``torch_train`` (which needs entry.arch) and ``torch_serve``; a torch
    spec is the default and hashes apart from the JAX spec of the same
    fields; a ``shell`` spec serializes and hashes as the reference's."""
    for backend in ("jax_train", "jax_serve"):
        with pytest.raises(SpecError, match="backend"):
            TaskSpec(name="t", runtime=RuntimeEnv(backend=backend),
                     entry={"arch": "tacc-100m"}).validate()
    TaskSpec(name="t", runtime=RuntimeEnv(backend="torch_train"),
             entry={"arch": "tacc-100m"}).validate()
    TaskSpec(name="t", runtime=RuntimeEnv(backend="torch_serve")).validate()
    with pytest.raises(SpecError, match="torch_train tasks need entry.arch"):
        TaskSpec(name="t").validate()
    entry = {"arch": "tacc-100m", "smoke": True}
    assert TaskSpec(name="t", entry=entry).runtime.backend == "torch_train"
    assert TaskSpec(name="t", entry=entry).spec_hash() != \
        RefTaskSpec(name="t", entry=entry).spec_hash()
    shell = dict(name="s", tenant="x", artifacts={"main": "print(1)"},
                 total_steps=3)
    ours = TaskSpec(resources=ResourceSpec(chips="2/7", isolation="mig"),
                    runtime=RuntimeEnv(backend="shell"), **shell)
    theirs = RefTaskSpec(
        resources=RefResourceSpec(chips="2/7", isolation="mig"),
        runtime=RefRuntimeEnv(backend="shell"), **shell)
    assert ours.canonical_json() == theirs.canonical_json()
    assert ours.spec_hash() == theirs.spec_hash()


# -- tests/test_service_e2e.py, on the port ----------------------------------

def train_spec(name="train", steps=30, *, tenant="a", priority=0, chips=4,
               ckpt_every=10, seed=0):
    return TaskSpec(
        name=name, tenant=tenant,
        resources=ResourceSpec(chips=chips, priority=priority),
        runtime=RuntimeEnv(backend="torch_train",
                           checkpoint_interval_steps=ckpt_every),
        entry={"arch": "tacc-100m", "smoke": True, "global_batch": 4,
               "seq_len": 32, "lr": 1e-3, "seed": seed},
        total_steps=steps, estimated_duration_s=60)


def test_train_to_completion_and_logs(tmp_path):
    svc = TACC(str(tmp_path), policy="backfill", quantum_steps=10,
               device="cpu")
    jid = svc.submit(train_spec(steps=20))
    svc.run_until_done(max_ticks=50)
    job = svc.jobs[jid]
    assert job.state == JobState.COMPLETED
    logs = "".join(svc.logs(jid))
    assert "loss=" in logs and "checkpoint" in logs


def test_failure_injection_restarts_from_checkpoint(tmp_path):
    """The job fails at step 12, resumes from its step-10 checkpoint (the
    log says so, and its progress restarts at 10, not 0) and completes."""
    fail_at = {"armed": True}

    def injector(job, step):
        if fail_at["armed"] and step >= 12:
            fail_at["armed"] = False
            return True
        return False

    svc = TACC(str(tmp_path), policy="fifo", quantum_steps=4,
               fail_injector=injector, device="cpu")
    jid = svc.submit(train_spec(steps=30, ckpt_every=10))
    progress = []
    while svc.jobs[jid].state != JobState.COMPLETED and len(progress) < 100:
        svc.tick()
        progress.append(int(svc.jobs[jid].progress))
    job = svc.jobs[jid]
    assert job.state == JobState.COMPLETED
    assert job.restarts == 1
    logs = "".join(svc.logs(jid, tail=100))
    assert "restored checkpoint @ step 10" in logs    # resumed, not re-ran
    assert progress[:5] == [4, 8, 12, 12, 14]
    assert svc.executor.stats[jid]["restores"][0]["step"] == 10


def test_retries_exhausted_fails(tmp_path):
    svc = TACC(str(tmp_path), policy="fifo", quantum_steps=5,
               fail_injector=lambda job, step: True, device="cpu")
    spec = train_spec(steps=20)
    jid = svc.submit(spec)
    svc.run_until_done(max_ticks=60)
    assert svc.jobs[jid].state == JobState.FAILED
    assert svc.jobs[jid].restarts > spec.max_retries


def test_priority_preemption_real_service(tmp_path):
    svc = TACC(str(tmp_path), policy="priority", quantum_steps=5,
               device="cpu")
    low = svc.submit(train_spec("low", steps=40, priority=0, chips=8))
    svc.tick()
    assert svc.jobs[low].state == JobState.RUNNING
    hi = svc.submit(train_spec("hi", steps=10, priority=9, chips=8, seed=1))
    svc.run_until_done(max_ticks=120)
    assert svc.jobs[hi].state == JobState.COMPLETED
    assert svc.jobs[low].state == JobState.COMPLETED
    assert svc.jobs[low].preemptions >= 1
    # checkpoint-then-preempt: the low job resumed where it was preempted
    assert "restored checkpoint @ step 5" in "".join(svc.logs(low, tail=100))


def test_cas_delta_caching_across_submissions(tmp_path):
    svc = TACC(str(tmp_path), device="cpu")
    code = "print('x')" * 200
    s1 = TaskSpec(name="s1", runtime=RuntimeEnv(backend="shell"),
                  artifacts={"main": "print('hello')", "lib": code},
                  total_steps=1)
    s2 = TaskSpec(name="s2", runtime=RuntimeEnv(backend="shell"),
                  artifacts={"main": "print('world')", "lib": code},
                  total_steps=1)
    j1 = svc.submit(s1)
    r1 = svc.jobs[j1].plan.cache_report
    j2 = svc.submit(s2)
    r2 = svc.jobs[j2].plan.cache_report
    assert r1["cached_bytes"] == 0
    assert r2["cached_bytes"] == len(code)         # only the delta shipped
    assert r2["new_bytes"] == len("print('world')")
    svc.run_until_done(max_ticks=10)
    assert "hello" in "".join(svc.logs(j1))


def test_serve_backend_through_scheduler(tmp_path):
    svc = TACC(str(tmp_path), quantum_steps=2, device="cpu")
    spec = TaskSpec(
        name="serve", resources=ResourceSpec(chips=2),
        runtime=RuntimeEnv(backend="torch_serve"),
        entry={"arch": "tacc-100m", "smoke": True, "max_batch": 2,
               "max_new": 4, "max_seq": 48},
        total_steps=3, estimated_duration_s=30)
    jid = svc.submit(spec)
    svc.run_until_done(max_ticks=40)
    assert svc.jobs[jid].state == JobState.COMPLETED
    assert "served" in "".join(svc.logs(jid))


def test_reproducible_execution_same_spec_hash(tmp_path):
    """Two runs of the same spec produce identical training trajectories
    (the schema layer's reproducibility guarantee)."""
    losses = []
    for run in range(2):
        svc = TACC(str(tmp_path / f"run{run}"), quantum_steps=5,
                   device="cpu")
        jid = svc.submit(train_spec(steps=10))
        svc.run_until_done(max_ticks=30)
        logs = "".join(svc.logs(jid))
        losses.append([l.split("loss=")[1][:8] for l in logs.splitlines()
                       if "loss=" in l])
    assert len(losses[0]) == 2 and losses[0] == losses[1]


def test_runtimes_run_on_the_service_device_and_free_their_state(tmp_path):
    """``TACC(device=)`` reaches the runtime: its train state lives on that
    device; once the job completes the runtime is deprovisioned and keeps
    no state, and its measurements stay with the executor."""
    svc = TACC(str(tmp_path), quantum_steps=2, device="cpu")
    jid = svc.submit(train_spec(steps=4, ckpt_every=2))
    svc.tick()
    rt = svc.executor.runtimes[jid]
    assert {t.device.type for t in rt.state["params"].values()} == {"cpu"}
    svc.tick()
    assert svc.jobs[jid].state == JobState.COMPLETED
    assert jid not in svc.executor.runtimes and rt.state is None
    stats = svc.executor.stats[jid]
    assert [s["step"] for s in stats["saves"]] == [2, 4, 4]
    assert [q["step"] for q in stats["quanta"]] == [2, 4]
    assert "restores" not in stats
