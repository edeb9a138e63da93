"""JAX's loss curve for the port's cluster training job
(``tools/jax_loss_curve.py`` and the ``tools/jax_loss_curve.json`` it
wrote), which phase 10 of chip_smoke.py holds the card's run to: the
file is for the example's job as its runtime reads it, a fresh CPU draw
has the file's leaf sums, the file's bar is the rule's, the tool's two
curves agree at smoke size within tests/test_torch_train.py's bars, and
the training runtime draws its initial state on the CPU whatever its
device."""
import dataclasses
import importlib.util
import json
import math
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch.core.compiler import ExecutionPlan  # noqa: E402
from repro_torch.core.executor import TorchTrainRuntime  # noqa: E402
import repro_torch.core.executor as executor  # noqa: E402


def _tool():
    spec = importlib.util.spec_from_file_location(
        "jax_loss_curve", ROOT / "tools" / "jax_loss_curve.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def curve():
    with open(chip_smoke.JAX_CURVE) as f:
        return json.load(f)


def test_json_is_for_the_example_job(curve):
    """The file's spec fields are those ``TorchTrainRuntime`` reads from
    the example's full-size job over phase 10's 60 steps."""
    spec = _tool().job_spec(chip_smoke.CLUSTER_STEPS)
    assert curve["spec"] == chip_smoke.curve_spec(spec)
    assert curve["spec"]["arch"] == "tacc-100m"
    assert curve["spec"]["total_steps"] == chip_smoke.CLUSTER_STEPS == 60


def test_a_fresh_cpu_draw_has_the_json_leaf_sums(curve):
    """The job's initial state drawn now on this CPU: every leaf's float64
    sum and sum of squares equal the file's (rel 1e-9), as phase 10 checks
    on the card's host; a torch whose CPU generator drifted fails here."""
    tool = _tool()
    sums = chip_smoke.leaf_sums(tool.initial_state(tool.job_spec(60)))
    assert set(sums) == set(curve["leaf_sums"])
    for name, want in curve["leaf_sums"].items():
        for a, b in zip(sums[name], want):
            assert math.isclose(a, b, rel_tol=1e-9, abs_tol=1e-9), name


def test_json_bar_is_the_rule_over_its_losses(curve):
    """60 finite JAX losses that fall, the port's CPU losses beside them,
    and the bar ``chip_smoke.jax_curve_bars`` gives for them: 1e-3 at
    step 0, never below it, never falling."""
    jl, pl, bar = curve["jax"]["loss"], curve["port_cpu"]["loss"], \
        curve["bar"]
    assert len(jl) == len(pl) == len(bar) == 60
    assert all(math.isfinite(x) for x in jl + pl)
    assert jl[-1] < jl[0]
    assert bar == chip_smoke.jax_curve_bars(jl, pl)
    assert bar[0] == 1e-3 and min(bar) == 1e-3
    assert all(a <= b for a, b in zip(bar, bar[1:]))
    assert all(abs(p - j) / abs(j) <= b for j, p, b in zip(jl, pl, bar))


def test_tool_curves_agree_at_smoke_size():
    """The tool's JAX and port curves from one initial state over 3 steps
    on the f32 smoke job: loss within rel 1e-4 and grad norm within rel
    2e-3 at every step (tests/test_torch_train.py's bars)."""
    tool = _tool()
    spec = tool.job_spec(3, smoke=True)
    cfg = dataclasses.replace(TorchTrainRuntime.configs(spec)[0],
                              dtype="float32")
    state = tool.initial_state(spec)
    keep = {k: v.clone() for k, v in state["params"].items()}
    jl, jn = tool.jax_curve(spec, state, 3, cfg=cfg)
    pl, pn = tool.port_curve(spec, state, 3, cfg=cfg)
    assert all(torch.equal(keep[k], v) for k, v in state["params"].items())
    for i in range(3):
        assert abs(pl[i] - jl[i]) <= 1e-4 * abs(jl[i]), (i, pl[i], jl[i])
        assert abs(pn[i] - jn[i]) <= 2e-3 * abs(jn[i]), (i, pn[i], jn[i])
    assert jl[2] < jl[0]


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_train_runtime_draws_its_initial_state_on_the_cpu(tmp_path,
                                                          monkeypatch,
                                                          device):
    """Whatever the runtime's device, its initial state comes from a CPU
    generator seeded by the entry's seed (as one ``jax.random`` key gives
    one state on every backend), then moves to the device; on the CPU it
    equals the tool's draw bit for bit."""
    tool = _tool()
    spec = tool.job_spec(4, smoke=True)
    seen = []
    real = executor.init_train_state

    def spy(cfg, ocfg, generator, dev):
        seen.append((generator.device.type, generator.initial_seed(),
                     str(dev)))
        return real(cfg, ocfg, generator, dev)

    monkeypatch.setattr(executor, "init_train_state", spy)
    plan = ExecutionPlan(plan_id="p", spec=spec, backend="torch_train",
                         staged={}, model=None, mesh_request={},
                         workdir=str(tmp_path))
    rt = TorchTrainRuntime(plan, device=device)
    try:
        assert seen == [("cpu", TorchTrainRuntime.stream(spec)[2], device)]
        params = rt.state["params"]
        assert all(t.device.type == device for t in params.values())
        if device == "cpu":
            ref = tool.initial_state(spec)["params"]
            assert all(torch.equal(params[k], ref[k]) for k in ref)
    finally:
        rt.close()
