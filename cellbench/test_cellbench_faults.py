"""A run driven on the CPU past the harness's look for a card, on the test
cells: sound, it comes out correct; with the timed path broken underneath
(a state left unchanged, half of the batch left out, a token altered where
it is produced) or with the e4m3 control in the program's place, not. Also
the result's line and the refusals without a card or a program."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from cellbench import testing
from cellbench.harness import cli, compare, manifest
from cellbench.kinds import serve_closed, train

ROOT = Path(__file__).resolve().parents[1]
SEED = 2 ** 31 + 77


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return testing.make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("fault", [None, "unchanged", "half_batch"])
def test_train_run(root, fault):
    cell = manifest.load_cell(root, "tiny-dense.train")
    out = train.run(cell, SEED, 0.2, False, "cpu", fault=fault)
    assert compare.within(out["checks"]) == (fault is None)
    assert out["attempted"] >= 1 and out["failed"] == 0


@pytest.mark.parametrize("fault", [None, "altered"])
def test_serve_run(root, fault):
    cell = manifest.load_cell(root, "tiny-moe.serve")
    out = serve_closed.run(cell, SEED, 6.0, False, "cpu", fault=fault)
    assert compare.within(out["checks"]) == (fault is None)
    assert out["attempted"] > 0 and out["e2e"]["serve_tokens_per_s"] > 0


def _control():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "cellbench_control", Path(__file__).parent / "control.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("cell", ["tiny-dense.train", "tiny-moe.serve"])
def test_control_is_not_correct(root, cell):
    c = manifest.load_cell(root, cell)
    ctl = _control()
    r = (ctl.train_readings(c, SEED, "cpu") if "train" in cell else
         ctl.serve_readings(c, SEED, "cpu", 6.0))
    lim = lambda got: {k: {"value": v, "limit": c.limits[k]}   # noqa: E731
                       for k, v in got.items()}
    assert compare.within(lim(r["program"]))
    assert not compare.within(lim(r["control"]))
    if "half_batch" in r:
        assert not compare.within(lim(r["half_batch"]))


def test_result_line(root, monkeypatch):
    monkeypatch.setattr(cli, "device_info", lambda chips, peak, trace: {
        "platform": "gpu", "kind": "test", "count": chips,
        "memory_peak_bytes": peak})
    cell = manifest.load_cell(root, "tiny-moe.serve")
    out = serve_closed.run(cell, SEED, 6.0, True, "cpu")
    res = cli.line(cell, out, True, 1.5, 1)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"]
    assert set(res["metrics"]) <= {m["name"] for m in cell.per_layer}
    assert {"prefill_ms_p50.serve", "ttft_p90_ms.serve"} <= set(
        res["metrics"])
    res = cli.line(cell, out, False, 1.5, 1)
    assert set(res["metrics"]) == {"serve_tokens_per_s", "setup_s"}
    json.dumps(res)


def test_no_card_no_result(capsys, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = cli.main(0.0, ROOT, ["--workload", "internlm2-1.8b.train-s2048",
                              "--seed", "1", "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "cellbench", tmp_path / "cellbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run(
        [sys.executable, "cellbench/run.py", "--workload",
         "qwen2-moe-a2.7b.serve-longprompt", "--seed", "1", "--seconds", "1"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and "{" not in p.stdout


@pytest.mark.card
@pytest.mark.parametrize("cell", ["internlm2-1.8b.train-s2048",
                                  "qwen2-moe-a2.7b.serve-longprompt"])
def test_cell_on_the_card(cell, card):
    p = subprocess.run([sys.executable, "cellbench/run.py", "--workload",
                        cell, "--seed", "5", "--seconds", "5"],
                       cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
