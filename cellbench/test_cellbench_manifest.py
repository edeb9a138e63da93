"""BENCHMARK.json against the benchmark's contract, the files each cell is
found by, a test-only cell added as files alone, and the import check."""
import ast
import json
import re
from pathlib import Path

import pytest

from cellbench import testing
from cellbench.harness import guard, manifest

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "cellbench"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_manifest_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["cellbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in SPEC[k]}) == len(SPEC[k])
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_what_the_contract_asks(cell):
    c = manifest.load_cell(ROOT, cell)
    e2e = [m["name"] for m in c.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:      # the metric each moves is reported here too
        assert m["moves"] in e2e
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()
    assert c.limits and all(v > 0 for v in c.limits.values())
    assert c.chips == 1
    assert len(c.workload["why"]) <= 200


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda e: e["name"])
def test_configuration_files(entry):
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"] == []
    pub, m = cfg["published"], cfg["model"]
    assert m["n_layers"] == pub["num_hidden_layers"]
    assert m["d_model"] == pub["hidden_size"]
    assert m["n_heads"] == pub["num_attention_heads"]
    assert m["n_kv_heads"] == pub["num_key_value_heads"]
    assert m["vocab_size"] == pub["vocab_size"]
    assert m["rope_theta"] == pub["rope_theta"]
    assert m["norm_eps"] == pub["rms_norm_eps"]
    assert m["head_dim"] * m["n_heads"] == m["d_model"]
    if "moe" in m:
        assert m["moe"]["n_experts"] == pub["num_experts"]
        assert m["moe"]["top_k"] == pub["num_experts_per_tok"]
        assert m["moe"]["d_ff_expert"] == pub["moe_intermediate_size"]
        assert m["moe"]["d_ff_shared"] == pub["shared_expert_intermediate_size"]
        assert m["moe"]["norm_topk"] == pub["norm_topk_prob"]
    else:
        assert m["d_ff"] == pub["intermediate_size"]


def test_a_cell_added_as_files_alone(tmp_path):
    root = testing.make_root(tmp_path)
    for name in ("tiny-dense.train", "tiny-moe.serve"):
        c = manifest.load_cell(root, name)
        assert c.config["name"] == name.split(".")[0]
        assert manifest.kind(c.traffic["kind"]).run
        assert {m["name"] for m in c.per_layer} <= {
            p.stem for p in (BENCH / "metrics").glob("*.py")}
    with pytest.raises(KeyError):
        manifest.load_cell(root, "no-such-cell")


def test_import_check_compares_top_level_names_whole():
    names = ["repro_torch", "repro_torch.models", "reprox", "jaxtyping",
             "repro", "repro.models.attention", "jax", "jax.numpy",
             "jaxlib.xla", "flax.linen", "flaxx", "cellbench.harness"]
    assert guard.forbidden(names) == ["flax.linen", "jax", "jax.numpy",
                                      "jaxlib.xla", "repro",
                                      "repro.models.attention"]


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    p for p in BENCH.rglob("*.py") if not p.name.startswith("test_")),
    ids=lambda p: str(p.relative_to(BENCH)))
def test_no_file_the_benchmark_runs_imports_jax(path):
    tops = {n.split(".")[0] for n in _imports(path)}
    assert not tops & set(guard.FORBIDDEN)
    if path.parent.name == "reference":
        assert "repro_torch" not in tops and "cellbench" not in tops
