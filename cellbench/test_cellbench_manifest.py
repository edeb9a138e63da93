"""BENCHMARK.json against the benchmark's contract, the files each cell is
found by, a test-only cell added as files alone, and the import check."""
import ast
import json
import re
from pathlib import Path

import pytest

from cellbench import testing
from cellbench.harness import guard, layers, manifest

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
    """A configuration's ``model`` section against its source's published
    keys, under Qwen2-MoE's names or DeepSeek-V2's (``n_routed_experts``,
    ``n_shared_experts`` blocks of ``moe_intermediate_size``, the first
    ``first_k_dense_replace`` layers dense, MLA's ranks and head dims)."""
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"] == []
    check_against_source(cfg)


def test_deepseek_v2_key_names_are_checked():
    """DeepSeek-V2-Lite's published keys against the ``model`` section a
    configuration file would give it, whole: it passes the check, and the
    harness lays it out as the port defines it, at its published 15.7e9
    parameters."""
    import math
    from repro_torch.models.params import model_defs
    from cellbench.harness import weights
    from cellbench.harness.program import model_config
    cfg = testing.DSV2_LITE
    check_against_source(cfg)
    shapes = {leaf: shape[1:] if weights.stacked(kind) else shape
              for kind, shape, leaves, _, _ in weights.layout(cfg["model"])
              for leaf in leaves}
    assert shapes == {k: d.shape for k, d in
                      model_defs(model_config(cfg)).items()}
    assert round(sum(math.prod(s) for s in shapes.values()) / 1e9, 2) == 15.71
    wrong = json.loads(json.dumps(cfg))
    wrong["model"]["moe"]["d_ff_shared"] = 1408
    with pytest.raises(AssertionError):
        check_against_source(wrong)


def check_against_source(cfg):
    pub, m = cfg["published"], cfg["model"]
    assert m["n_layers"] == pub["num_hidden_layers"]
    assert m["d_model"] == pub["hidden_size"]
    assert m["n_heads"] == pub["num_attention_heads"]
    assert m["n_kv_heads"] == pub["num_key_value_heads"]
    assert m["vocab_size"] == pub["vocab_size"]
    assert m["rope_theta"] == pub["rope_theta"]
    assert m["norm_eps"] == pub["rms_norm_eps"]
    specs = layers.specs(m)
    if all(s.mixer == "attn" for s in specs):
        assert m["head_dim"] * m["n_heads"] == m["d_model"]
    if "mla" in m:
        a = m["mla"]
        assert a["kv_lora_rank"] == pub["kv_lora_rank"]
        assert a["q_lora_rank"] == (pub["q_lora_rank"] or 0)
        for k in ("qk_nope_head_dim", "qk_rope_head_dim", "v_head_dim"):
            assert a[k] == pub[k]
    assert len(m.get("prelayers", [])) == pub.get("first_k_dense_replace",
                                                  0)
    if any(s.ffn == "dense" for s in specs):
        assert m["d_ff"] == pub["intermediate_size"]
    if "moe" in m:
        moe = m["moe"]
        assert moe["n_experts"] == pub.get("num_experts",
                                           pub.get("n_routed_experts"))
        assert moe["top_k"] == pub["num_experts_per_tok"]
        assert moe["d_ff_expert"] == pub["moe_intermediate_size"]
        assert moe["d_ff_shared"] == pub.get(
            "shared_expert_intermediate_size",
            pub.get("n_shared_experts", 0) * pub["moe_intermediate_size"])
        assert moe["norm_topk"] == pub["norm_topk_prob"]


def test_a_reference_module_that_is_not_there_is_named(tmp_path):
    """The kinds call only the module a configuration's ``reference``
    names: one that is not there, or lacks a function the harness calls,
    is an error that names it; nothing falls back to ``decoder``."""
    from cellbench.kinds import serve_closed, train
    root = testing.make_root(tmp_path)
    path = root / "bench" / "configs" / "tiny-dense.json"
    path.write_text(json.dumps(dict(testing.DENSE,
                                    reference="no_such_reference")))
    cell = manifest.load_cell(root, "tiny-dense.train")
    with pytest.raises(LookupError, match="no_such_reference"):
        train.reference_readings(cell, 1, "cpu")
    with pytest.raises(LookupError, match="no_such_reference"):
        serve_closed.reference_gaps(cell.config, {}, [])
    with pytest.raises(LookupError, match="has no logits"):
        manifest.reference(dict(testing.DENSE, reference="parts"))
    with pytest.raises(LookupError, match="names no module"):
        manifest.reference(dict(testing.DENSE, reference="../decoder"))
    assert manifest.reference(testing.MOE).__name__ == \
        "cellbench.reference.decoder"


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
