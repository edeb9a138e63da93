"""A benchmark root of test-only cells, made as files alone in a temporary
directory: tiny configurations of the two families, with traffic mixes cut
to a CPU's size, and their own limits."""
from __future__ import annotations

import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent

DENSE = {"name": "tiny-dense", "model": {
    "family": "dense", "n_layers": 2, "d_model": 64, "n_heads": 4,
    "n_kv_heads": 2, "head_dim": 16, "d_ff": 128, "vocab_size": 256,
    "rope_theta": 1e6, "norm_eps": 1e-5, "qkv_bias": False,
    "dtype": "float32", "param_dtype": "float32",
    "period": [{"mixer": "attn", "ffn": "dense"}]}}
MOE = {"name": "tiny-moe", "model": {
    "family": "moe", "n_layers": 2, "d_model": 64, "n_heads": 4,
    "n_kv_heads": 4, "head_dim": 16, "d_ff": 32, "vocab_size": 256,
    "rope_theta": 1e6, "norm_eps": 1e-6, "qkv_bias": True,
    "dtype": "float32", "param_dtype": "float32",
    "period": [{"mixer": "attn", "ffn": "moe"}],
    "moe": {"n_experts": 8, "top_k": 2, "d_ff_expert": 32, "n_shared": 1,
            "d_ff_shared": 64, "norm_topk": False, "router": "softmax",
            "pad_to": 0}}}

# the test cells' limits: the train cell's are the full cell's (the float32
# program reads about 1e-7 on them); the mean served gap's is set between
# what the program (at most 4.7e-4 over 20 seeds: its cache is bf16) and
# the e4m3 control (at least 4.1e-3) read at this size, as the full cell's
# was at its own
LIMITS = {"tiny-dense.train": json.loads(
              (BENCH / "limits" / "internlm2-1.8b.train-s2048.json")
              .read_text())["limits"],
          "tiny-moe.serve": {"served_gap_mean": 1.5e-3}}


def make_root(tmp: Path, dtype: str = "float32") -> Path:
    """``tmp`` as a checkout holding BENCHMARK.json and the test cells'
    files under ``bench/``; the code stays the harness's own."""
    b = tmp / "bench"
    for d in ("configs", "traffic", "limits"):
        (b / d).mkdir(parents=True, exist_ok=True)
    for cfg in (DENSE, MOE):
        c = json.loads(json.dumps(cfg))
        c["model"]["dtype"] = dtype
        (b / "configs" / f"{cfg['name']}.json").write_text(json.dumps(c))
    train = json.loads((BENCH / "traffic" / "train-s2048.json").read_text())
    train.update(global_batch=4, seq_len=32, microbatches=2, trace_steps=1)
    serve = json.loads((BENCH / "traffic" / "serve-longprompt.json")
                       .read_text())
    serve.update(clients=8, max_batch=8, max_seq=64, block=8,
                 prompt={"dist": "lognormal", "median": 16, "sigma": 0.75,
                         "min": 4, "max": 40},
                 output={"dist": "uniform", "min": 4, "max": 8},
                 sample_requests=32, trace_seconds=0.2)
    (b / "traffic" / "tiny-train.json").write_text(json.dumps(train))
    (b / "traffic" / "tiny-serve.json").write_text(json.dumps(serve))
    for name, lim in LIMITS.items():
        (b / "limits" / f"{name}.json").write_text(
            json.dumps({"limits": lim}))
    manifest = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    manifest["paths"] = ["bench"]
    manifest["configs"] = [
        {"name": c["name"], "source": "test", "reduced": [], "why": "test",
         "file": f"bench/configs/{c['name']}.json"} for c in (DENSE, MOE)]
    manifest["workloads"] = [
        {"name": "tiny-dense.train", "config": "tiny-dense",
         "traffic": "tiny-train", "chips": 1, "why": "test"},
        {"name": "tiny-moe.serve", "config": "tiny-moe",
         "traffic": "tiny-serve", "chips": 1, "why": "test"}]
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["tiny-dense.train" if "train" in w else
                              "tiny-moe.serve" for w in m["workloads"]]
    (tmp / "BENCHMARK.json").write_text(json.dumps(manifest))
    return tmp
