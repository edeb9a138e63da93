"""A benchmark root of test-only cells, made as files alone in a temporary
directory: tiny configurations of the two families, with traffic mixes cut
to a CPU's size, and their own limits. Also two tiny MLA configurations
(a dense leading layer, then MLA with experts and two shared ones; one
without query compression, one with it), which the harness draws and
counts and the port runs, but no cell."""
from __future__ import annotations

import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent

DENSE = {"name": "tiny-dense", "model": {
    "family": "dense", "n_layers": 2, "d_model": 64, "n_heads": 4,
    "n_kv_heads": 2, "head_dim": 16, "d_ff": 128, "vocab_size": 256,
    "rope_theta": 1e6, "norm_eps": 1e-5, "qkv_bias": False,
    "dtype": "float32", "param_dtype": "float32",
    "period": [{"mixer": "attn", "ffn": "dense"}]}, "reference": "decoder"}
MOE = {"name": "tiny-moe", "model": {
    "family": "moe", "n_layers": 2, "d_model": 64, "n_heads": 4,
    "n_kv_heads": 4, "head_dim": 16, "d_ff": 32, "vocab_size": 256,
    "rope_theta": 1e6, "norm_eps": 1e-6, "qkv_bias": True,
    "dtype": "float32", "param_dtype": "float32",
    "period": [{"mixer": "attn", "ffn": "moe"}],
    "moe": {"n_experts": 8, "top_k": 2, "d_ff_expert": 32, "n_shared": 1,
            "d_ff_shared": 64, "norm_topk": False, "router": "softmax",
            "pad_to": 0}}, "reference": "decoder"}
MLA = {"name": "tiny-mla", "model": {
    "family": "moe", "n_layers": 3, "d_model": 64, "n_heads": 4,
    "n_kv_heads": 4, "head_dim": 16, "d_ff": 96, "vocab_size": 256,
    "rope_theta": 1e4, "norm_eps": 1e-6, "qkv_bias": False,
    "dtype": "float32", "param_dtype": "float32",
    "prelayers": [{"mixer": "mla", "ffn": "dense"}],
    "period": [{"mixer": "mla", "ffn": "moe"}],
    "mla": {"q_lora_rank": 0, "kv_lora_rank": 32, "qk_nope_head_dim": 16,
            "qk_rope_head_dim": 8, "v_head_dim": 16},
    "moe": {"n_experts": 8, "top_k": 3, "d_ff_expert": 16, "n_shared": 2,
            "d_ff_shared": 32, "norm_topk": False, "router": "softmax",
            "pad_to": 0}}}
MLA_Q = {"name": "tiny-mla-q", "model": dict(
    MLA["model"], mla=dict(MLA["model"]["mla"], q_lora_rank=48))}

# DeepSeek-V2-Lite's published keys (huggingface.co/deepseek-ai/
# DeepSeek-V2-Lite, config.json) and the model section a configuration
# file would give it whole; for the check against the source and the
# layout at full size (nothing is drawn)
DSV2_LITE = {"name": "deepseek-v2-lite", "published": {
    "hidden_size": 2048, "num_hidden_layers": 27, "num_attention_heads": 16,
    "num_key_value_heads": 16, "intermediate_size": 10944,
    "moe_intermediate_size": 1408, "n_routed_experts": 64,
    "n_shared_experts": 2, "num_experts_per_tok": 6, "norm_topk_prob": False,
    "first_k_dense_replace": 1, "kv_lora_rank": 512, "q_lora_rank": None,
    "qk_nope_head_dim": 128, "qk_rope_head_dim": 64, "v_head_dim": 128,
    "vocab_size": 102400, "rope_theta": 10000, "rms_norm_eps": 1e-06},
    "model": {
    "family": "moe", "n_layers": 27, "d_model": 2048, "n_heads": 16,
    "n_kv_heads": 16, "d_ff": 10944, "vocab_size": 102400,
    "rope_theta": 10000, "norm_eps": 1e-06, "dtype": "bfloat16",
    "param_dtype": "float32",
    "prelayers": [{"mixer": "mla", "ffn": "dense"}],
    "period": [{"mixer": "mla", "ffn": "moe"}],
    "mla": {"q_lora_rank": 0, "kv_lora_rank": 512, "qk_nope_head_dim": 128,
            "qk_rope_head_dim": 64, "v_head_dim": 128},
    "moe": {"n_experts": 64, "top_k": 6, "d_ff_expert": 1408, "n_shared": 2,
            "d_ff_shared": 2816, "norm_topk": False, "router": "softmax",
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
