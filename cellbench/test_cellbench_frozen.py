"""The two configurations the cells run, held to frozen copies of what the
harness made of them before it read layer specs: the groups of leaves it
draws (order, shapes, inits, stds, dtypes), the port's model
configuration, the model FLOPs, and the four roofline readers' values on a
fixed synthetic context. The same seed then draws the same bits, and every
check and metric of both cells reads as it did."""
import json
from pathlib import Path

import pytest

from cellbench.harness import manifest, weights, work
from cellbench.harness.program import model_config
from cellbench.harness.tracing import Trace

CONFIGS = Path(__file__).parent / "configs"

S2048 = 0.02209708691207961          # 2048 ** -0.5, as drawn
BF, F32 = "bfloat16", "float32"

# (kind, stacked shape, init, std, serving dtype, training dtype)
LAYOUT = {
    "internlm2-1.8b": [
        ("embed.tok", (92544, 2048), "normal", 0.02, BF, F32),
        ("embed.unembed", (92544, 2048), "normal", 0.02, BF, F32),
        ("out_norm.scale", (2048,), "norm", 0.05, F32, F32),
        ("mixer_norm.scale", (24, 2048), "norm", 0.05, F32, F32),
        ("mixer.wq", (24, 2048, 2048), "normal", S2048, BF, F32),
        ("mixer.wkv", (24, 2048, 2048), "normal", S2048, BF, F32),
        ("mixer.wo", (24, 2048, 2048), "normal", S2048, BF, F32),
        ("ffn_norm.scale", (24, 2048), "norm", 0.05, F32, F32),
        ("ffn.w_in", (24, 2048, 16384), "normal", S2048, BF, F32),
        ("ffn.w_out", (24, 8192, 2048), "normal", 0.011048543456039806, BF,
         F32)],
    "qwen2-moe-a2.7b": [
        ("embed.tok", (151936, 2048), "normal", 0.02, BF, F32),
        ("embed.unembed", (151936, 2048), "normal", 0.02, BF, F32),
        ("out_norm.scale", (2048,), "norm", 0.05, F32, F32),
        ("mixer_norm.scale", (24, 2048), "norm", 0.05, F32, F32),
        ("mixer.wq", (24, 2048, 2048), "normal", S2048, BF, F32),
        ("mixer.wkv", (24, 2048, 4096), "normal", S2048, BF, F32),
        ("mixer.wo", (24, 2048, 2048), "normal", S2048, BF, F32),
        ("ffn_norm.scale", (24, 2048), "norm", 0.05, F32, F32),
        ("mixer.bq", (24, 2048), "bias", 0.02, F32, F32),
        ("mixer.bkv", (24, 4096), "bias", 0.02, F32, F32),
        ("ffn.router", (24, 2048, 60), "normal", S2048, F32, F32),
        ("ffn.w_in", (24, 60, 2048, 2816), "normal", S2048, BF, F32),
        ("ffn.w_out", (24, 60, 1408, 2048), "normal", 0.026650089544451305,
         BF, F32),
        ("ffn.shared_w_in", (24, 2048, 11264), "normal", S2048, BF, F32),
        ("ffn.shared_w_out", (24, 5632, 2048), "normal",
         0.013325044772225653, BF, F32)]}

# the fields the configuration files set; the rest are the port's defaults
COMMON = dict(n_layers=24, d_model=2048, n_heads=16, head_dim=128,
              rope_theta=1e6, dtype="bfloat16", param_dtype="float32")
MODEL = {
    "internlm2-1.8b": dict(COMMON, family="dense", n_kv_heads=8, d_ff=8192,
                           vocab_size=92544, norm_eps=1e-5, qkv_bias=False),
    "qwen2-moe-a2.7b": dict(COMMON, family="moe", n_kv_heads=16, d_ff=1408,
                            vocab_size=151936, norm_eps=1e-6,
                            qkv_bias=True)}

PREFILL_L, DECODE_CTX = (1, 256, 1000, 1024, 3968), (1, 300, 4000)
WORK = {
    "internlm2-1.8b": {
        "params": {"layers": 1509949440, "unembed": 189530112},
        "prefill": [3399155712.0, 779940790272.0, 3118680244224.0,
                    3195935391744.0, 13531526725632.0],
        "decode": [3399155712.0, 3457941504.0, 4185391104.0],
        "train": 353932148736000.0, "attn": 412518187008.0},
    "qwen2-moe-a2.7b": {
        "params": {"layers": 2066546688, "unembed": 311164928},
        "prefill": [4755619840.0, 1065161850880.0, 4232118009856.0,
                    4336089825280.0, 17948925755392.0],
        "decode": [4755619840.0, 4814405632.0, 5541855232.0],
        "train": 487277998374912.0, "attn": 412518187008.0}}

READERS = {
    "internlm2-1.8b": {"attn_roofline.serve": 0.35073808543820834,
                       "norm_roofline.serve": 3.524553468179105,
                       "attn_roofline.train": 6.228788263551871,
                       "norm_roofline.train": 40.644229945313434},
    "qwen2-moe-a2.7b": {"attn_roofline.serve": 0.35191186454268597,
                        "norm_roofline.serve": 3.524553468179105,
                        "attn_roofline.train": 6.228788263551871,
                        "norm_roofline.train": 40.644229945313434}}

NAMES = sorted(LAYOUT)


def _config(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


@pytest.mark.parametrize("name", NAMES)
def test_layout_is_frozen(name):
    m = _config(name)["model"]
    got = weights.layout(m)
    assert [(k, s, i, std, str(weights.dtype_of(m, k, s, True))[6:],
             str(weights.dtype_of(m, k, s, False))[6:])
            for k, s, _, i, std in got] == LAYOUT[name]
    for kind, shape, leaves, _, _ in got:
        assert leaves == ([f"layers.{i}.{kind}" for i in range(24)]
                          if weights.stacked(kind) else [kind])


@pytest.mark.parametrize("name", NAMES)
def test_model_config_is_frozen(name):
    from repro_torch.configs.base import LayerSpec, ModelConfig, MoEConfig
    moe = name.startswith("qwen2-moe")
    want = ModelConfig(
        name=name, period=(LayerSpec("attn", "moe" if moe else "dense"),),
        moe=MoEConfig(n_experts=60, top_k=4, d_ff_expert=1408, n_shared=4,
                      d_ff_shared=5632, norm_topk=False, router="softmax",
                      pad_to=0) if moe else None, **MODEL[name])
    assert model_config(_config(name)) == want


@pytest.mark.parametrize("name", NAMES)
def test_work_is_frozen(name):
    m, want = _config(name)["model"], WORK[name]
    assert work.params(m) == want["params"]
    assert [work.prefill_flops(m, L) for L in PREFILL_L] == want["prefill"]
    assert [work.decode_flops(m, c) for c in DECODE_CTX] == want["decode"]
    assert work.train_flops(m, 16, 2048) == want["train"]
    assert work.attn_flops(m, work.causal_pairs(2048)) == want["attn"]


@pytest.mark.parametrize("name", NAMES)
def test_roofline_readers_are_frozen(name):
    m = _config(name)["model"]
    trace = Trace((0.0, 10.0), [("flash_fwd_wgmma<128>", 0.0, 0.5),
                                ("flash_bwd_dq", 1.0, 1.25),
                                ("rmsnorm_kernel<bf16>", 2.0, 2.0625),
                                ("nvjet", 3.0, 4.0)], [])
    serve = {"kind": "serve", "model": m, "trace": trace,
             "traffic": {"max_seq": 4096, "max_batch": 16},
             "traced": {"prefill_lengths": [300, 1000, 3968],
                        "decode_rows": [16, 12, 9]}}
    train = {"kind": "train", "model": m, "trace": trace, "traced_steps": 2,
             "traffic": {"global_batch": 16, "microbatches": 2,
                         "seq_len": 2048}}
    got = {k: manifest.reader(k)(serve if k.endswith("serve") else train)
           for k in READERS[name]}
    assert got == READERS[name]
