"""Qwen1.5-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B]: MoE LM.
24L d_model=2048 16H (kv=16) vocab=151936; 60 routed experts top-4
(d_ff_expert=1408) + shared expert block of 4x1408=5632; qkv bias.
EP pads routed experts 60 -> 64 (multiple of the 16-wide model axis)."""
from repro_torch.configs.base import LayerSpec, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,                       # routed-expert hidden size (per spec)
    vocab_size=151936,
    period=(LayerSpec("attn", "moe"),),
    rope_theta=1.0e6,
    qkv_bias=True,
    moe=MoEConfig(n_experts=60, top_k=4, d_ff_expert=1408,
                  n_shared=4, d_ff_shared=5632, norm_topk=False,
                  pad_to=64),
)

SMOKE = CONFIG.smoke()
