"""DeepSeek-V2 (236B) [arXiv:2405.04434]: MLA + MoE.
60L d_model=5120 128H; MLA kv_lora=512 q_lora=1536 (nope 128 / rope 64 /
v 128); layer 0 dense FFN d_ff=12288; layers 1..59: 160 routed experts
top-6 (d_ff_expert=1536) + 2 shared (2x1536=3072). vocab=102400."""
from repro_torch.configs.base import LayerSpec, MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,                  # MLA is effectively MHA (kv=128 per spec)
    head_dim=128,
    d_ff=12288,                      # dense FFN of layer 0
    vocab_size=102400,
    prelayers=(LayerSpec("mla", "dense"),),
    period=(LayerSpec("mla", "moe"),),
    rope_theta=1.0e4,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=160, top_k=6, d_ff_expert=1536,
                  n_shared=2, d_ff_shared=3072),
)

SMOKE = CONFIG.smoke()
