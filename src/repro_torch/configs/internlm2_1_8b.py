"""InternLM2-1.8B [arXiv:2403.17297]: dense GQA LM.
24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92544; RMSNorm, SwiGLU,
RoPE theta=1e6."""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92544,
    period=(LayerSpec("attn", "dense"),),
    rope_theta=1.0e6,
)

SMOKE = CONFIG.smoke()
