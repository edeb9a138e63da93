"""Llama-3.1-405B [arXiv:2407.21783]: dense GQA LM.
126L d_model=16384 128H (GQA kv=8) d_ff=53248 vocab=128256; RMSNorm,
SwiGLU, RoPE theta=5e5."""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    head_dim=128,
    d_ff=53248,
    vocab_size=128256,
    period=(LayerSpec("attn", "dense"),),
    rope_theta=5.0e5,
)

SMOKE = CONFIG.smoke()
