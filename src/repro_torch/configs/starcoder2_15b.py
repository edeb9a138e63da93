"""StarCoder2-15B [arXiv:2402.19173]: dense GQA code LM.
40L d_model=6144 48H (GQA kv=4) d_ff=24576 vocab=49152; LayerNorm+bias,
plain GELU FFN (non-gated), RoPE theta=1e5."""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    period=(LayerSpec("attn", "dense"),),
    rope_theta=1.0e5,
    use_bias=True,
    ffn_gated=False,
    norm="layernorm",
)

SMOKE = CONFIG.smoke()
