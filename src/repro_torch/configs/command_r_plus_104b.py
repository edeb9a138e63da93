"""Command R+ (104B) [hf:CohereForAI/c4ai-command-r-plus]: dense GQA,
no-bias, parallel attention+FFN blocks, tied embeddings, qk-norm.
64L d_model=12288 96H (GQA kv=8) d_ff=33792 vocab=256000."""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    head_dim=128,
    d_ff=33792,
    vocab_size=256000,
    period=(LayerSpec("attn", "dense", parallel=True),),
    rope_theta=7.5e7,
    norm="layernorm",
    qk_norm=True,
    tie_embeddings=True,
)

SMOKE = CONFIG.smoke()
