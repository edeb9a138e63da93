"""MusicGen-medium [arXiv:2306.05284]: decoder-only LM over EnCodec tokens.
48L d_model=1536 24H (kv=24) d_ff=6144 vocab=2048; LayerNorm, plain GELU
FFN, sinusoidal positions. Per the assignment, the EnCodec frontend is a
STUB: ``input_specs()`` provides precomputed frame embeddings (the sum of
the 4 codebook embeddings); the 4-codebook delay-pattern head is collapsed
to a single vocab=2048 stream (documented in DESIGN.md)."""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    period=(LayerSpec("attn", "dense"),),
    pos_emb="sincos",
    norm="layernorm",
    ffn_gated=False,
    input_mode="embeds",
)

SMOKE = CONFIG.smoke()
