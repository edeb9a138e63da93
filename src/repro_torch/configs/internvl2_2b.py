"""InternVL2-2B [arXiv:2404.16821]: VLM = InternViT frontend + InternLM2-1.8B
backbone. Per the assignment the vision frontend is a STUB: ``input_specs()``
provides precomputed patch embeddings (256 tokens) that are projected and
prepended to the text sequence. Backbone: 24L d_model=2048 16H (GQA kv=8)
d_ff=8192 vocab=92553."""
from repro_torch.configs.base import LayerSpec, ModelConfig

VISION_TOKENS = 256

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92553,
    period=(LayerSpec("attn", "dense"),),
    rope_theta=1.0e6,
    input_mode="tokens+vision",
    vision_tokens=VISION_TOKENS,
)

SMOKE = CONFIG.smoke()
