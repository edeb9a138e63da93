"""TACC reference workload: ~110M dense LM used by the end-to-end cluster
examples (a copy of ``repro/configs/tacc_100m.py``)."""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="tacc-100m",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=4,
    head_dim=64,
    d_ff=3072,
    vocab_size=32768,
    period=(LayerSpec("attn", "dense"),),
    rope_theta=1.0e4,
)

SMOKE = CONFIG.smoke()
