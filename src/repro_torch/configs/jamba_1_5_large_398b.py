"""Jamba-1.5-Large (398B) [arXiv:2403.19887]: Mamba+attention 1:7 hybrid
with MoE. 72L d_model=8192; attention layers at offset 4 of every 8-layer
period (64H GQA kv=8); MoE (16 experts top-2, d_ff=24576) every other
layer; Mamba d_state=16 conv=4 expand=2; vocab=65536; no positional
embedding (Mamba layers carry position). Hybrid => runs long_500k (only
9/72 layers hold KV, sharded along sequence)."""
from repro_torch.configs.base import (LayerSpec, MambaConfig, ModelConfig,
                                      MoEConfig)

_PERIOD = tuple(
    LayerSpec("attn" if i == 4 else "mamba", "moe" if i % 2 == 1 else "dense")
    for i in range(8)
)

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    period=_PERIOD,
    pos_emb="none",
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=24576),
    supports_long_context=True,
)

SMOKE = CONFIG.smoke()
