"""xLSTM-125M [arXiv:2405.04517]: attention-free sLSTM + mLSTM blocks.
12L d_model=768, 4 heads, vocab=50304, d_ff=0 (blocks carry their own
projections). Block ratio 3:1 mLSTM:sLSTM (period m,m,m,s — the paper's
xLSTM[7:1] ratio rounded to a 12-layer stack; recorded in DESIGN.md).
Attention-free => runs the long_500k cell with O(1)/token state."""
from repro_torch.configs.base import LayerSpec, ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    head_dim=192,
    d_ff=0,
    vocab_size=50304,
    period=(LayerSpec("mlstm", "none"), LayerSpec("mlstm", "none"),
            LayerSpec("mlstm", "none"), LayerSpec("slstm", "none")),
    pos_emb="none",
    tie_embeddings=True,
    xlstm=XLSTMConfig(n_heads=4, expand=2, conv_width=4),
    supports_long_context=True,
)

SMOKE = CONFIG.smoke(d_model=64, n_heads=4, n_kv_heads=4, head_dim=16)
