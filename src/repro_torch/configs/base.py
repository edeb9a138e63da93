"""Model/shape configuration for the PyTorch port.

A copy of ``repro/configs/base.py``: the port imports nothing of the JAX
package, so it keeps its own dataclasses. Every architecture is a
:class:`ModelConfig`: a layer *period* (tuple of :class:`LayerSpec`)
repeated ``n_periods`` times, optionally preceded by ``prelayers``. The port
unstacks the period into a flat list of layers.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int                 # routed experts
    top_k: int
    d_ff_expert: int               # per-expert FFN hidden size
    n_shared: int = 0              # shared ("always-on") experts
    d_ff_shared: int = 0           # total hidden size of the shared expert block
    capacity_factor: float = 1.25
    router: str = "softmax"        # softmax | sigmoid
    norm_topk: bool = True         # renormalize top-k weights
    aux_loss_coef: float = 0.01
    pad_to: int = 0                # 0 = no padding requested


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536        # 0 = no query compression
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0               # 0 -> ceil(d_model / 16)

    def resolved_dt_rank(self, d_model: int) -> int:
        return self.dt_rank or -(-d_model // 16)


@dataclass(frozen=True)
class XLSTMConfig:
    n_heads: int = 4
    expand: int = 2                # mLSTM up-projection factor
    conv_width: int = 4


@dataclass(frozen=True)
class LayerSpec:
    """One sublayer position inside the repeating period."""
    mixer: str                     # attn | mla | mamba | mlstm | slstm
    ffn: str = "dense"             # dense | moe | none
    parallel: bool = False         # parallel attention+FFN (Cohere-style)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    # block structure
    period: Tuple[LayerSpec, ...] = (LayerSpec("attn", "dense"),)
    prelayers: Tuple[LayerSpec, ...] = ()
    # attention
    rope_theta: float = 10000.0
    pos_emb: str = "rope"          # rope | sincos | none
    use_bias: bool = False
    qkv_bias: bool = False         # bias on qkv only (Qwen-style)
    ffn_gated: bool = True         # SwiGLU vs plain 2-layer GELU
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    norm_eps: float = 1e-5
    qk_norm: bool = False
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    embedding_multiplier: float = 1.0
    # sub-configs
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    mamba: Optional[MambaConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    # modality frontend stub: tokens | embeds (audio frames) | tokens+vision
    input_mode: str = "tokens"
    vision_tokens: int = 0         # patches prepended when input_mode=tokens+vision
    # long-context capability: attention-free / hybrid archs only
    supports_long_context: bool = False
    # numerics
    dtype: str = "bfloat16"        # activations / compute
    param_dtype: str = "float32"
    # attention chunking of the JAX reference's XLA path (unused by the port,
    # kept so a config compares field for field with its reference)
    attn_chunk: int = 1024
    max_attn_chunks: int = 16

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        total = len(self.prelayers) + len(self.period) * self.n_periods
        if total != self.n_layers:
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} does not decompose into "
                f"{len(self.prelayers)} prelayers + {self.n_periods} x "
                f"{len(self.period)}-layer periods")

    @property
    def n_periods(self) -> int:
        return (self.n_layers - len(self.prelayers)) // len(self.period)

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def layer_specs(self) -> Tuple[LayerSpec, ...]:
        """Every layer in order: prelayers, then the period unstacked."""
        return self.prelayers + self.period * self.n_periods

    def smoke(self, **over) -> "ModelConfig":
        """A tiny same-family variant for CPU smoke tests."""
        period = self.period
        prelayers = self.prelayers
        n_layers = len(prelayers) + 2 * len(period)
        moe = self.moe
        if moe is not None:
            moe = replace(moe, n_experts=8, top_k=min(moe.top_k, 2),
                          d_ff_expert=64, n_shared=min(moe.n_shared, 1),
                          d_ff_shared=64 if moe.n_shared else 0, pad_to=0)
        mla = self.mla
        if mla is not None:
            mla = replace(mla, q_lora_rank=32, kv_lora_rank=32,
                          qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16)
        mamba = self.mamba
        if mamba is not None:
            mamba = replace(mamba, d_state=8, d_conv=4, expand=2, dt_rank=8)
        defaults = dict(
            name=self.name + "-smoke", n_layers=n_layers, d_model=64,
            n_heads=4, n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            head_dim=16, d_ff=128 if self.d_ff else 0, vocab_size=256,
            moe=moe, mla=mla, mamba=mamba, xlstm=self.xlstm,
            vision_tokens=8 if self.vision_tokens else 0,
            attn_chunk=32, max_attn_chunks=4,
        )
        defaults.update(over)
        return replace(self, **defaults)


@dataclass(frozen=True)
class ShapeConfig:
    """An assigned (input-shape) cell: what ``parallel.sharding.decode_plan``
    reads to choose the decode layout."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
