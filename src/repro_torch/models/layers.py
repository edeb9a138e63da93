"""Shared primitive layers: norms, positional embeddings, dense FFN,
embeddings. Port of ``repro/models/layers.py``.

Plain functions over (config, params, inputs), named as in JAX. ``p`` is any
mapping of parameter name to tensor (an ``nn.ParameterDict`` in the model).
Weights are ``(in, out)`` and applied as ``x @ w``.
"""
from __future__ import annotations

import math
from typing import Mapping, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rmsnorm import rmsnorm


def dtype_of(name: str) -> torch.dtype:
    return getattr(torch, name)


def embed_scale(cfg: ModelConfig) -> float:
    """``cfg.embedding_multiplier`` rounded to the compute dtype, as the
    reference applies it; a Python scalar, so no host-to-device copy."""
    return torch.tensor(cfg.embedding_multiplier,
                        dtype=dtype_of(cfg.dtype)).item()


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def apply_norm(cfg: ModelConfig, p: Mapping, x: torch.Tensor) -> torch.Tensor:
    """RMSNorm (through the rmsnorm kernel) or LayerNorm, in f32, cast back
    to the input dtype."""
    if cfg.norm == "rmsnorm":
        return rmsnorm(x, p["scale"], cfg.norm_eps)
    xf = x.float()
    xf = xf - xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + cfg.norm_eps) * p["scale"].float()
    return (y + p["bias"].float()).to(x.dtype)


def rms_head_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
                  ) -> torch.Tensor:
    """Per-head qk-norm (no mean subtraction)."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary / sinusoidal position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (float(theta) ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions broadcastable to (..., seq).
    Split-half rotation with the angles in f32."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs        # (..., seq, hd/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sincos_pos_emb(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    """Classic transformer sinusoidal embedding; positions (..., seq)."""
    half = d_model // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# Dense (SwiGLU / GELU) FFN
# ---------------------------------------------------------------------------

def apply_ffn(cfg: ModelConfig, p: Mapping, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    gu = x @ p["w_in"].to(dt)
    if "b_in" in p:
        gu = gu + p["b_in"].to(dt)
    if cfg.ffn_gated:
        g, u = gu.chunk(2, dim=-1)
        h = F.silu(g) * u
    else:
        h = F.gelu(gu, approximate="tanh")    # jax.nn.gelu's default form
    y = h @ p["w_out"].to(dt)
    if "b_out" in p:
        y = y + p["b_out"].to(dt)
    return y


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embed_tokens(cfg: ModelConfig, p: Mapping, tokens: Optional[torch.Tensor],
                 extra_embeds: Optional[torch.Tensor] = None,
                 positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    dt = dtype_of(cfg.dtype)
    if cfg.input_mode == "embeds":
        # modality stub: the token slot carries precomputed frame embeddings
        x = extra_embeds.to(dt) @ p["frame_proj"].to(dt)
    else:
        x = p["tok"][tokens].to(dt)            # gather, then cast: same values
        if cfg.input_mode == "tokens+vision" and extra_embeds is not None:
            v = extra_embeds.to(dt) @ p["vision_proj"].to(dt)
            x = torch.cat([v, x], dim=1)
    x = x * embed_scale(cfg)
    if cfg.pos_emb == "sincos":
        if positions is None:
            positions = torch.arange(x.shape[1], device=x.device)[None, :]
        x = x + sincos_pos_emb(positions, cfg.d_model).to(dt)
    return x


def unembed(cfg: ModelConfig, p: Mapping, x: torch.Tensor) -> torch.Tensor:
    """f32 logits of x against the (tied or separate) unembedding."""
    w = p["tok"] if cfg.tie_embeddings else p["unembed"]
    # products of two x.dtype values are exact in f32: this is the
    # reference's x.dtype einsum with f32 accumulation
    logits = x.float() @ w.to(x.dtype).float().T
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = torch.tanh(logits / c) * c
    return logits
