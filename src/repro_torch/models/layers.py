"""Shared primitive layers: norms, positional embeddings, dense FFN,
embeddings. Port of ``repro/models/layers.py``.

Plain functions over (config, params, inputs), named as in JAX. ``p`` is any
mapping of parameter name to tensor (an ``nn.ParameterDict`` in the model).
Weights are ``(in, out)`` and applied as ``x @ w``.

Tensor parallelism over the mesh's ``model`` axis (what GSPMD derives from
the reference's ``param_specs``, written out): the embedding split over the
vocab (each rank looks up the ids in its rows, a psum adds them), the
unembedding giving each rank its vocab's logits, and the dense FFN
column-parallel into the hidden and row-parallel out of it, with
``pvary`` where a value the ranks share enters their own computation and
``psum`` where their partial results meet (``parallel/collectives.py``).
"""
from __future__ import annotations

import math
from typing import Mapping, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.models.params import TP_AXIS
from repro_torch.parallel.collectives import psum, pvary


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

def ffn_hidden(cfg: ModelConfig, p: Mapping, x: torch.Tensor
               ) -> torch.Tensor:
    """The FFN's hidden activations: SwiGLU of [gate | up], or GELU."""
    dt = x.dtype
    gu = x @ p["w_in"].to(dt)
    if "b_in" in p:
        gu = gu + p["b_in"].to(dt)
    if cfg.ffn_gated:
        g, u = gu.chunk(2, dim=-1)
        return F.silu(g) * u
    return F.gelu(gu, approximate="tanh")    # jax.nn.gelu's default form


def apply_ffn(cfg: ModelConfig, p: Mapping, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    y = ffn_hidden(cfg, p, x) @ p["w_out"].to(dt)
    if "b_out" in p:
        y = y + p["b_out"].to(dt)
    return y


def row_parallel(h: torch.Tensor, w: torch.Tensor, mesh,
                 axis: str = TP_AXIS) -> torch.Tensor:
    """``h @ w`` where each rank holds its part of the contraction (its
    heads or hidden units): each rank's partial product in f32 (products
    of two h.dtype values are exact there), the partials summed, and the
    sum rounded once to h.dtype, as the single device's product is. Bf16
    partials rounded apart move the mesh step's gradients several times
    further from the single process's (``tools/mesh_grad_cosines.py``)."""
    return psum(h.float() @ w.to(h.dtype).float(), axis, mesh).to(h.dtype)


def tp_apply_ffn(cfg: ModelConfig, p: Mapping, x: torch.Tensor, mesh,
                 d_ff: Optional[int] = None, axis: str = TP_AXIS
                 ) -> torch.Tensor:
    """:func:`apply_ffn` over ``axis``: ``w_in`` (and ``b_in``) hold this
    rank's part of the ``d_ff`` hidden units (``cfg.d_ff`` by default; a
    gated FFN's stored grouped, [its gate | its up],
    ``params.grouped_columns``), ``w_out`` their rows; the partial outputs
    are summed (:func:`row_parallel`), then ``b_out`` added once. ``x`` is
    the same on every rank."""
    n = mesh.size(mesh.live((axis,)))
    d_ff = d_ff or cfg.d_ff
    if p["w_out"].shape[0] * n != d_ff:
        raise NotImplementedError(
            f"{cfg.name}: an FFN hidden of {d_ff} does not split over {n} "
            f"ranks")
    h = ffn_hidden(cfg, p, pvary(x, axis, mesh))
    y = row_parallel(h, p["w_out"], mesh, axis)
    if "b_out" in p:
        y = y + p["b_out"].to(y.dtype)
    return y


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def lookup(p: Mapping, tokens: torch.Tensor, dt: torch.dtype, mesh=None,
           axis: str = TP_AXIS) -> torch.Tensor:
    """``p["tok"][tokens]`` in ``dt`` (gather, then cast: same values).
    Over a live ``axis`` ``tok`` holds this rank's vocab rows: each rank
    looks up the ids in its range, zeroes the rest, and a psum adds them
    (one nonzero a row, so the sum is exact)."""
    if mesh is None or not mesh.live((axis,)):
        return p["tok"][tokens].to(dt)
    w = p["tok"]
    local = tokens - mesh.axis_index(mesh.live((axis,))) * w.shape[0]
    inside = (local >= 0) & (local < w.shape[0])
    x = w[local.clamp(0, w.shape[0] - 1)].to(dt)
    x = torch.where(inside[..., None], x, torch.zeros((), dtype=dt,
                                                       device=x.device))
    return psum(x, axis, mesh)


def embed_tokens(cfg: ModelConfig, p: Mapping, tokens: Optional[torch.Tensor],
                 extra_embeds: Optional[torch.Tensor] = None,
                 positions: Optional[torch.Tensor] = None, mesh=None
                 ) -> torch.Tensor:
    """The input embeddings; with ``mesh``, ``tok`` split over the vocab
    (:func:`lookup`)."""
    dt = dtype_of(cfg.dtype)
    if cfg.input_mode == "embeds":
        # modality stub: the token slot carries precomputed frame embeddings
        x = extra_embeds.to(dt) @ p["frame_proj"].to(dt)
    else:
        x = lookup(p, tokens, dt, mesh)
        if cfg.input_mode == "tokens+vision" and extra_embeds is not None:
            v = extra_embeds.to(dt) @ p["vision_proj"].to(dt)
            x = torch.cat([v, x], dim=1)
    x = x * embed_scale(cfg)
    if cfg.pos_emb == "sincos":
        if positions is None:
            positions = torch.arange(x.shape[1], device=x.device)[None, :]
        x = x + sincos_pos_emb(positions, cfg.d_model).to(dt)
    return x


def unembed(cfg: ModelConfig, p: Mapping, x: torch.Tensor, mesh=None
            ) -> torch.Tensor:
    """f32 logits of x against the (tied or separate) unembedding; with
    ``mesh``, the weight holds this rank's vocab rows and so do the logits
    (``train.loss.cross_entropy`` takes them so)."""
    w = p["tok"] if cfg.tie_embeddings else p["unembed"]
    if mesh is not None:
        x = pvary(x, TP_AXIS, mesh)
    # products of two x.dtype values are exact in f32: this is the
    # reference's x.dtype einsum with f32 accumulation
    logits = x.float() @ w.to(x.dtype).float().T
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = torch.tanh(logits / c) * c
    return logits
