"""Multi-head Latent Attention (DeepSeek-V2). Port of
``repro/models/mla.py`` (single-device path).

Prefill caches only the compressed latent ``c_kv`` (kv_lora_rank) and the
shared rope key (qk_rope_head_dim) per token. The sequence pass rebuilds
every head's K and V from the latent and runs the flash kernel at the q/k
head dim ``dn + dr`` (192 at full width), with V zero-padded to it
(:func:`v_pad`) and the output cut back to ``dv``. Decode uses the
*absorbed* form: W_uk is folded into the query and W_uv into the output,
so attention runs in the latent space (``parallel/decode_attn.py``); the
naive form, which rebuilds every head's K and V, is kept as its oracle.
The latent norms are RMSNorms through the rmsnorm kernel.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import NEG_INF, flash_attention
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.models.layers import apply_rope
from repro_torch.parallel.decode_attn import mla_decode_local, write_rows


def _up(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., R) times w (R, H, d) -> (..., H, d): one product."""
    R, H, d = w.shape
    return (x @ w.reshape(R, H * d)).reshape(*x.shape[:-1], H, d)


def project_q(cfg: ModelConfig, p: Mapping, x: torch.Tensor,
              positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (q_nope (B,S,H,dn), q_rope (B,S,H,dr), RoPE applied)."""
    m = cfg.mla
    dn = m.qk_nope_head_dim
    dt = x.dtype
    if "w_dq" in p:
        cq = rmsnorm(x @ p["w_dq"].to(dt), p["q_norm"], cfg.norm_eps)
        q = _up(cq, p["w_uq"].to(dt))
    else:
        q = _up(x, p["w_q"].to(dt))
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def project_kv_latent(cfg: ModelConfig, p: Mapping, x: torch.Tensor,
                      positions: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (c_kv (B,S,R) normed, the shared rope key (B,S,dr))."""
    dt = x.dtype
    ckv = rmsnorm(x @ p["w_dkv"].to(dt), p["kv_norm"], cfg.norm_eps)
    kr = x @ p["w_kr"].to(dt)
    kr = apply_rope(kr[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return ckv, kr


def v_pad(v: torch.Tensor, d: int) -> torch.Tensor:
    """Pad the value head dim up to the q/k head dim for the shared flash
    path."""
    if v.shape[-1] == d:
        return v
    return torch.nn.functional.pad(v, (0, d - v.shape[-1]))


def _out(p: Mapping, o: torch.Tensor) -> torch.Tensor:
    """o (..., H, dv) through w_o (H, dv, D)."""
    H, dv, D = p["w_o"].shape
    return o.reshape(*o.shape[:-2], H * dv) @ p["w_o"].to(o.dtype).reshape(
        H * dv, D)


def mla_qkv(cfg: ModelConfig, p: Mapping, x: torch.Tensor,
            positions: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The flash kernel's inputs for the sequence pass: q and k (B,S,H,dn+dr)
    with every head's K rebuilt from the latent, V zero-padded to dn + dr;
    and the latent and rope key (B,S,R), (B,S,dr) the cache keeps."""
    m = cfg.mla
    H = cfg.n_heads
    dn, dr = m.qk_nope_head_dim, m.qk_rope_head_dim
    B, S, _ = x.shape
    q_nope, q_rope = project_q(cfg, p, x, positions)
    ckv, kr = project_kv_latent(cfg, p, x, positions)
    kv = _up(ckv, p["w_ukv"].to(x.dtype))
    k_nope, v = kv[..., :dn], kv[..., dn:]
    q = torch.cat([q_nope, q_rope], -1)
    k = torch.cat([k_nope, kr[:, :, None, :].expand(B, S, H, dr)], -1)
    return q, k, v_pad(v, dn + dr), ckv, kr


def mla_self_attention(cfg: ModelConfig, p: Mapping, x: torch.Tensor,
                       positions: torch.Tensor, *,
                       lengths: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, Tuple[torch.Tensor,
                                                      torch.Tensor]]:
    """Training / prefill. Rebuilds every head's K/V from the latent and
    runs the flash kernel at head dim dn + dr (scale 1/sqrt(dn + dr)).
    Returns (y, (c_kv, k_rope)) for the caller's cache."""
    q, k, v, ckv, kr = mla_qkv(cfg, p, x, positions)
    o = flash_attention(q, k, v, causal=True, lengths=lengths)
    return _out(p, o[..., :cfg.mla.v_head_dim]), (ckv, kr)


def mla_decode_attention(cfg: ModelConfig, p: Mapping, x: torch.Tensor,
                         cache: Dict[str, torch.Tensor],
                         lengths: torch.Tensor, *, absorbed: bool = True
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step. x: (B, 1, D); cache = {"ckv": (B,S,R), "kr":
    (B,S,dr)}, written in place (the new rows in the cache's dtype) at
    ``lengths``, the tokens already cached. ``absorbed`` attends in the
    latent space; otherwise every head's K/V is rebuilt (the oracle)."""
    m = cfg.mla
    dn, dr = m.qk_nope_head_dim, m.qk_rope_head_dim
    dt = x.dtype
    sm_scale = 1.0 / math.sqrt(dn + dr)
    q_nope, q_rope = project_q(cfg, p, x, lengths[:, None])
    ckv_new, kr_new = project_kv_latent(cfg, p, x, lengths[:, None])
    w_ukv = p["w_ukv"].to(dt)
    w_uk, w_uv = w_ukv[..., :dn], w_ukv[..., dn:]          # (R,H,dn), (R,H,dv)

    if not absorbed:
        ckv = write_rows(cache["ckv"], ckv_new[:, 0], lengths)
        kr = write_rows(cache["kr"], kr_new[:, 0], lengths)
        kv = _up(ckv.to(dt), w_ukv)
        k_nope, v = kv[..., :dn], kv[..., dn:]
        q = torch.cat([q_nope, q_rope], -1)[:, 0]          # (B,H,dn+dr)
        k = torch.cat([k_nope, kr.to(dt)[:, :, None, :].expand(
            *k_nope.shape[:3], dr)], -1)
        s = torch.einsum("bhd,bshd->bhs", q.float(), k.float()) * sm_scale
        kpos = torch.arange(ckv.shape[1], device=x.device)
        s = torch.where(kpos[None, None, :] < (lengths + 1)[:, None, None],
                        s, NEG_INF)
        w = torch.softmax(s, -1)
        o = torch.einsum("bhs,bshd->bhd", w.to(dt).float(), v.float()).to(dt)
        return _out(p, o)[:, None], {"ckv": ckv, "kr": kr}

    # absorbed: q_lat = q_nope W_uk -> attention in the latent space
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0], w_uk)       # (B,H,R)
    ctx, ckv, kr = mla_decode_local(
        q_lat, q_rope[:, 0], cache["ckv"], cache["kr"], ckv_new[:, 0],
        kr_new[:, 0], lengths, sm_scale=sm_scale)
    o = torch.einsum("bhr,rhd->bhd", ctx.to(dt), w_uv)              # (B,H,dv)
    return _out(p, o)[:, None], {"ckv": ckv, "kr": kr}
