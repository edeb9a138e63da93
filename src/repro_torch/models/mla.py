"""Multi-head Latent Attention (DeepSeek-V2). Port of
``repro/models/mla.py``.

Prefill caches only the compressed latent ``c_kv`` (kv_lora_rank) and the
shared rope key (qk_rope_head_dim) per token. The sequence pass rebuilds
every head's K and V from the latent and runs the flash kernel at the q/k
head dim ``dn + dr`` (192 at full width), with V zero-padded to it
(:func:`v_pad`) and the output cut back to ``dv``. Decode uses the
*absorbed* form: W_uk is folded into the query and W_uv into the output,
so attention runs in the latent space (``parallel/decode_attn.py``), on
one device or over a latent cache sharded along the sequence; the naive
form, which rebuilds every head's K and V, is kept as its oracle.
The latent norms are RMSNorms through the rmsnorm kernel. A config with
YaRN (``rope_scaling`` "yarn", DeepSeek-V2's long-context RoPE) rotates
the rope dims at YaRN's frequencies (``layers.apply_rope``) and scores
at :func:`softmax_scale` in every path. Under a profiler each layer's
sequence pass is an ``mla.sequence`` span and each decode attention, its
cache write included, an ``mla.decode`` span (``repro_torch.spans``).

Over a mesh (``mesh``; tensor parallelism over its ``model`` axis, as
GSPMD partitions the reference's ``heads``), the sequence pass runs on
this rank's H / n heads: ``w_uq`` (or ``w_q``), ``w_ukv`` and ``w_o``
hold them, while the latent projections ``w_dq``, ``w_dkv``, ``w_kr`` and
the norms are whole on every rank (``lora`` maps to no mesh axis). The
latents are computed alike on every rank and enter its heads through
``pvary``; the flash kernel and its backward run on the rank's heads, and
``w_o``'s partials are summed (``layers.row_parallel``).
"""
from __future__ import annotations

import math
from typing import Dict, FrozenSet, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import NEG_INF, flash_attention
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.models.layers import (TP_AXIS, apply_rope, row_parallel,
                                       yarn_mscale)
from repro_torch.parallel.collectives import pvary
from repro_torch.parallel.decode_attn import sharded_mla_decode, write_rows
from repro_torch.spans import span


def _up(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., R) times w (R, H, d) -> (..., H, d): one product."""
    R, H, d = w.shape
    return (x @ w.reshape(R, H * d)).reshape(*x.shape[:-1], H, d)


def _vary(mesh, axis: str):
    """``pvary`` over ``axis`` of ``mesh``, or the identity without one."""
    if mesh is None:
        return lambda t: t
    return lambda t: pvary(t, axis, mesh)


def project_q(cfg: ModelConfig, p: Mapping, x: torch.Tensor,
              positions: torch.Tensor, mesh=None, axis: str = TP_AXIS
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (q_nope (B,S,H,dn), q_rope (B,S,H,dr), RoPE applied);
    over ``mesh`` H is this rank's heads."""
    m = cfg.mla
    dn = m.qk_nope_head_dim
    dt = x.dtype
    vary = _vary(mesh, axis)
    if "w_dq" in p:
        cq = rmsnorm(x @ p["w_dq"].to(dt), p["q_norm"], cfg.norm_eps)
        q = _up(vary(cq), p["w_uq"].to(dt))
    else:
        q = _up(vary(x), p["w_q"].to(dt))
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    return q_nope, apply_rope(q_rope, positions, cfg)


def project_kv_latent(cfg: ModelConfig, p: Mapping, x: torch.Tensor,
                      positions: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (c_kv (B,S,R) normed, the shared rope key (B,S,dr))."""
    dt = x.dtype
    ckv = rmsnorm(x @ p["w_dkv"].to(dt), p["kv_norm"], cfg.norm_eps)
    kr = x @ p["w_kr"].to(dt)
    kr = apply_rope(kr[:, :, None, :], positions, cfg)[:, :, 0]
    return ckv, kr


def softmax_scale(cfg: ModelConfig) -> float:
    """1/sqrt(dn + dr), times YaRN's mscale(yarn_mscale_all_dim) squared
    where the config scales RoPE by YaRN (DeepSeek-V2's attention)."""
    m = cfg.mla
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    if cfg.rope_scaling == "yarn":
        scale *= yarn_mscale(cfg.rope_factor, cfg.yarn_mscale_all_dim) ** 2
    return scale


def v_pad(v: torch.Tensor, d: int) -> torch.Tensor:
    """Pad the value head dim up to the q/k head dim for the shared flash
    path."""
    if v.shape[-1] == d:
        return v
    return torch.nn.functional.pad(v, (0, d - v.shape[-1]))


def _out(p: Mapping, o: torch.Tensor, mesh=None,
         axis: str = TP_AXIS) -> torch.Tensor:
    """o (..., H, dv) through w_o (H, dv, D); over ``mesh`` the partials of
    this rank's heads summed."""
    H, dv, D = p["w_o"].shape
    o = o.reshape(*o.shape[:-2], H * dv)
    w = p["w_o"].reshape(H * dv, D)
    if mesh is not None:
        return row_parallel(o, w, mesh, axis)
    return o @ w.to(o.dtype)


def mla_qkv(cfg: ModelConfig, p: Mapping, x: torch.Tensor,
            positions: torch.Tensor, mesh=None, axis: str = TP_AXIS
            ) -> Tuple[torch.Tensor, ...]:
    """The flash kernel's inputs for the sequence pass: q and k (B,S,H,dn+dr)
    with every head's K rebuilt from the latent, V zero-padded to dn + dr;
    and the latent and rope key (B,S,R), (B,S,dr) the cache keeps. Over
    ``mesh`` H is this rank's heads, the latents the same on every rank."""
    m = cfg.mla
    dn, dr = m.qk_nope_head_dim, m.qk_rope_head_dim
    B, S, _ = x.shape
    vary = _vary(mesh, axis)
    q_nope, q_rope = project_q(cfg, p, x, positions, mesh, axis)
    ckv, kr = project_kv_latent(cfg, p, x, positions)
    H = p["w_ukv"].shape[1]
    kv = _up(vary(ckv), p["w_ukv"].to(x.dtype))
    k_nope, v = kv[..., :dn], kv[..., dn:]
    q = torch.cat([q_nope, q_rope], -1)
    k = torch.cat([k_nope, vary(kr)[:, :, None, :].expand(B, S, H, dr)], -1)
    return q, k, v_pad(v, dn + dr), ckv, kr


def mla_self_attention(cfg: ModelConfig, p: Mapping, x: torch.Tensor,
                       positions: torch.Tensor, *,
                       lengths: Optional[torch.Tensor] = None, mesh=None,
                       axis: str = TP_AXIS
                       ) -> Tuple[torch.Tensor, Tuple[torch.Tensor,
                                                      torch.Tensor]]:
    """Training / prefill. Rebuilds every head's K/V from the latent and
    runs the flash kernel at head dim dn + dr (at :func:`softmax_scale`),
    on this rank's heads over ``mesh`` (module docstring), inside an
    ``mla.sequence`` span. Returns (y, (c_kv, k_rope)) for the caller's
    cache."""
    with span("mla.sequence"):
        q, k, v, ckv, kr = mla_qkv(cfg, p, x, positions, mesh, axis)
        o = flash_attention(q, k, v, causal=True, lengths=lengths,
                            scale=softmax_scale(cfg))
        return _out(p, o[..., :cfg.mla.v_head_dim], mesh, axis), (ckv, kr)


def tp_mla_self_attention(cfg: ModelConfig, p: Mapping, x: torch.Tensor,
                          positions: torch.Tensor, *,
                          lengths: Optional[torch.Tensor] = None, mesh,
                          axis: str = TP_AXIS,
                          tp_split: FrozenSet[str] = frozenset()
                          ) -> torch.Tensor:
    """The training plan's sequence pass: on this rank's heads where the
    plan splits them over ``axis`` (``w_ukv`` in ``tp_split``), else on
    the whole leaves (heads that ``axis`` does not divide)."""
    return mla_self_attention(
        cfg, p, x, positions, lengths=lengths, axis=axis,
        mesh=mesh if "w_ukv" in tp_split else None)[0]


def mla_decode_attention(cfg: ModelConfig, p: Mapping, x: torch.Tensor,
                         cache: Dict[str, torch.Tensor],
                         lengths: torch.Tensor, *,
                         seq_axes: Optional[Sequence[str]] = None,
                         batch_axes: Sequence[str] = ("data",),
                         absorbed: bool = True, mesh=None
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step. x: (B, 1, D); cache = {"ckv": (B,S,R), "kr":
    (B,S,dr)}, written in place (the new rows in the cache's dtype) at
    ``lengths``, the tokens already cached. ``absorbed`` attends in the
    latent space, over this rank's slice of the sequence when ``seq_axes``
    of ``mesh`` split it (``sharded_mla_decode``); otherwise every head's
    K/V is rebuilt from a whole cache (the oracle). Both score at
    :func:`softmax_scale`, inside an ``mla.decode`` span that holds the
    cache write."""
    with span("mla.decode"):
        return _decode(cfg, p, x, cache, lengths, seq_axes, batch_axes,
                       absorbed, mesh)


def _decode(cfg, p, x, cache, lengths, seq_axes, batch_axes, absorbed, mesh):
    m = cfg.mla
    dn, dr = m.qk_nope_head_dim, m.qk_rope_head_dim
    dt = x.dtype
    sm_scale = softmax_scale(cfg)
    q_nope, q_rope = project_q(cfg, p, x, lengths[:, None])
    ckv_new, kr_new = project_kv_latent(cfg, p, x, lengths[:, None])
    w_ukv = p["w_ukv"].to(dt)
    w_uk, w_uv = w_ukv[..., :dn], w_ukv[..., dn:]          # (R,H,dn), (R,H,dv)

    if not absorbed:
        if seq_axes and mesh is not None and mesh.live(seq_axes):
            raise ValueError("the naive MLA decode needs the whole cache; "
                             "a sequence-sharded one decodes absorbed")
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
    ctx, ckv, kr = sharded_mla_decode(
        q_lat, q_rope[:, 0], cache["ckv"], cache["kr"], ckv_new[:, 0],
        kr_new[:, 0], lengths, sm_scale=sm_scale, seq_axes=seq_axes or (),
        batch_axes=batch_axes, mesh=mesh)
    o = torch.einsum("bhr,rhd->bhd", ctx.to(dt), w_uv)              # (B,H,dv)
    return _out(p, o)[:, None], {"ckv": ckv, "kr": kr}
