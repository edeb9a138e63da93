"""GQA attention: projections, RoPE, self-attention through the flash kernel,
and KV-cache decode, on one device or over a cache sharded along the
sequence (``parallel/decode_attn.py``), and self-attention with its heads
split over the mesh's ``model`` axis (:func:`tp_self_attention`). Port of
``repro/models/attention.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.gqa_decode import gqa_decode, gqa_decode_plain
from repro_torch.models.layers import (TP_AXIS, apply_rope, rms_head_norm,
                                       row_parallel)
from repro_torch.parallel.collectives import all_gather, pvary
from repro_torch.parallel.decode_attn import (sharded_decode_attention,
                                              write_rows)


def project_qkv(cfg: ModelConfig, p: Mapping, x: torch.Tensor,
                positions: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> q (B,S,H,HD), k/v (B,S,KV,HD), RoPE applied.

    k and v come out of the fused ``wkv`` product laid out (B,S,2,KV,HD);
    without RoPE or qk-norm they are strided views of it.
    """
    B, S, _ = x.shape
    H, KV, HD = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = x.dtype
    q = x @ p["wq"].to(dt)
    kv = x @ p["wkv"].to(dt)
    if "bq" in p:
        q = q + p["bq"].to(dt)
        kv = kv + p["bkv"].to(dt)
    q = q.reshape(B, S, H, HD)
    kv = kv.reshape(B, S, 2, KV, HD)
    k, v = kv[:, :, 0], kv[:, :, 1]
    if cfg.qk_norm:
        q = rms_head_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_head_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.pos_emb == "rope":
        q = apply_rope(q, positions, cfg)
        k = apply_rope(k, positions, cfg)
    return q, k, v


def output_proj(cfg: ModelConfig, p: Mapping, o: torch.Tensor) -> torch.Tensor:
    B, S = o.shape[:2]
    y = o.reshape(B, S, cfg.n_heads * cfg.head_dim) @ p["wo"].to(o.dtype)
    if "bo" in p:
        y = y + p["bo"].to(o.dtype)
    return y


def self_attention(cfg: ModelConfig, p: Mapping, x: torch.Tensor,
                   positions: torch.Tensor, *,
                   lengths: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Training / prefill self-attention through the flash kernel, with K/V
    at KV heads. Returns (output, (k, v)) for the caller's KV cache."""
    q, k, v = project_qkv(cfg, p, x, positions)
    o = flash_attention(q, k, v, causal=True, lengths=lengths)
    return output_proj(cfg, p, o), (k, v)


def tp_heads(cfg: ModelConfig, p: Mapping, mesh, axis: str = TP_AXIS,
             tp_split: FrozenSet[str] = frozenset()
             ) -> Tuple[ModelConfig, Dict[str, torch.Tensor]]:
    """This rank's heads over ``axis``: a config of its H / n query heads
    and the KV heads they read, and the parameters :func:`project_qkv`
    takes for them.

    ``wq``/``bq``/``wo`` hold the rank's heads as stored. Where the KV
    heads split over n, ``wkv``/``bkv`` hold the rank's [K | V] heads
    (stored grouped, ``params.grouped_columns``). Where n ranks share each
    KV head (n a multiple of KV), each rank gathers ``wkv`` where the plan
    splits it over ``axis`` (in ``tp_split``, ``params.tp_split``; the
    gather's backward sums the sharers' partial gradients) or else takes
    it whole through ``pvary``, and keeps its KV head's K and V columns.
    The qk-norm scales, the same on every rank, go through ``pvary``
    too."""
    n = mesh.size(mesh.live((axis,)))
    r = mesh.axis_index(mesh.live((axis,)))
    H, KV, HD = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if H % n or (KV % n and n % KV):
        raise NotImplementedError(
            f"{cfg.name}: {H} query and {KV} KV heads over {n} ranks")
    if p["wq"].shape[-1] * n != H * HD:
        raise ValueError(f"wq of {p['wq'].shape[-1]} columns is not this "
                         f"rank's {H // n} heads")
    local = dict(p)
    kv_loc = KV // n if KV % n == 0 else 1
    if KV % n:
        head = r // (n // KV)
        for k in ("wkv", "bkv"):
            if k not in p:
                continue
            w = (all_gather(p[k], axis, mesh, dim=-1) if k in tp_split
                 else pvary(p[k], axis, mesh))
            w = w.unflatten(-1, (2, KV, HD))[..., head:head + 1, :]
            local[k] = w.flatten(-3)
    for k in ("q_norm", "k_norm"):
        if k in p:
            local[k] = pvary(p[k], axis, mesh)
    return dataclasses.replace(cfg, n_heads=H // n, n_kv_heads=kv_loc), local


def tp_self_attention(cfg: ModelConfig, p: Mapping, x: torch.Tensor,
                      positions: torch.Tensor, *,
                      lengths: Optional[torch.Tensor] = None, mesh,
                      axis: str = TP_AXIS,
                      tp_split: FrozenSet[str] = frozenset()) -> torch.Tensor:
    """:func:`self_attention` with its heads split over ``axis``
    (:func:`tp_heads`): ``x`` the same on every rank, the flash kernel on
    this rank's heads, the output projection's partial sums added
    (``layers.row_parallel``), then ``bo``. Where the plan keeps the query
    heads whole (``wq`` not in ``tp_split``: heads that ``axis`` does not
    divide), every rank runs :func:`self_attention` on the whole
    leaves. Where it splits their columns but not whole heads (tacc-100m's
    12 query heads over 16 ranks, 48 columns each), every rank gathers
    the split leaves whole, used alike on every rank (``invariant``: each
    keeps its block of their gradient), and runs :func:`self_attention`
    on them."""
    if "wq" not in tp_split:
        return self_attention(cfg, p, x, positions, lengths=lengths)[0]
    n = mesh.size(mesh.live((axis,)))
    H, KV = cfg.n_heads, cfg.n_kv_heads
    if H % n or (KV % n and n % KV):
        whole = dict(p)
        for k in sorted(tp_split):      # one order on every rank
            whole[k] = all_gather(p[k], axis, mesh, dim=0 if k == "wo"
                                  else -1, invariant=True)
        return self_attention(cfg, whole, x, positions, lengths=lengths)[0]
    cfg_loc, local = tp_heads(cfg, p, mesh, axis, tp_split)
    q, k, v = project_qkv(cfg_loc, local, pvary(x, axis, mesh), positions)
    o = flash_attention(q, k, v, causal=True, lengths=lengths)
    y = row_parallel(o.flatten(2), p["wo"], mesh, axis)
    if "bo" in p:
        y = y + p["bo"].to(y.dtype)
    return y


# the plain math of the decode attention, the port of the reference's
# decode_attention_ref: the paged and sequence-sharded decodes, the tests and
# chip_smoke.py use it by this name
decode_attention_ref = gqa_decode_plain


def write_kv_cache(k_cache: torch.Tensor, v_cache: torch.Tensor,
                   k_new: torch.Tensor, v_new: torch.Tensor,
                   lengths: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write one new (k, v) per sequence at its current length, IN PLACE
    (the caches are returned for symmetry with the reference). k_new/v_new:
    (B, KV, HD); caches (B, S, KV, HD). A position past the end is clamped
    to the last slot, as ``dynamic_update_slice`` does."""
    return (write_rows(k_cache, k_new, lengths),
            write_rows(v_cache, v_new, lengths))


def decode_self_attention(cfg: ModelConfig, p: Mapping, x: torch.Tensor,
                          cache: Dict[str, torch.Tensor],
                          lengths: torch.Tensor, *,
                          seq_axes: Optional[Sequence[str]] = None,
                          batch_axes: Sequence[str] = (), mesh=None
                          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step. x: (B, 1, D). cache: {"k": (B,S,KV,HD), "v": ...},
    updated in place. ``lengths`` counts the tokens already in the cache:
    the new token goes at index lengths and attends to itself, through
    ``kernels/gqa_decode.py`` on one device. With ``seq_axes`` the cache is
    this rank's slice of the sequence over those axes of ``mesh``
    (``sharded_decode_attention``)."""
    q, k, v = project_qkv(cfg, p, x, lengths[:, None])
    q1, k1, v1 = q[:, 0], k[:, 0], v[:, 0]
    if seq_axes:
        o, kc, vc = sharded_decode_attention(
            q1, cache["k"], cache["v"], k1, v1, lengths, seq_axes=seq_axes,
            batch_axes=batch_axes, mesh=mesh)
    else:
        kc, vc = write_kv_cache(cache["k"], cache["v"], k1, v1, lengths)
        o = gqa_decode(q1, kc, vc, lengths + 1)
    return output_proj(cfg, p, o[:, None]), {"k": kc, "v": vc}
