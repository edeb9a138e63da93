"""GQA attention: projections, RoPE, self-attention through the flash kernel,
and KV-cache decode. Port of ``repro/models/attention.py`` (single-device
path; the sequence-sharded decode waits for ROADMAP Queue 1, item 15).
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import NEG_INF, flash_attention
from repro_torch.models.layers import apply_rope, rms_head_norm
from repro_torch.parallel.decode_attn import write_rows


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
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
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


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, lengths: torch.Tensor
                         ) -> torch.Tensor:
    """q: (B,H,HD); caches: (B,S,KV,HD); lengths (B,) = #valid positions
    (including the token just written). Grouped GQA, full softmax."""
    B, H, HD = q.shape
    KV = k_cache.shape[2]
    qg = q.reshape(B, KV, H // KV, HD).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float()) / math.sqrt(HD)
    kpos = torch.arange(k_cache.shape[1], device=q.device)
    s = torch.where(kpos[None, None, None, :] < lengths[:, None, None, None],
                    s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", w.to(v_cache.dtype).float(),
                     v_cache.float())
    return o.reshape(B, H, HD).to(q.dtype)


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
                          lengths: torch.Tensor
                          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step. x: (B, 1, D). cache: {"k": (B,S,KV,HD), "v": ...},
    updated in place. ``lengths`` counts the tokens already in the cache:
    the new token goes at index lengths and attends to itself."""
    q, k, v = project_qkv(cfg, p, x, lengths[:, None])
    kc, vc = write_kv_cache(cache["k"], cache["v"], k[:, 0], v[:, 0], lengths)
    o = decode_attention_ref(q[:, 0], kc, vc, lengths + 1)
    return output_proj(cfg, p, o[:, None]), {"k": kc, "v": vc}
