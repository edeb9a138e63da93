"""Decode attention over a cache. Port of ``repro/parallel/decode_attn.py``:
the single-shard branch of ``sharded_mla_decode`` so far; the paged cache
(ROADMAP Queue 1, item 11) and the sequence-sharded branches (item 15)
extend this module.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.flash_attention import NEG_INF


def write_rows(cache: torch.Tensor, new: torch.Tensor,
               lengths: torch.Tensor) -> torch.Tensor:
    """Row lengths[b] of cache[b] (B, S, ...) set to new[b] in the cache's
    dtype, in place; a position past the end is clamped to the last row,
    as ``dynamic_update_slice`` does."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, lengths.clamp(0, cache.shape[1] - 1).long()] = \
        new.to(cache.dtype)
    return cache


def mla_decode_local(q_lat: torch.Tensor, q_rope: torch.Tensor,
                     ckv_cache: torch.Tensor, kr_cache: torch.Tensor,
                     ckv_new: torch.Tensor, kr_new: torch.Tensor,
                     lengths: torch.Tensor, *, sm_scale: float
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Absorbed MLA decode over one device's compressed cache.

    q_lat: (B, H, R), q_nope absorbed through W_uk into the latent space;
    q_rope: (B, H, DR); ckv_cache: (B, S, R); kr_cache: (B, S, DR), the rope
    key shared by the heads; ckv_new/kr_new: (B, R)/(B, DR), written in
    place, in the caches' dtype, at row ``lengths`` (clamped to the last).
    The scores are f32 from exact products of the operands (JAX's
    ``preferred_element_type=f32``); keys at or past lengths + 1 are
    masked with -1e30; the softmax weights are rounded to the cache's
    dtype before the f32 context sum. Returns (ctx (B, H, R) in q_lat's
    dtype, for the caller's W_uv, ckv_cache, kr_cache).
    """
    S = ckv_cache.shape[1]
    write_rows(ckv_cache, ckv_new, lengths)
    write_rows(kr_cache, kr_new, lengths)
    s = (torch.einsum("bhr,bsr->bhs", q_lat.float(), ckv_cache.float())
         + torch.einsum("bhd,bsd->bhs", q_rope.float(), kr_cache.float())
         ) * sm_scale
    kpos = torch.arange(S, device=ckv_cache.device)
    s = torch.where(kpos[None, None, :] < (lengths + 1)[:, None, None], s,
                    NEG_INF)
    w = torch.softmax(s, -1)
    ctx = torch.einsum("bhs,bsr->bhr", w.to(ckv_cache.dtype).float(),
                       ckv_cache.float())
    return ctx.to(q_lat.dtype), ckv_cache, kr_cache
