"""Decode attention over a cache. Port of ``repro/parallel/decode_attn.py``:
the sequence-sharded decode of GQA (``sharded_decode_attention``) and of
MLA's latent cache (``sharded_mla_decode``, whose single-shard branch is
``mla_decode_local``), and the paged decode path (``PagedKVCache``,
``paged_write_kv``, ``gather_paged_kv``, ``paged_decode_attention``).

Sharded decode is flash-decoding across ranks: each rank holds its
contiguous slice of the cache along the sequence (``parallel/sharding.py``),
writes the new row only where it lands in that slice, and computes a partial
softmax over it; the partials combine with one ``pmax`` and two ``psum``s of
(B, H)-sized tensors (``parallel/collectives.py``) instead of gathering the
cache. The caller passes this rank's blocks; on a degenerate mesh (no
sequence axis of more than one rank) the single-shard branch runs on the
whole cache.

The paged cache keeps K/V in a shared pool of fixed-size pages indexed
through per-sequence block tables. Attention gathers each sequence's pages
into a contiguous (B, S, KV, HD) cache and runs the dense
``decode_attention_ref`` on it, so paged and dense caches give bit-equal
outputs for equal contents; stale rows past ``lengths`` are masked.
"""
from __future__ import annotations

import math
from typing import Dict, Hashable, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.flash_attention import NEG_INF
from repro_torch.parallel.collectives import pmax, psum


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


def _seq_plan(seq_axes, batch_axes, mesh):
    """The live sequence axes (None on a degenerate mesh) and batch axes,
    as the reference filters them; a sequence axis needs a mesh."""
    if not seq_axes:
        return None, ()
    if mesh is None:
        raise ValueError("sharded decode attention needs a mesh (mesh=)")
    return mesh.live(seq_axes) or None, mesh.live(batch_axes)


def local_write(cache: torch.Tensor, new: torch.Tensor,
                lengths: torch.Tensor, offset: int) -> torch.Tensor:
    """Write each row's ``new`` into this rank's slice ``cache`` (B, S_loc,
    ...), in place, where its position ``lengths`` lands in the slice that
    starts at ``offset``; rows whose position lies elsewhere are left as
    they are (the reference's ``_local_write``, one cache at a time)."""
    S_loc = cache.shape[1]
    idx = lengths.long() - offset
    ok = (idx >= 0) & (idx < S_loc)
    rows = torch.arange(cache.shape[0], device=cache.device)
    at = idx.clamp(0, S_loc - 1)
    cache[rows, at] = torch.where(
        ok.view(-1, *([1] * (new.dim() - 1))), new.to(cache.dtype),
        cache[rows, at])
    return cache


def _combine(s: torch.Tensor, ctx_of, seq_axes, mesh):
    """Flash-decoding's merge over ranks: scores ``s`` (..., S_loc), f32,
    masked; ``ctx_of(p)`` the f32 context of weights ``p``. Returns the
    context over the whole sequence, f32."""
    m = pmax(s.amax(-1), seq_axes, mesh)
    p = torch.exp(s - m[..., None])
    l = psum(p.sum(-1), seq_axes, mesh)
    o = psum(ctx_of(p), seq_axes, mesh)
    return o / l[..., None].clamp_min(1e-30)


def sharded_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor, k_new: torch.Tensor,
                             v_new: torch.Tensor, lengths: torch.Tensor, *,
                             seq_axes: Sequence[str] = ("model",),
                             batch_axes: Sequence[str] = ("data",),
                             mesh=None
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """q: (B, H, HD); caches: (B, S_loc, KV, HD), this rank's slice of the
    sequence (the whole cache on a degenerate mesh); k_new/v_new: (B, KV,
    HD); lengths: (B,) tokens already cached (the new token is appended and
    attends to itself). B is this rank's block of the batch over
    ``batch_axes``. The caches are written in place.

    Returns (o (B, H, HD), k_cache, v_cache).
    """
    from repro_torch.models.attention import (decode_attention_ref,
                                              write_kv_cache)
    seq_axes, batch_axes = _seq_plan(seq_axes, batch_axes, mesh)
    if seq_axes is None:
        kc, vc = write_kv_cache(k_cache, v_cache, k_new, v_new, lengths)
        return decode_attention_ref(q, kc, vc, lengths + 1), kc, vc
    B, H, HD = q.shape
    S_loc, KV = k_cache.shape[1], k_cache.shape[2]
    offset = mesh.axis_index(seq_axes) * S_loc
    local_write(k_cache, k_new, lengths, offset)
    local_write(v_cache, v_new, lengths, offset)
    qg = q.reshape(B, KV, H // KV, HD).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float()) \
        * (1.0 / math.sqrt(HD))
    kpos = offset + torch.arange(S_loc, device=q.device)
    s = torch.where(kpos[None, None, None, :]
                    < (lengths + 1)[:, None, None, None], s, NEG_INF)
    o = _combine(s, lambda p: torch.einsum(
        "bkgs,bskd->bkgd", p.to(v_cache.dtype).float(), v_cache.float()),
        seq_axes, mesh)
    return o.reshape(B, H, HD).to(q.dtype), k_cache, v_cache


def sharded_mla_decode(q_lat: torch.Tensor, q_rope: torch.Tensor,
                       ckv_cache: torch.Tensor, kr_cache: torch.Tensor,
                       ckv_new: torch.Tensor, kr_new: torch.Tensor,
                       lengths: torch.Tensor, *, sm_scale: float,
                       seq_axes: Sequence[str] = ("model",),
                       batch_axes: Sequence[str] = ("data",),
                       mesh=None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Absorbed MLA decode over a sequence-sharded compressed cache.

    q_lat: (B, H, R); q_rope: (B, H, DR); ckv_cache: (B, S_loc, R) and
    kr_cache: (B, S_loc, DR), this rank's slice (the whole cache on a
    degenerate mesh, where :func:`mla_decode_local` runs); ckv_new/kr_new
    written in place where they land in the slice. Returns (ctx (B, H, R)
    in q_lat's dtype, for the caller's W_uv, ckv_cache, kr_cache).
    """
    seq_axes, _ = _seq_plan(seq_axes, batch_axes, mesh)
    if seq_axes is None:
        return mla_decode_local(q_lat, q_rope, ckv_cache, kr_cache, ckv_new,
                                kr_new, lengths, sm_scale=sm_scale)
    S_loc = ckv_cache.shape[1]
    offset = mesh.axis_index(seq_axes) * S_loc
    local_write(ckv_cache, ckv_new, lengths, offset)
    local_write(kr_cache, kr_new, lengths, offset)
    s = (torch.einsum("bhr,bsr->bhs", q_lat.float(), ckv_cache.float())
         + torch.einsum("bhd,bsd->bhs", q_rope.float(), kr_cache.float())
         ) * sm_scale
    kpos = offset + torch.arange(S_loc, device=q_lat.device)
    s = torch.where(kpos[None, None, :] < (lengths + 1)[:, None, None], s,
                    NEG_INF)
    ctx = _combine(s, lambda p: torch.einsum(
        "bhs,bsr->bhr", p.to(ckv_cache.dtype).float(), ckv_cache.float()),
        seq_axes, mesh)
    return ctx.to(q_lat.dtype), ckv_cache, kr_cache


# ---------------------------------------------------------------------------
# Paged KV cache (block-table indexing for uneven-length decode batches)
# ---------------------------------------------------------------------------

def gather_paged_kv(k_pages: torch.Tensor, v_pages: torch.Tensor,
                    block_tables: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Materialize each sequence's pages as a contiguous (B, S, KV, HD)
    cache. k_pages/v_pages: (num_pages, page, KV, HD) shared pool;
    block_tables: (B, pages_per_seq) int page ids. S = pages_per_seq*page.
    """
    B, n = block_tables.shape
    page, KV, HD = k_pages.shape[1:]
    idx = block_tables.long()
    k = k_pages[idx].reshape(B, n * page, KV, HD)
    v = v_pages[idx].reshape(B, n * page, KV, HD)
    return k, v


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """Grouped-GQA decode attention over a paged cache.

    q: (B, H, HD); lengths: (B,) valid tokens per sequence. Gathers the
    block-table view and runs the dense ``decode_attention_ref``, so paged
    and dense caches give bit-equal outputs for equal contents; stale rows
    in pages beyond ``lengths`` are masked before the softmax.
    """
    from repro_torch.models.attention import decode_attention_ref
    k, v = gather_paged_kv(k_pages, v_pages, block_tables)
    return decode_attention_ref(q, k, v, lengths)


def paged_write_kv(k_pages: torch.Tensor, v_pages: torch.Tensor,
                   k_new: torch.Tensor, v_new: torch.Tensor,
                   block_tables: torch.Tensor, lengths: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Append one token per sequence at logical position ``lengths[b]``,
    IN PLACE, in the pool's dtype (the pools are returned for symmetry
    with the reference).

    k_new/v_new: (B, KV, HD). The write lands in page
    ``block_tables[b, lengths[b] // page]`` at slot ``lengths[b] % page``;
    positions at or beyond capacity clamp to the last slot.
    """
    page = k_pages.shape[1]
    capacity = block_tables.shape[1] * page
    pos = lengths.long().clamp(0, capacity - 1)
    page_idx = torch.gather(block_tables.long(), 1,
                            (pos // page)[:, None])[:, 0]
    slot = pos % page
    k_pages[page_idx, slot] = k_new.to(k_pages.dtype)
    v_pages[page_idx, slot] = v_new.to(v_pages.dtype)
    return k_pages, v_pages


class PagedKVCache:
    """Host-side page pool + block tables for the serve engine's slots.

    Page accounting is deterministic: the free list hands out the
    lowest-numbered pages first and released pages return in reverse order
    (LIFO), so replaying the same admit/retire sequence reproduces the
    same block tables. The pools live on ``device`` (the card by default);
    the block-table rows stay host-side int32 numpy arrays.
    """

    def __init__(self, *, num_pages: int, page_size: int, num_kv_heads: int,
                 head_dim: int, pages_per_seq: int,
                 dtype: torch.dtype = torch.float32,
                 device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self.page_size = int(page_size)
        self.pages_per_seq = int(pages_per_seq)
        self.k_pages = torch.zeros((num_pages, page_size, num_kv_heads,
                                    head_dim), dtype=dtype, device=self.device)
        self.v_pages = torch.zeros_like(self.k_pages)
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self.tables: Dict[Hashable, np.ndarray] = {}

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def reserve(self, seq: Hashable) -> np.ndarray:
        """Claim ``pages_per_seq`` pages for a new sequence; returns its
        block-table row (int32)."""
        if seq in self.tables:
            raise ValueError(f"sequence {seq!r} already has pages")
        if len(self._free) < self.pages_per_seq:
            raise RuntimeError(
                f"page pool exhausted ({len(self._free)} free, "
                f"{self.pages_per_seq} needed)")
        row = np.array([self._free.pop()
                        for _ in range(self.pages_per_seq)], np.int32)
        self.tables[seq] = row
        return row

    def release(self, seq: Hashable) -> None:
        """Return a retired sequence's pages to the pool (its cache bytes
        stay in place and are masked/overwritten on reuse)."""
        row = self.tables.pop(seq)
        self._free.extend(int(p) for p in reversed(row))

    def block_tables(self, seqs: Sequence[Hashable]) -> torch.Tensor:
        """Stack the block-table rows for a decode batch, in batch order,
        on the cache's device."""
        return torch.from_numpy(np.stack([self.tables[s] for s in seqs])).to(
            self.device)

    def append(self, seqs: Sequence[Hashable], k_new: torch.Tensor,
               v_new: torch.Tensor, lengths: torch.Tensor) -> None:
        """Write one new token per batched sequence into the pool."""
        paged_write_kv(self.k_pages, self.v_pages, k_new, v_new,
                       self.block_tables(seqs), lengths)

    def attend(self, seqs: Sequence[Hashable], q: torch.Tensor,
               lengths: torch.Tensor) -> torch.Tensor:
        """Decode attention for a batch of resident sequences."""
        return paged_decode_attention(q, self.k_pages, self.v_pages,
                                      self.block_tables(seqs), lengths)
