"""Mamba (S6) selective state-space mixer, used by the Jamba hybrid. Port
of ``repro/models/mamba.py``.

The sequence pass splits the sequence into ``n_chunks`` chunks; within a
chunk the linear recurrence ``h_t = a_t h_{t-1} + b_t`` is evaluated by a
log-depth (Hillis–Steele) scan over the reference's ``_assoc`` operator,
and the carry ``h`` threads the chunks in turn. A running product of
``a`` is never divided out: ``exp(dt A)`` reaches e^-21 and a product
underflows f32 within a few steps. Decode is one recurrent step over the
cached (conv, ssm) state. The recurrence runs in f32, the projections in
the activation dtype; the conv cache holds the last ``d_conv - 1``
pre-conv rows in bf16 and the state ``ssm`` is f32, as in the reference.

With ``want_cache`` the sequence pass also returns the prefill cache. The
reference scans the whole sequence a second time with identity steps past
each row's length (``mamba_prefill_cache``); here each row's state is read
from the sequence pass's own scan at ``lengths - 1`` (zeros for an empty
row), the same state without a second scan over the (B, S, d_inner,
d_state) operands.

Over a mesh (``mesh``; tensor parallelism over its ``model`` axis, as
GSPMD partitions the reference under ``DEFAULT_RULES``' ``dinner``), the
leaves are this rank's block of d_inner: ``w_in`` its [u | z] columns
(stored grouped, ``params.grouped_columns``), the conv, ``dt_b``,
``a_log``, ``d_skip`` and ``x_proj``'s rows its channels, ``dt_w`` their
columns, ``w_out`` their rows. The conv and the scan run on the rank's
channels, with its state (B, d_inner / n, d_state) and no collective in
the time loop. Two sums cross the ranks: ``x_proj``'s partial (dt_low, B,
C), summed in f32 before ``dt_w`` (:func:`_dt_bc`), and ``w_out``'s
(``layers.row_parallel``). A cache is the rank's block of d_inner.
"""
from __future__ import annotations

from typing import Dict, FrozenSet, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import TP_AXIS, row_parallel
from repro_torch.models.params import mamba_dims
from repro_torch.parallel.collectives import pvary

Cache = Dict[str, torch.Tensor]


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv in u's dtype, tap by tap as the reference sums
    it: zeros plus the bias, then ``pad[:, j:j + S] * w[:, j]`` for j = 0 ..
    dc - 1. u: (B, S, di); w: (di, dc)."""
    dc = w.shape[1]
    S = u.shape[1]
    pad = F.pad(u, (0, 0, dc - 1, 0))
    acc = torch.zeros_like(u) + b.to(u.dtype)
    for j in range(dc):
        acc = acc + pad[:, j:j + S, :] * w[:, j].to(u.dtype)
    return acc


def _dt_bc(uc: torch.Tensor, w: torch.Tensor, mesh, axis: str
           ) -> torch.Tensor:
    """``uc @ x_proj`` (dt_low, B, C) in f32 from the activation dtype's
    product. Over ``mesh`` each rank holds its channels' rows: the
    partials are summed in f32 and rounded once (``row_parallel``), and the
    sum, the same on every rank, enters each rank's channels (``pvary``)."""
    if mesh is None:
        return (uc @ w.to(uc.dtype)).float()
    return pvary(row_parallel(uc, w, mesh, axis).float(), axis, mesh)


def _ssm_inputs(cfg: ModelConfig, p: Mapping, uc: torch.Tensor, mesh=None,
                axis: str = TP_AXIS
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """uc: (B, S, di) post-conv activations (this rank's channels over
    ``mesh``) -> (dA, dBu (B, S, di, ds), C (B, S, ds)) in f32."""
    di, ds, dc, dtr = mamba_dims(cfg)
    dt_bc = _dt_bc(uc, p["x_proj"], mesh, axis)
    dt_r, Bm, Cm = dt_bc[..., :dtr], dt_bc[..., dtr:dtr + ds], \
        dt_bc[..., dtr + ds:]
    dt = F.softplus(dt_r @ p["dt_w"].float() + p["dt_b"].float())
    A = -torch.exp(p["a_log"].float())                          # (di, ds)
    dA = torch.exp(dt[..., None] * A)
    dBu = (dt * uc.float())[..., None] * Bm[:, :, None, :]
    return dA, dBu, Cm


def _scan(a: torch.Tensor, b: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of ``(a2 a1, a2 b1 + b2)`` (the reference's
    ``_assoc``) along axis 1, in log2(S) rounds: returns (the running
    product of a, h with h_0 = 0)."""
    S, d = a.shape[1], 1
    while d < S:
        a_prev, b_prev = a[:, :-d], b[:, :-d]
        a_cur, b_cur = a[:, d:], b[:, d:]
        a = torch.cat([a[:, :d], a_cur * a_prev], 1)
        b = torch.cat([b[:, :d], a_cur * b_prev + b_cur], 1)
        d *= 2
    return a, b


def n_chunks_for(S: int, n_chunks: int) -> int:
    """The reference's chunk count: at most ``n_chunks`` and S, shrunk
    until it divides S."""
    n = max(1, min(n_chunks, S))
    while S % n:
        n -= 1
    return n


def gather_window(u: torch.Tensor, lengths: torch.Tensor, w: int
                  ) -> torch.Tensor:
    """The last ``w`` valid rows of each sequence, u[b, lengths[b] - w :
    lengths[b]], zero-padded on the left for short prompts. u: (B, S, di)
    -> (B, w, di)."""
    B, S, di = u.shape
    idx = lengths.long()[:, None] - w + torch.arange(w, device=u.device)
    g = torch.gather(u, 1, idx.clamp(0, S - 1)[:, :, None].expand(B, w, di))
    zero = torch.zeros((), dtype=u.dtype, device=u.device)
    return torch.where((idx >= 0)[:, :, None], g, zero)


def mamba_mixer(cfg: ModelConfig, p: Mapping, x: torch.Tensor,
                positions: Optional[torch.Tensor] = None, *,
                lengths: Optional[torch.Tensor] = None,
                want_cache: bool = False, n_chunks: int = 8, mesh=None,
                axis: str = TP_AXIS
                ) -> Tuple[torch.Tensor, Optional[Cache]]:
    """The sequence pass (train / prefill). x: (B, S, D), the same on every
    rank over ``mesh``, where ``p`` is this rank's block (module
    docstring). Returns (y, the prefill cache after ``lengths`` tokens (all
    S without) or None)."""
    _, ds, dc, _ = mamba_dims(cfg)
    B, S, _ = x.shape
    dt = x.dtype
    if mesh is not None:
        x = pvary(x, axis, mesh)
    u, z = (x @ p["w_in"].to(dt)).chunk(2, -1)
    di = u.shape[-1]
    uc = F.silu(_causal_conv(u, p["conv_w"], p["conv_b"]))
    n = n_chunks_for(S, n_chunks)
    c = S // n
    h0 = torch.zeros(B, di, ds, dtype=torch.float32, device=x.device)
    if want_cache:
        last = (lengths.long() if lengths is not None else
                torch.full((B,), S, device=x.device)) - 1
        rows = torch.arange(B, device=x.device)
        ssm = torch.zeros_like(h0)
    ys = []
    for i in range(n):
        dA, dBu, Cm = _ssm_inputs(cfg, p, uc[:, i * c:(i + 1) * c], mesh,
                                  axis)
        cumA, h = _scan(dA, dBu)
        h = h + cumA * h0[:, None]
        h0 = h[:, -1]
        if want_cache:
            at = last - i * c                     # the row's last step here
            inside = (at >= 0) & (at < c)
            ssm = torch.where(inside[:, None, None],
                              h[rows, at.clamp(0, c - 1)], ssm)
        ys.append(torch.einsum("bsdn,bsn->bsd", h, Cm).to(dt))
    y = torch.cat(ys, 1) if len(ys) > 1 else ys[0]
    y = y + uc * p["d_skip"].to(dt)
    y = _out(y * F.silu(z), p["w_out"], mesh, axis)
    if not want_cache:
        return y, None
    return y, {"conv": gather_window(u, last + 1, dc - 1).to(torch.bfloat16),
               "ssm": ssm}


def _out(h: torch.Tensor, w: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``h @ w_out``; over ``mesh`` the partials of the rank's channels
    summed (``row_parallel``)."""
    if mesh is None:
        return h @ w.to(h.dtype)
    return row_parallel(h, w, mesh, axis)


def tp_mamba_mixer(cfg: ModelConfig, p: Mapping, x: torch.Tensor,
                   positions: Optional[torch.Tensor] = None, *,
                   lengths: Optional[torch.Tensor] = None, mesh,
                   axis: str = TP_AXIS,
                   tp_split: FrozenSet[str] = frozenset()) -> torch.Tensor:
    """The training plan's sequence pass: tensor-parallel over ``axis``
    where the plan splits d_inner (``w_in`` in ``tp_split``), else on the
    whole leaves, which every rank holds (d_inner that ``axis`` does not
    divide)."""
    return mamba_mixer(cfg, p, x, lengths=lengths, axis=axis,
                       mesh=mesh if "w_in" in tp_split else None)[0]


def mamba_prefill_cache(cfg: ModelConfig, p: Mapping, x: torch.Tensor,
                        lengths: torch.Tensor) -> Cache:
    """The (conv, ssm) state after ``lengths`` tokens of x (the reference's
    function; the model takes it from :func:`mamba_mixer`'s pass)."""
    return mamba_mixer(cfg, p, x, lengths=lengths, want_cache=True)[1]


def mamba_init_cache(cfg: ModelConfig, batch: int, device: torch.device
                     ) -> Cache:
    di, ds, dc, _ = mamba_dims(cfg)
    return {"conv": torch.zeros(batch, dc - 1, di, dtype=torch.bfloat16,
                                device=device),
            "ssm": torch.zeros(batch, di, ds, dtype=torch.float32,
                               device=device)}


def mamba_decode(cfg: ModelConfig, p: Mapping, x: torch.Tensor, cache: Cache,
                 lengths: Optional[torch.Tensor] = None, *, mesh=None,
                 axis: str = TP_AXIS) -> Tuple[torch.Tensor, Cache]:
    """One token. x: (B, 1, D); cache: {conv (B, dc-1, di) bf16, ssm (B, di,
    ds) f32}, this rank's block of d_inner over ``mesh`` (as ``p``). The
    window's conv is one product plus the bias, as the reference's decode
    sums it. Returns (y (B, 1, D), the new cache)."""
    dt = x.dtype
    if mesh is not None:
        x = pvary(x, axis, mesh)
    u, z = (x[:, 0] @ p["w_in"].to(dt)).chunk(2, -1)            # (B, di)
    window = torch.cat([cache["conv"].to(dt), u[:, None]], 1)    # (B, dc, di)
    uc = F.silu(torch.einsum("bcd,dc->bd", window, p["conv_w"].to(dt))
                + p["conv_b"].to(dt))
    dA, dBu, Cm = _ssm_inputs(cfg, p, uc[:, None], mesh, axis)
    h = dA[:, 0] * cache["ssm"] + dBu[:, 0]                     # (B, di, ds)
    y = torch.einsum("bdn,bn->bd", h, Cm[:, 0]).to(dt)
    y = y + uc * p["d_skip"].to(dt)
    y = _out(y * F.silu(z), p["w_out"], mesh, axis)[:, None]
    return y, {"conv": window[:, 1:].to(torch.bfloat16), "ssm": h}
