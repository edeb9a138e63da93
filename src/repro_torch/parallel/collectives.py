"""Collectives over named mesh axes: the port's counterparts of ``psum``,
``pmax``, ``psum_scatter(tiled=True)``, ``all_to_all(tiled=True)`` and
``all_gather(tiled=True)`` inside a ``shard_map`` (``jax.lax.axis_index``
is ``Mesh.axis_index``), each with its gradient.

Each runs in the mesh's process group over its axes
(``launch/mesh.py``); axes of size 1 are dropped, and over none the
collective is the identity, as JAX's is on a degenerate mesh. Under
``gloo`` every CUDA buffer is moved to the host, reduced or exchanged there,
and moved back: gloo is the backend of ranks that share one card (NCCL
refuses two ranks on one device), and its documented support for CUDA
tensors lists broadcast and all_reduce only, so this module stages by
design, not after a failure. Under
``nccl`` nothing is staged. Under gloo a reduction is one ``all_to_all``
and a local sum (``_reduce``), a reduce-scatter one ``all_to_all`` of the
blocks and a sum of what came back, in the ranks' order.

Gradients follow JAX's typing of values over an axis as the same on every
rank (invariant) or each rank's own (varying), Megatron's conjugate pair
for tensor parallelism: :func:`psum` takes varying values to an invariant
sum and its backward is the identity; :func:`pvary` is the identity from
an invariant value into a computation that varies over the axes, and its
backward is a psum; :func:`all_gather` and :func:`psum_scatter` are each
other's transpose, as :func:`all_to_all` is its own; and
``all_gather(..., invariant=True)`` gathers a result used alike on every
rank, so its backward takes this rank's block (``all_gather_invariant``).
:func:`pmax` carries no gradient (its one use is a shift that cancels).

``STATS`` counts what the module ran, forward and backward: ``collectives``,
the ``bytes`` each rank sent, and the ``staged_bytes`` copied to the host
and back.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist

STATS: Dict[str, int] = {"collectives": 0, "bytes": 0, "staged_bytes": 0}


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = 0


def stages(backend, device: torch.device) -> bool:
    """Whether a buffer on ``device`` goes through the host under
    ``backend``: only a CUDA buffer under gloo."""
    return backend == "gloo" and torch.device(device).type == "cuda"


def _axes(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _exchange(mesh, t: torch.Tensor, out_numel: int, run, copies: int = 1
              ) -> torch.Tensor:
    """``run(buffer, out)`` on ``copies`` copies of ``t`` stacked along a
    new dim 0 (``t`` itself when 1; staged to the host under gloo), into a
    new tensor of ``out_numel`` elements on ``t``'s device. Staging copies
    through pinned host buffers (PyTorch's caching host allocator), one
    DMA a copy, so the copies take no room on the card; the stream is
    synchronised once, before gloo reads the buffer."""
    staged = stages(mesh.backend, t.device)
    src = t.detach()
    if staged:
        buf = torch.empty((copies,) + tuple(t.shape), dtype=t.dtype,
                          pin_memory=True)
        for c in range(copies):
            buf[c].copy_(src, non_blocking=True)
        torch.cuda.current_stream(t.device).synchronize()
        out = torch.empty(out_numel, dtype=t.dtype, pin_memory=True)
    else:
        buf = (src.contiguous() if copies == 1
               else src.expand(copies, *t.shape).contiguous())
        out = torch.empty(out_numel, dtype=t.dtype, device=t.device)
    run(buf, out)
    STATS["collectives"] += 1
    STATS["bytes"] += buf.numel() * buf.element_size()
    if staged:
        STATS["staged_bytes"] += (buf.numel() + out.numel()) \
            * buf.element_size()
        out = out.to(t.device, non_blocking=True)
    return out


# under gloo a reduction sends n copies of its buffer and gets n back; a
# buffer of more elements goes in pieces of this many, so that a rank never
# holds n copies of a whole one (deepseek-v2's vocab blocks of `tok` and
# `unembed` are 2.1 GB of f32 gradient a rank, which 4 ranks on one card
# cannot each hold five times)
REDUCE_PIECE = 1 << 25


def _reduce(t: torch.Tensor, axes, mesh, op, inplace: bool = False
            ) -> torch.Tensor:
    """All-reduce over ``axes``, into ``t`` itself when ``inplace`` (``t``
    contiguous). Under gloo, one ``all_to_all`` of n copies and a sum (or
    max) in the ranks' positions, which every rank takes alike, a piece of
    ``REDUCE_PIECE`` elements at a time: gloo's all_reduce takes several
    rounds, 4.3-5.4 ms against its all_to_all's 1.2-1.9 ms at 4 ranks on
    one host (tools/mesh_collectives_breakdown.py). A piece is on the host
    before its sum overwrites it, so in place needs no buffer of ``t``'s
    size."""
    axes = mesh.live(_axes(axes))
    if not axes:
        return t
    if mesh.backend == "gloo":
        n, group = mesh.size(axes), mesh.group(axes)[0]
        order = _order(mesh, axes)
        back = (None if order == sorted(order)
                else torch.argsort(torch.tensor(order)))

        def run(buf, out):
            dist.all_to_all_single(out, buf.reshape(-1), group=group)
        flat = t.view(-1) if inplace else t.reshape(-1)
        out = flat if inplace else torch.empty_like(flat)
        for i in range(0, max(flat.numel(), 1), REDUCE_PIECE):
            piece = flat[i:i + REDUCE_PIECE]
            got = _exchange(mesh, piece, n * piece.numel(), run,
                            copies=n).reshape(n, -1)
            if back is not None:
                got = got[back]
            out[i:i + REDUCE_PIECE] = (got.sum(0) if op == dist.ReduceOp.SUM
                                       else got.amax(0))
        return out.reshape(t.shape)
    if inplace:
        dist.all_reduce(t, op=op, group=mesh.group(axes)[0])
        STATS["collectives"] += 1
        STATS["bytes"] += t.numel() * t.element_size()
        return t

    def run(buf, out):
        out.copy_(buf.reshape(-1))
        dist.all_reduce(out, op=op, group=mesh.group(axes)[0])
    return _exchange(mesh, t, t.numel(), run).reshape(t.shape)


def _order(mesh, axes) -> list:
    """Each group rank's position along ``axes`` (in the order given):
    the identity unless the axes are listed out of the mesh's order."""
    _, members = mesh.group(axes)
    return [mesh.axis_index(axes, mesh.coords_of(r)) for r in members]


def _all_to_all(t: torch.Tensor, axes, mesh) -> torch.Tensor:
    axes = mesh.live(_axes(axes))
    if not axes:
        return t
    n = mesh.size(axes)
    if t.shape[0] % n:
        raise ValueError(f"all_to_all over {axes} ({n} ranks) of dim "
                         f"{t.shape[0]}")
    order = _order(mesh, axes)
    blocks = t.reshape(n, -1)
    if order != sorted(order):
        blocks = blocks[order]              # group rank g gets block order[g]

    def run(buf, out):
        dist.all_to_all_single(out, buf.reshape(-1),
                               group=mesh.group(axes)[0])
    out = _exchange(mesh, blocks, blocks.numel(), run).reshape(n, -1)
    if order != sorted(order):
        out = out[torch.argsort(torch.tensor(order))]
    return out.reshape(t.shape)


def _all_gather(t: torch.Tensor, axes, mesh) -> torch.Tensor:
    axes = mesh.live(_axes(axes))
    if not axes:
        return t
    n = mesh.size(axes)

    def run(buf, out):
        dist.all_gather_into_tensor(out, buf.reshape(-1),
                                    group=mesh.group(axes)[0])
    out = _exchange(mesh, t, n * t.numel(), run).reshape(n, *t.shape)
    order = _order(mesh, axes)
    if order != sorted(order):
        out = out[torch.argsort(torch.tensor(order))]
    return out.reshape(n * t.shape[0], *t.shape[1:])


def _psum_scatter(t: torch.Tensor, axes, mesh) -> torch.Tensor:
    """Block i (of n along dim 0) of the sum over ``axes`` lands on the rank
    at position i. Under gloo, one ``all_to_all`` of the blocks and a sum
    of the n received, in the senders' positions."""
    axes = mesh.live(_axes(axes))
    if not axes:
        return t
    n = mesh.size(axes)
    if t.shape[0] % n:
        raise ValueError(f"psum_scatter over {axes} ({n} ranks) of dim "
                         f"{t.shape[0]}")
    shape = (t.shape[0] // n,) + tuple(t.shape[1:])
    if mesh.backend == "gloo":
        return _all_to_all(t, axes, mesh).reshape(n, *shape).sum(0)
    order = _order(mesh, axes)
    blocks = t.reshape(n, -1)
    if order != sorted(order):
        blocks = blocks[order]

    def run(buf, out):
        dist.reduce_scatter_tensor(out, buf.reshape(-1),
                                   group=mesh.group(axes)[0])
    return _exchange(mesh, blocks, blocks.shape[1], run).reshape(shape)


def _on_dim(fn, t: torch.Tensor, dim: int) -> torch.Tensor:
    """``fn`` (a collective along dim 0) along ``dim``."""
    if dim % t.dim() == 0:
        return fn(t)
    return fn(t.movedim(dim, 0).contiguous()).movedim(0, dim)


# ---------------------------------------------------------------------------
# The differentiable collectives
# ---------------------------------------------------------------------------

class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axes, mesh):
        return _reduce(t, axes, mesh, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _PVary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axes, mesh):
        ctx.axes, ctx.mesh = axes, mesh
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.axes, ctx.mesh, dist.ReduceOp.SUM), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axes, mesh):
        ctx.axes, ctx.mesh = axes, mesh
        return _all_to_all(t, axes, mesh)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g.contiguous(), ctx.axes, ctx.mesh), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axes, mesh, dim, dtype, invariant):
        ctx.axes, ctx.mesh, ctx.dim = axes, mesh, dim
        ctx.in_dtype, ctx.invariant = t.dtype, invariant
        ctx.rows = t.shape[dim]
        src = t if dtype is None else t.to(dtype)
        return _on_dim(lambda u: _all_gather(u, axes, mesh), src, dim)

    @staticmethod
    def backward(ctx, g):
        g = g.to(ctx.in_dtype)
        if ctx.invariant:
            i = ctx.mesh.axis_index(ctx.mesh.live(_axes(ctx.axes)))
            out = g.narrow(ctx.dim, i * ctx.rows, ctx.rows)
        else:
            out = _on_dim(lambda u: _psum_scatter(u, ctx.axes, ctx.mesh),
                          g, ctx.dim)
        return out, None, None, None, None, None


class _PSumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axes, mesh, dim):
        ctx.axes, ctx.mesh, ctx.dim = axes, mesh, dim
        return _on_dim(lambda u: _psum_scatter(u, axes, mesh), t, dim)

    @staticmethod
    def backward(ctx, g):
        return _on_dim(lambda u: _all_gather(u, ctx.axes, ctx.mesh),
                       g, ctx.dim), None, None, None


def psum(t: torch.Tensor, axes, mesh) -> torch.Tensor:
    """The sum of ``t`` over the ranks along ``axes``, on every one. The
    sum is the same on every rank and used alike there, so its cotangent
    is whole on each and the backward is the identity (Megatron's g; the
    transpose of :func:`pvary`)."""
    if not mesh.live(_axes(axes)):
        return t
    return _PSum.apply(t, axes, mesh)


def psum_(t: torch.Tensor, axes, mesh) -> torch.Tensor:
    """:func:`psum` into ``t`` itself (contiguous), with no gradient: a
    gradient summed over the batch (``train/step.py``) needs no second
    buffer of its size. Returns ``t``."""
    return _reduce(t.detach(), axes, mesh, dist.ReduceOp.SUM, inplace=True)


def pvary(t: torch.Tensor, axes, mesh) -> torch.Tensor:
    """``t``, the same on every rank along ``axes``, handed to a
    computation that differs there (a rank's heads, hidden units, vocab
    rows or tokens): the identity, whose backward sums the ranks'
    cotangents (Megatron's f; JAX's ``pvary``)."""
    if not mesh.live(_axes(axes)):
        return t
    return _PVary.apply(t, axes, mesh)


def pmax(t: torch.Tensor, axes, mesh) -> torch.Tensor:
    """The elementwise max of ``t`` over the ranks along ``axes``; no
    gradient flows through it."""
    return _reduce(t.detach(), axes, mesh, dist.ReduceOp.MAX)


def all_to_all(t: torch.Tensor, axes, mesh) -> torch.Tensor:
    """``jax.lax.all_to_all(t, axes, 0, 0, tiled=True)``: dim 0 is cut into
    n blocks, block j goes to the rank at position j along ``axes``, and the
    result stacks the blocks received, in the senders' positions. Its own
    transpose."""
    if not mesh.live(_axes(axes)):
        return t
    return _AllToAll.apply(t, axes, mesh)


def all_gather(t: torch.Tensor, axes, mesh, *, dim: int = 0,
               dtype: Optional[torch.dtype] = None,
               invariant: bool = False) -> torch.Tensor:
    """``jax.lax.all_gather(t, axes, axis=dim, tiled=True)``: every rank's
    ``t`` concatenated along ``dim`` in their positions along ``axes``.
    With ``dtype``, each block is cast before it is sent (half the bytes
    for bf16; a cast is elementwise, so the result equals gathering and
    then casting). The backward is the transpose, :func:`psum_scatter`,
    in ``t``'s own dtype; with ``invariant`` (the result is used alike on
    every rank) it takes this rank's block instead."""
    if not mesh.live(_axes(axes)):
        return t if dtype is None else t.to(dtype)
    return _AllGather.apply(t, axes, mesh, dim, dtype, invariant)


def psum_scatter(t: torch.Tensor, axes, mesh, *, dim: int = 0
                 ) -> torch.Tensor:
    """``jax.lax.psum_scatter(t, axes, scatter_dimension=dim,
    tiled=True)``: the sum over the ranks along ``axes``, cut into n blocks
    along ``dim``, block i on the rank at position i. The transpose of
    :func:`all_gather`."""
    if not mesh.live(_axes(axes)):
        return t
    return _PSumScatter.apply(t, axes, mesh, dim)
