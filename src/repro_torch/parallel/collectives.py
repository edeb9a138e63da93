"""Collectives over named mesh axes: the port's counterparts of ``psum``,
``pmax``, ``all_to_all(tiled=True)`` and ``all_gather(tiled=True)`` inside
a ``shard_map`` (``jax.lax.axis_index`` is ``Mesh.axis_index``).

Each runs in the mesh's process group over its axes
(``launch/mesh.py``); axes of size 1 are dropped, and over none the
collective is the identity, as JAX's is on a degenerate mesh. Under
``gloo`` every CUDA buffer is moved to the host, reduced or exchanged there,
and moved back: gloo is the backend of ranks that share one card (NCCL
refuses two ranks on one device), and its documented support for CUDA
tensors lists broadcast and all_reduce only, so this module stages by
design, not after a failure. Under
``nccl`` nothing is staged. Under gloo a reduction is one ``all_to_all``
and a local sum (``_reduce``).

``STATS`` counts what the module ran: ``collectives``, the ``bytes``
each rank sent, and the ``staged_bytes`` copied to the host and back.
"""
from __future__ import annotations

from typing import Dict

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


def _exchange(mesh, t: torch.Tensor, out_numel: int, run) -> torch.Tensor:
    """``run(buffer, out)`` on ``t`` (staged to the host under gloo), into
    a new tensor of ``out_numel`` elements on ``t``'s device. Staging copies
    through pinned host buffers (PyTorch's caching host allocator), so
    each copy is one DMA; the stream is synchronised once, before gloo
    reads the buffer."""
    staged = stages(mesh.backend, t.device)
    if staged:
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t.detach(), non_blocking=True)
        torch.cuda.current_stream(t.device).synchronize()
        out = torch.empty(out_numel, dtype=t.dtype, pin_memory=True)
    else:
        buf = t.detach().contiguous()
        out = torch.empty(out_numel, dtype=t.dtype, device=t.device)
    run(buf, out)
    STATS["collectives"] += 1
    STATS["bytes"] += buf.numel() * buf.element_size()
    if staged:
        STATS["staged_bytes"] += (buf.numel() + out.numel()) \
            * buf.element_size()
        out = out.to(t.device, non_blocking=True)
    return out


def _reduce(t: torch.Tensor, axes, mesh, op) -> torch.Tensor:
    """All-reduce over ``axes``. Under gloo, one ``all_to_all`` of n copies
    and a sum (or max) in the ranks' order, which every rank takes alike:
    gloo's all_reduce takes several rounds, 4.3-5.4 ms against its
    all_to_all's 1.2-1.9 ms at 4 ranks on one host
    (tools/mesh_collectives_breakdown.py)."""
    axes = mesh.live(_axes(axes))
    if not axes:
        return t
    if mesh.backend == "gloo":
        n = mesh.size(axes)
        got = all_to_all(t.reshape(1, -1).expand(n, -1), axes, mesh)
        red = got.sum(0) if op == dist.ReduceOp.SUM else got.amax(0)
        return red.reshape(t.shape)

    def run(buf, out):
        out.copy_(buf.reshape(-1))
        dist.all_reduce(out, op=op, group=mesh.group(axes)[0])
    return _exchange(mesh, t, t.numel(), run).reshape(t.shape)


def psum(t: torch.Tensor, axes, mesh) -> torch.Tensor:
    """The sum of ``t`` over the ranks along ``axes``, on every one."""
    return _reduce(t, axes, mesh, dist.ReduceOp.SUM)


def pmax(t: torch.Tensor, axes, mesh) -> torch.Tensor:
    """The elementwise max of ``t`` over the ranks along ``axes``."""
    return _reduce(t, axes, mesh, dist.ReduceOp.MAX)


def _order(mesh, axes) -> list:
    """Each group rank's position along ``axes`` (in the order given):
    the identity unless the axes are listed out of the mesh's order."""
    _, members = mesh.group(axes)
    return [mesh.axis_index(axes, mesh.coords_of(r)) for r in members]


def all_to_all(t: torch.Tensor, axes, mesh) -> torch.Tensor:
    """``jax.lax.all_to_all(t, axes, 0, 0, tiled=True)``: dim 0 is cut into
    n blocks, block j goes to the rank at position j along ``axes``, and the
    result stacks the blocks received, in the senders' positions."""
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


def all_gather(t: torch.Tensor, axes, mesh) -> torch.Tensor:
    """``jax.lax.all_gather(t, axes, axis=0, tiled=True)``: every rank's
    ``t`` stacked along dim 0 in their positions along ``axes``."""
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

