"""Meshes of ranks: named axes over the processes of one
``torch.distributed`` job. Port of ``repro/launch/mesh.py``.

A :class:`Mesh` lays the job's ranks out row-major over its axes, as a JAX
mesh lays out its devices, and holds one process group per tuple of axes
that the code reduces over (every non-empty subset of the axes, in the
mesh's order). It exposes what the sharding plans read of a JAX mesh
(``axis_names``, ``axis_sizes``) and what ``shard_map``'s body reads
(``axis_index``), and the groups the collectives run in
(``parallel/collectives.py``).

A mesh is built only when the job's world size equals the product of its
shape; one process without ``torch.distributed`` is a world of 1. The
process group's backend is the caller's: ``nccl`` when each rank has its own
card, ``gloo`` on the CPU and when ranks share one card. :meth:`Mesh.view`
is one rank's view of a mesh without a job; with ``dry`` its backend is
``"dry"``, under which the collectives exchange nothing
(``launch/dryrun.py``).
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist

Axes = Tuple[str, ...]


class Mesh:
    """``shape`` ranks over ``axis_names``; rank r sits at
    ``np.unravel_index(r, shape)``."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        shape = tuple(int(s) for s in shape)
        names = tuple(axis_names)
        if len(shape) != len(names) or len(set(names)) != len(names):
            raise ValueError(f"mesh shape {shape} vs axes {names}")
        ready = dist.is_available() and dist.is_initialized()
        world = dist.get_world_size() if ready else 1
        if world != math.prod(shape):
            raise ValueError(
                f"a mesh of shape {shape} needs {math.prod(shape)} ranks; "
                f"this job has {world}")
        self._layout(shape, names, dist.get_rank() if ready else 0)
        self.backend: Optional[str] = dist.get_backend() if ready else None
        sizes = self.sizes
        for k in range(1, len(names) + 1):
            for axes in itertools.combinations(names, k):
                if math.prod(sizes[a] for a in axes) == 1:
                    continue
                rest = [a for a in names if a not in axes]
                if math.prod(sizes[a] for a in rest) == 1:
                    self.groups[axes] = (dist.group.WORLD,
                                         list(range(world)))
                    continue
                # every rank creates every group, in the same order
                for key in itertools.product(*(range(sizes[a])
                                               for a in rest)):
                    members = [r for r in range(world)
                               if all(self.coords_of(r)[a] == c
                                      for a, c in zip(rest, key))]
                    group = dist.new_group(members)
                    if self.rank in members:
                        self.groups[axes] = (group, members)

    def _layout(self, shape: Tuple[int, ...], names: Axes, rank: int
                ) -> None:
        self.axis_names: Axes = names
        self.axis_sizes: Tuple[int, ...] = shape
        self.rank = rank
        self.coords: Dict[str, int] = self.coords_of(rank)
        # axes (in mesh order) -> (this rank's group, its members' global
        # ranks in ascending order, which is the group's rank order)
        self.groups: Dict[Axes, Tuple[object, List[int]]] = {}
        self._spans: Dict[Axes, bool] = {}

    @classmethod
    def view(cls, shape: Sequence[int], axis_names: Sequence[str],
             rank: int, dry: bool = False) -> "Mesh":
        """Rank ``rank``'s view of a mesh, without a job: its coordinates,
        plans and blocks, but no process group, so no collective; with
        ``dry``, collectives that return empty results of their shapes
        (backend ``"dry"``)."""
        mesh = cls.__new__(cls)
        mesh._layout(tuple(int(s) for s in shape), tuple(axis_names), rank)
        mesh.backend = "dry" if dry else None
        return mesh

    @property
    def sizes(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    def coords_of(self, rank: int) -> Dict[str, int]:
        return {a: int(c) for a, c in zip(
            self.axis_names, np.unravel_index(rank, self.axis_sizes))}

    def live(self, axes: Sequence[str]) -> Axes:
        """``axes`` less those absent from the mesh or of size 1, in the
        order given."""
        sizes = self.sizes
        return tuple(a for a in axes if sizes.get(a, 1) > 1)

    def members(self, axes: Sequence[str]) -> List[int]:
        """The global ranks of this rank's group over ``axes``: those at
        its coordinates on every other axis, in ascending order."""
        live = set(self.live(axes))
        return [r for r in range(math.prod(self.axis_sizes))
                if all(c == self.coords[a] for a, c in
                       self.coords_of(r).items() if a not in live)]

    def spans_pods(self, axes: Sequence[str]) -> bool:
        """Whether this rank's group over ``axes`` has members in more than
        one pod (a mesh without a ``pod`` axis is one pod)."""
        axes = self.live(axes)
        if "pod" not in axes:
            return False
        if axes not in self._spans:
            self._spans[axes] = len({self.coords_of(r)["pod"]
                                     for r in self.members(axes)}) > 1
        return self._spans[axes]

    def size(self, axes: Sequence[str]) -> int:
        sizes = self.sizes
        return math.prod(sizes.get(a, 1) for a in axes)

    def axis_index(self, axes, coords: Optional[Dict[str, int]] = None
                   ) -> int:
        """``jax.lax.axis_index(axes)``: this rank's (or ``coords``')
        position along ``axes``, row-major in the order given."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        coords = self.coords if coords is None else coords
        sizes, idx = self.sizes, 0
        for a in axes:
            idx = idx * sizes.get(a, 1) + coords.get(a, 0)
        return idx

    def group(self, axes: Sequence[str]) -> Tuple[object, List[int]]:
        """The group over ``axes`` (of size > 1) holding this rank, and its
        members' global ranks in group-rank order."""
        live = set(self.live(axes))
        return self.groups[tuple(a for a in self.axis_names if a in live)]

    def __repr__(self) -> str:
        return (f"Mesh({dict(zip(self.axis_names, self.axis_sizes))}, "
                f"rank={self.rank})")


def make_mesh(shape: Sequence[int], axis_names: Sequence[str]) -> Mesh:
    """The port's counterpart of ``repro.compat.make_mesh``."""
    return Mesh(shape, axis_names)


# (shape, axes) of each mesh, by multi_pod: 16x16 = 256 ranks, 2 pods =
# 512; the tiny ones, 8 ranks for CPU integration tests (same axis names)
PRODUCTION_MESHES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}
TINY_MESHES = {False: ((2, 4), ("data", "model")),
               True: ((2, 2, 2), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 = 256 ranks; multi-pod: 2 pods = 512."""
    return make_mesh(*PRODUCTION_MESHES[multi_pod])


def make_tiny_mesh(*, multi_pod: bool = False) -> Mesh:
    """8 ranks for CPU integration tests (same axis names)."""
    return make_mesh(*TINY_MESHES[multi_pod])


def make_local_mesh() -> Mesh:
    """One rank with the production axis names."""
    return make_mesh((1, 1), ("data", "model"))
