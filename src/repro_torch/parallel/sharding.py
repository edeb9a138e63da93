"""Sharding plans: KV-cache specs, the decode plan, and a rank's block of a
tensor. Port of ``repro/parallel/sharding.py``.

A spec is a tuple with one entry per leading dimension: ``None``
(replicated), an axis name, or a tuple of axis names (the dimension split
over them, row-major in the order given), as a ``PartitionSpec``. The specs
describe the port's unstacked cache, ``{"layers": [one dict a layer],
"lengths"}``: no leading layer axis.

Decode layout (flash-decoding across ranks): activations replicated, the
KV/latent cache sharded along the *sequence* over ("data", "model"), and
over "pod" too when the batch cannot split across pods; recurrent state has
d_inner over "model".

``local_shard`` gives this rank's block of a whole tensor under a spec (what
``jax.device_put`` with a ``NamedSharding`` leaves on one device);
``gather_shards`` puts every rank's block back together (tests);
``batch_rows`` gives a rank its rows of a global training batch.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig, ShapeConfig

Entry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Entry, ...]


def _lead(axes: Sequence[str]) -> Entry:
    axes = tuple(axes)
    return axes if len(axes) > 1 else (axes[0] if axes else None)


def layer_cache_specs(cfg: ModelConfig, spec: LayerSpec,
                      batch_axes: Sequence[str],
                      seq_axes: Sequence[str]) -> Dict[str, Spec]:
    b, s = _lead(batch_axes), _lead(seq_axes)
    if spec.mixer == "attn":
        kv = (b, s, None, None)
        return {"k": kv, "v": kv}
    if spec.mixer == "mla":
        return {"ckv": (b, s, None), "kr": (b, s, None)}
    if spec.mixer == "mamba":
        return {"conv": (b, None, "model"), "ssm": (b, "model", None)}
    if spec.mixer == "mlstm":
        return {"C": (b, None, None, None), "n": (b, None, None),
                "m": (b, None), "conv": (b, None, "model")}
    if spec.mixer == "slstm":
        e = (b, None, None)
        return {"c": e, "n": e, "h": e, "m": e}
    raise ValueError(spec.mixer)


def cache_specs(cfg: ModelConfig, batch_axes: Sequence[str],
                seq_axes: Sequence[str]) -> Dict:
    """Spec tree matching ``models.transformer.init_cache``'s structure."""
    return {"layers": [layer_cache_specs(cfg, s, batch_axes, seq_axes)
                       for s in cfg.layer_specs],
            "lengths": (_lead(batch_axes),)}


def decode_plan(cfg: ModelConfig, shape: ShapeConfig, mesh
                ) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    """(batch_axes, seq_axes) for a decode cell on this mesh."""
    names = mesh.axis_names
    sizes = dict(zip(names, mesh.axis_sizes))
    batch_axes: Tuple[str, ...] = ()
    if "pod" in names and shape.global_batch % sizes["pod"] == 0 \
            and shape.global_batch > 1:
        batch_axes = ("pod",)
    seq_axes = tuple(a for a in names if a not in batch_axes and a != "pod")
    if "pod" in names and not batch_axes:
        seq_axes = ("pod",) + seq_axes           # long context: seq 3-way
    return batch_axes, seq_axes


def train_batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def batch_rows(t: torch.Tensor, mesh, batch_axes: Sequence[str],
               n_microbatches: int = 1) -> torch.Tensor:
    """This rank's rows of a global batch leaf ``t`` split over
    ``batch_axes`` (replicated over the other axes), in the reference's
    order: the global batch is cut into ``n_microbatches`` first, then each
    microbatch over the batch axes. The rank's rows are its block of each
    microbatch, one after the other, so cutting them into
    ``n_microbatches`` again gives its block of each; a rank's block of the
    whole batch would group other rows into each microbatch, whose loss is
    a mean over its own tokens."""
    m = n_microbatches
    if t.shape[0] % m:
        raise ValueError(f"batch of {t.shape[0]} rows does not split into "
                         f"{m} microbatches")
    micro = t.reshape(m, t.shape[0] // m, *t.shape[1:])
    mine = local_shard(micro, (None, _lead(mesh.live(batch_axes))), mesh)
    return mine.reshape(-1, *t.shape[1:])


def entry_axes(entry: Entry) -> Tuple[str, ...]:
    """The mesh axes one spec entry splits its dimension over."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_axes(spec: Spec) -> Tuple[str, ...]:
    """Every mesh axis a spec splits its tensor over, in its order."""
    return tuple(a for e in spec for a in entry_axes(e))


def block_range(dim: int, entry: Entry, mesh,
                coords: Optional[Mapping[str, int]] = None
                ) -> Tuple[int, int]:
    """[start, stop) of this rank's (or ``coords``') block of a dimension
    of ``dim`` under one spec entry."""
    axes = entry_axes(entry)
    n = mesh.size(axes)
    if dim % n:
        raise ValueError(f"dimension {dim} does not split over {axes} "
                         f"({n} ranks)")
    i = mesh.axis_index(axes, None if coords is None else dict(coords))
    return i * (dim // n), (i + 1) * (dim // n)


def block_slices(shape, spec: Spec, mesh, coords=None) -> tuple:
    """This rank's (or ``coords``') block of a tensor of ``shape`` under
    ``spec``, as one slice a dimension."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(slice(*block_range(d, e, mesh, coords))
                 for d, e in zip(shape, spec))


def local_shard(t: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec``: a tensor of its own where
    a dimension is split, ``t`` itself where none is."""
    if not any(entry_axes(e) and mesh.size(entry_axes(e)) > 1
               for e in spec):
        return t
    return t[block_slices(t.shape, spec, mesh)].clone()


def gather_shards(blocks: List[torch.Tensor], spec: Spec, mesh
                  ) -> torch.Tensor:
    """The whole tensor from every rank's block (``blocks[r]`` is global
    rank r's), for tests: replicated blocks must agree."""
    spec = tuple(spec) + (None,) * (blocks[0].dim() - len(spec))
    shape = [b * mesh.size(entry_axes(e))
             for b, e in zip(blocks[0].shape, spec)]
    out = torch.empty(shape, dtype=blocks[0].dtype)
    seen = set()
    for r, b in enumerate(blocks):
        sl = block_slices(shape, spec, mesh, mesh.coords_of(r))
        key = tuple((s.start, s.stop) for s in sl)
        if key in seen and not torch.equal(out[sl], b.cpu()):
            raise ValueError(f"rank {r}'s block differs from a replica")
        seen.add(key)
        out[sl] = b.cpu()
    return out

