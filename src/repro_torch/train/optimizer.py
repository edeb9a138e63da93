"""AdamW written out (not ``torch.optim.AdamW``): decoupled weight decay,
bias correction, global-norm clipping, warmup + cosine schedule,
configurable moment dtypes. Port of ``repro/train/optimizer.py``.

Parameters, grads and moments are dicts of tensors keyed alike. Where JAX
returns new trees, :func:`adamw_update` writes the new parameters and
moments into the given tensors, under ``torch.no_grad()``, and returns the
same dicts: one copy of the optimizer state, not two.

On a mesh the dicts hold this rank's blocks (``params.train_plan``): the
update stays elementwise on them, and the global norms add each leaf's
sum of squares over exactly the axes its spec splits, so a leaf the same
on several ranks counts once.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterable, Mapping, Optional, Tuple

import torch

from repro_torch.parallel.collectives import psum
from repro_torch.parallel.sharding import spec_axes

Tree = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    m_dtype: torch.dtype = torch.float32
    v_dtype: torch.dtype = torch.float32


def lr_at(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``lr``, then cosine to ``lr * min_lr_ratio`` at
    ``total_steps``; f32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)


def init_opt(params: Tree, cfg: OptConfig) -> Dict:
    dev = next(iter(params.values())).device
    return {"m": {k: torch.zeros(p.shape, dtype=cfg.m_dtype, device=p.device)
                  for k, p in params.items()},
            "v": {k: torch.zeros(p.shape, dtype=cfg.v_dtype, device=p.device)
                  for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(leaves: Iterable[torch.Tensor], *, mesh=None,
                specs: Optional[Iterable] = None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32. With ``mesh``, the
    leaves are this rank's blocks under ``specs`` (one a leaf): the sums of
    the leaves split over the same axes are added over those axes, one
    psum for each such set."""
    if mesh is None:
        return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                              for t in leaves))
    groups: Dict[Tuple[str, ...], torch.Tensor] = {}
    for t, spec in zip(leaves, specs):
        axes = mesh.live(spec_axes(spec))
        sq = torch.sum(torch.square(t.float()))
        groups[axes] = groups[axes] + sq if axes in groups else sq
    return torch.sqrt(sum(psum(v, axes, mesh) for axes, v in groups.items()))


# the elements of a leaf the update takes at a time: its f32 temporaries
# are a few times the piece, not the leaf (a rank's block of deepseek-v2's
# vocab is 0.26e9 entries); every op is elementwise, so the pieces give the
# values the whole leaf does
ADAM_PIECE = 1 << 26


def _pieces(leaf: torch.Tensor) -> list:
    """Slices of ``leaf`` along dim 0 of at most ``ADAM_PIECE`` elements
    each (a whole-leaf slice for a small or 0-d leaf)."""
    if leaf.dim() == 0 or leaf.numel() <= ADAM_PIECE:
        return [(...,)]
    rows = max(1, ADAM_PIECE // max(leaf[0].numel(), 1))
    return [slice(i, i + rows) for i in range(0, leaf.shape[0], rows)]


@torch.no_grad()
def adamw_update(grads: Tree, opt: Dict, params: Tree, cfg: OptConfig, *,
                 mesh=None, plan: Optional[Mapping] = None
                 ) -> Tuple[Tree, Dict, Dict[str, torch.Tensor]]:
    """One AdamW step, IN PLACE: ``params`` and ``opt["m"]``/``opt["v"]``
    are overwritten (each rounded to its own dtype) and ``opt["step"]``
    replaced. Returns (params, opt, {"grad_norm", "lr", "param_norm"}).
    Weight decay applies to leaves with ndim >= 2 only. With ``mesh``,
    every tree holds this rank's blocks under ``plan`` ({name: spec})."""
    specs = None if mesh is None else [plan[k] for k in params]
    step = opt["step"] + 1
    gnorm = global_norm(grads.values() if mesh is None else
                        [grads[k] for k in params], mesh=mesh, specs=specs)
    scale = torch.where(gnorm > cfg.clip_norm,
                        cfg.clip_norm / (gnorm + 1e-9), 1.0)
    lr = lr_at(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1 - cfg.b1 ** stepf
    b2c = 1 - cfg.b2 ** stepf
    for name, leaf in params.items():
        decay = cfg.weight_decay if leaf.dim() >= 2 else 0.0
        for sl in _pieces(leaf):
            p, m, v = leaf[sl], opt["m"][name][sl], opt["v"][name][sl]
            g = grads[name][sl].float() * scale
            m1 = cfg.b1 * m.float() + (1 - cfg.b1) * g
            v1 = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
            u = (m1 / b1c) / (torch.sqrt(v1 / b2c) + cfg.eps)
            pf = p.float()
            p.copy_(pf - lr * (u + decay * pf))
            m.copy_(m1)
            v.copy_(v1)
    opt["step"] = step
    stats = {"grad_norm": gnorm, "lr": lr,
             "param_norm": global_norm(params.values(), mesh=mesh,
                                       specs=specs)}
    return params, opt, stats
