"""Train step: microbatched gradient accumulation, remat, mixed precision,
on one device or over a mesh of ranks. Port of ``repro/train/step.py``.

The model keeps f32 master parameters and computes in ``cfg.dtype``; its
forward and backward run through the kernels (``kernels/``) on the card and
their plain versions on the CPU. ``remat="full"`` (JAX's default) recomputes
each layer's activations in the backward. ``TrainConfig.unroll_accum`` is
not ported: in JAX it only changes how the accumulation loop is traced,
not its math, and the port's loop is a Python loop already.

Over a mesh (``build_train_step(..., flags=, mesh=)``) the step is the
reference's GSPMD step with its collectives written out: the state is this
rank's blocks under :func:`state_shardings` (FSDP over the batch axes, TP
over ``model``), each rank takes its rows of the batch
(:func:`batch_shardings`, ``parallel.sharding.batch_rows``), the loss is
the global batch's mean (``train.loss.cross_entropy`` over the mesh), the
gradients of FSDP leaves come out of their gathers' backward summed over
the batch axes they are split over, in f32, and every other gradient is
summed over the batch axes it is not split over (in buckets, in place).
Clipping and the norms read the whole state's norm (``train/optimizer.py``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.params import (AxisName, init_params, model_defs,
                                       param_specs, train_plan)
from repro_torch.models.transformer import (AUX_KEYS, RunFlags, Transformer,
                                            train_logits)
from repro_torch.parallel.collectives import REDUCE_PIECE, psum_
from repro_torch.parallel.sharding import Spec, spec_axes, train_batch_axes
from repro_torch.train.loss import cross_entropy
from repro_torch.train.optimizer import OptConfig, adamw_update, init_opt

STAT_KEYS = ("ce", "z_loss", "accuracy", "tokens", "loss") + AUX_KEYS

State = Dict[str, Any]


@dataclass(frozen=True)
class TrainConfig:
    n_microbatches: int = 1
    accum_dtype: torch.dtype = torch.float32
    z_loss: float = 1e-4
    aux_scale: float = 1.0        # scale on MoE aux losses


def state_shardings(cfg: ModelConfig, mesh,
                    rules: Optional[Mapping[str, AxisName]] = None
                    ) -> Dict[str, Any]:
    """The spec tree of :func:`init_train_state`'s state on ``mesh``:
    params and both AdamW moments under ``param_specs``, ``step``
    replicated (``()``), as the reference's ``state_shardings``, under
    ``rules`` (the default rules when None), as :func:`train_plan` lays
    out the port's state."""
    plan = param_specs(model_defs(cfg), mesh, rules)
    return {"params": plan, "opt": {"m": plan, "v": plan, "step": ()}}


def batch_shardings(mesh, batch_axes=("data",),
                    batch_example: Optional[Mapping] = None):
    """Each batch leaf's spec: rows over the mesh's ``batch_axes``,
    replicated over the rest, as the reference's ``batch_shardings``;
    without an example, the function from a batch to its specs. A rank
    takes its rows with ``parallel.sharding.batch_rows``, which also keeps
    the reference's microbatch split."""
    axes = tuple(a for a in batch_axes if a in mesh.axis_names)
    lead = axes if len(axes) > 1 else (axes[0] if axes else None)

    def one(x) -> Spec:
        return (lead,) + (None,) * (len(x.shape) - 1)

    if batch_example is None:
        return lambda tree: {k: one(v) for k, v in tree.items()}
    return {k: one(v) for k, v in batch_example.items()}


def init_train_state(cfg: ModelConfig, ocfg: OptConfig,
                     generator: torch.Generator,
                     device: DeviceLike = "cuda", *, mesh=None) -> State:
    """f32 params drawn from ``generator`` on its own device, then moved to
    ``device``, and zero AdamW moments there. A CPU generator gives one
    state whatever ``device`` is, as one ``jax.random`` key does on every
    backend. With ``mesh``, every leaf is drawn as without it and this
    rank keeps its block under :func:`state_shardings`, so the blocks of
    every rank make up the single process's state."""
    dev = resolve_device(device)
    plan = None if mesh is None else train_plan(cfg, mesh)
    params = {k: v.to(dev) for k, v in init_params(
        cfg, generator, generator.device, mesh=mesh, plan=plan).items()}
    return {"params": params, "opt": init_opt(params, ocfg)}


def _split_micro(batch: Mapping[str, torch.Tensor], m: int
                 ) -> list:
    rows = next(iter(batch.values())).shape[0]
    if rows % m:
        raise ValueError(f"batch of {rows} rows does not split into {m} "
                         f"microbatches")
    return [{k: v[i * (rows // m):(i + 1) * (rows // m)]
             for k, v in batch.items()} for i in range(m)]


def _sum_over_batch(grads: list, names: list, plan: Mapping, batch_axes,
                    mesh) -> list:
    """Each gradient summed over the batch axes its leaf is not split over
    (an FSDP leaf's gather summed it over the others), in f32 and in place.
    For each set of axes the gradients go in buckets of consecutive leaves
    of at most ``REDUCE_PIECE`` elements, each bucket concatenated and
    summed in one psum, and a larger leaf alone: so a rank never holds a
    second copy of more than one bucket (``grads`` is taken over)."""
    groups: Dict[Tuple[str, ...], list] = {}
    for i, name in enumerate(names):
        axes = tuple(a for a in mesh.live(batch_axes)
                     if a not in spec_axes(plan[name]))
        if axes:
            groups.setdefault(axes, []).append(i)
    for axes, idx in groups.items():
        buckets, size = [[]], 0
        for i in idx:
            n = grads[i].numel()
            if buckets[-1] and size + n > REDUCE_PIECE:
                buckets.append([])
                size = 0
            buckets[-1].append(i)
            size += n
        for bucket in buckets:
            if len(bucket) == 1:
                i = bucket[0]
                grads[i] = psum_(grads[i].float().contiguous(), axes, mesh)
                continue
            shapes = [grads[i].shape for i in bucket]
            flat = torch.cat([grads[i].float().reshape(-1) for i in bucket])
            psum_(flat, axes, mesh)
            for i, part, shape in zip(bucket, flat.split(
                    [math.prod(s) for s in shapes]), shapes):
                grads[i] = part.reshape(shape)
    return grads


def build_train_step(cfg: ModelConfig, ocfg: OptConfig,
                     tcfg: TrainConfig = TrainConfig(), *,
                     remat: str = "full", flags: RunFlags = RunFlags(),
                     mesh=None, keep_grads: bool = False,
                     rules: Optional[Mapping[str, AxisName]] = None
                     ) -> Callable[[State, Mapping[str, torch.Tensor]],
                                   Tuple[State, Dict[str, torch.Tensor]]]:
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``state`` is :func:`init_train_state`'s; the step updates it in place
    (see ``train/optimizer.py``) and returns it. ``batch`` holds the
    model's inputs and ``labels`` on the params' device. Metrics are 0-d
    tensors on that device: ce, z_loss, accuracy, tokens, loss, the MoE
    aux keys, grad_norm, lr, param_norm and step.

    With ``mesh``, ``state`` holds this rank's blocks
    (``init_train_state(..., mesh=)``), ``batch`` its rows
    (``parallel.sharding.batch_rows`` with ``tcfg.n_microbatches``), every
    MoE FFN runs ``moe_ep`` under ``flags``, and the metrics are the global
    batch's on every rank. ``keep_grads`` keeps the last step's gradients
    (this rank's blocks, summed over the ranks) as ``train_step.grads``.
    ``rules`` are the training plan's (``params.train_plan``; the default
    rules when None).
    """
    plan = None if mesh is None else train_plan(cfg, mesh, rules)
    batch_axes = () if mesh is None else train_batch_axes(mesh)
    built: Dict[str, Any] = {}

    def model_for(params: Mapping[str, torch.Tensor]) -> Transformer:
        # one model per params dict: its parameters share the dict's storage
        if built.get("params") is not params:
            dev = next(iter(params.values())).device
            built["params"] = params
            built["model"] = Transformer(cfg, params, device=dev,
                                         trainable=True, plan=plan)
        return built["model"]

    def grad_fn(model: Transformer, micro: Mapping[str, torch.Tensor]):
        logits, aux = train_logits(model, micro, remat=remat, flags=flags,
                                   mesh=mesh)
        loss, stats = cross_entropy(logits, micro["labels"],
                                    z_loss=tcfg.z_loss, mesh=mesh,
                                    batch_axes=batch_axes)
        if aux is None:                     # no MoE layer
            aux = {k: torch.zeros((), device=logits.device) for k in AUX_KEYS}
        loss = loss + tcfg.aux_scale * sum(aux.values())
        stats = dict(stats, **{k: v.detach() for k, v in aux.items()},
                     loss=loss.detach())
        # a leaf the loss does not read (an ``embeds`` model's ``tok``)
        # gets zeros, as jax.grad gives it
        grads = torch.autograd.grad(loss, list(model.parameters()),
                                    allow_unused=True,
                                    materialize_grads=True)
        return grads, stats

    def train_step(state: State, batch: Mapping[str, torch.Tensor]):
        params, opt = state["params"], state["opt"]
        model = model_for(params)
        names = [n for n, _ in model.named_parameters()]
        m = tcfg.n_microbatches
        if m > 1:
            acc = [torch.zeros(p.shape, dtype=tcfg.accum_dtype,
                               device=p.device) for p in model.parameters()]
            stats = None
            for micro in _split_micro(batch, m):
                g, s = grad_fn(model, micro)
                for a, gi in zip(acc, g):
                    a.add_(gi.to(tcfg.accum_dtype))
                stats = s if stats is None else {
                    k: stats[k] + s[k] for k in STAT_KEYS}
            grads = [(a / m).to(torch.float32) for a in acc]
            stats = {k: v / m for k, v in stats.items()}
            stats["tokens"] = stats["tokens"] * m
        else:
            grads, stats = grad_fn(model, batch)
        if mesh is not None:
            grads = list(grads)
            grads = _sum_over_batch(grads, names, plan, batch_axes, mesh)
        grads = dict(zip(names, grads))
        if keep_grads:
            train_step.grads = grads
        _, _, opt_stats = adamw_update(grads, opt, params, ocfg, mesh=mesh,
                                       plan=plan)
        metrics = dict(stats, **opt_stats, step=opt["step"])
        return state, metrics

    train_step.grads = None
    return train_step
