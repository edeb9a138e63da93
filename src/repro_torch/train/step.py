"""Train step: microbatched gradient accumulation, remat, mixed precision.
Port of ``repro/train/step.py`` on one device.

The model keeps f32 master parameters and computes in ``cfg.dtype``; its
forward and backward run through the kernels (``kernels/``) on the card and
their plain versions on the CPU. ``remat="full"`` (JAX's default) recomputes
each layer's activations in the backward. ``TrainConfig.unroll_accum`` is
not ported: in JAX it only changes how the accumulation loop is traced,
not its math, and the port's loop is a Python loop already. The sharding
helpers wait for ROADMAP Queue 1 item 15.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.params import init_params
from repro_torch.models.transformer import AUX_KEYS, Transformer, train_logits
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


def init_train_state(cfg: ModelConfig, ocfg: OptConfig,
                     generator: torch.Generator,
                     device: DeviceLike = "cuda") -> State:
    """f32 params drawn from ``generator`` on its own device, then moved to
    ``device``, and zero AdamW moments there. A CPU generator gives one
    state whatever ``device`` is, as one ``jax.random`` key does on every
    backend."""
    dev = resolve_device(device)
    params = {k: v.to(dev) for k, v in
              init_params(cfg, generator, generator.device).items()}
    return {"params": params, "opt": init_opt(params, ocfg)}


def _split_micro(batch: Mapping[str, torch.Tensor], m: int
                 ) -> list:
    rows = next(iter(batch.values())).shape[0]
    if rows % m:
        raise ValueError(f"batch of {rows} rows does not split into {m} "
                         f"microbatches")
    return [{k: v[i * (rows // m):(i + 1) * (rows // m)]
             for k, v in batch.items()} for i in range(m)]


def build_train_step(cfg: ModelConfig, ocfg: OptConfig,
                     tcfg: TrainConfig = TrainConfig(), *,
                     remat: str = "full"
                     ) -> Callable[[State, Mapping[str, torch.Tensor]],
                                   Tuple[State, Dict[str, torch.Tensor]]]:
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``state`` is :func:`init_train_state`'s; the step updates it in place
    (see ``train/optimizer.py``) and returns it. ``batch`` holds the
    model's inputs and ``labels`` on the params' device. Metrics are 0-d
    tensors on that device: ce, z_loss, accuracy, tokens, loss, the MoE
    aux keys, grad_norm, lr, param_norm and step.
    """
    built: Dict[str, Any] = {}

    def model_for(params: Mapping[str, torch.Tensor]) -> Transformer:
        # one model per params dict: its parameters share the dict's storage
        if built.get("params") is not params:
            dev = next(iter(params.values())).device
            built["params"] = params
            built["model"] = Transformer(cfg, params, device=dev,
                                         trainable=True)
        return built["model"]

    def grad_fn(model: Transformer, micro: Mapping[str, torch.Tensor]):
        logits, aux = train_logits(model, micro, remat=remat)
        loss, stats = cross_entropy(logits, micro["labels"],
                                    z_loss=tcfg.z_loss)
        if aux is None:                     # no MoE layer
            aux = {k: torch.zeros((), device=logits.device) for k in AUX_KEYS}
        loss = loss + tcfg.aux_scale * sum(aux.values())
        stats = dict(stats, **{k: v.detach() for k, v in aux.items()},
                     loss=loss.detach())
        grads = torch.autograd.grad(loss, list(model.parameters()))
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
        _, _, opt_stats = adamw_update(dict(zip(names, grads)), opt, params,
                                       ocfg)
        metrics = dict(stats, **opt_stats, step=opt["step"])
        return state, metrics

    return train_step
