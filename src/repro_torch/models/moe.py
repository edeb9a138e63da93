"""Mixture-of-Experts FFN: token-choice top-k routing, single device.

Port of ``repro/models/moe.py``'s single-device path. Two ways to apply the
routed experts compute the same function:

- :func:`moe_dense_oracle` (the reference's): every expert on every token,
  combined with the sparse top-k weights. E-fold work, but a few large
  launches and no host read.
- :func:`moe_dispatch`: a dropless dispatch. The N*k assignments are
  sorted by expert (stably), the per-expert counts are read to the host
  once per call, each non-empty expert runs its two products on its
  contiguous rows, and the outputs go back to their tokens and are
  combined with the weights. Nothing is dropped: the reference's capacity
  factor applies only to its expert-parallel path (``moe_ep``, which waits
  for ROADMAP Queue 1 item 15).

:func:`moe_apply`, the model's path, takes the dispatch from
``DISPATCH_MIN_ROWS`` rows on and the oracle below. ``ServeEngine`` pads
every prefill to ``max_seq`` rows, so the choice follows its ``max_seq``;
a decode step has ``max_batch`` rows.

Rounding follows the reference: the router in f32; the top-k weights
(renormalised only with ``norm_topk``) rounded to x.dtype; each expert's
products in x.dtype; the combine a product of x.dtype values summed in f32
and rounded once; then the shared block's output added. The aux terms count
every row of x, the padded rows of a prefill included, as JAX's do.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import apply_ffn
from repro_torch.models.params import padded_experts

Aux = Dict[str, torch.Tensor]

# rows (tokens) from which ``moe_apply`` runs the dispatch. One
# qwen2-moe-a2.7b layer on an H100 80GB HBM3 at 700 W, oracle against
# dispatch (tools/moe_dispatch_breakdown.py): 2.00 vs 5.95 ms at 512 rows,
# 6.07 vs 6.31 at 2048, 11.38 vs 6.02 at 4096; the dispatch's time is its
# ~60 experts' launches and the host read, nearly flat in the rows
DISPATCH_MIN_ROWS = 4096


def router_probs(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    """Softmax or sigmoid over the experts; padded experts get -1e30 logits
    first, so they are never picked."""
    moe = cfg.moe
    E = padded_experts(moe)
    if E > moe.n_experts:
        pad = torch.arange(E, device=logits.device) >= moe.n_experts
        logits = logits.masked_fill(pad, -1e30)
    if moe.router == "sigmoid":
        return torch.sigmoid(logits)
    return torch.softmax(logits, dim=-1)


def route(cfg: ModelConfig, x: torch.Tensor, router_w: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, Aux]:
    """x: (N, D) -> expert indices (N, k), weights (N, k) in x.dtype, and
    the sums the aux losses are made of."""
    moe = cfg.moe
    logits = x.float() @ router_w.float()
    probs = router_probs(cfg, logits)
    top_p, top_i = torch.topk(probs, moe.top_k, dim=-1)
    if moe.norm_topk:
        top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    E = padded_experts(moe)
    aux = {"f_sum": torch.bincount(top_i.flatten(), minlength=E).float(),
           "p_sum": probs.sum(0),
           # the unpadded logits, as the reference's
           "z_sum": torch.logsumexp(logits, -1).square().sum(),
           "n": torch.full((), float(x.shape[0]), device=x.device)}
    return top_i, top_p.to(x.dtype), aux


def aux_loss(cfg: ModelConfig, aux: Aux) -> Aux:
    """Switch-style load balance and router z-loss, under JAX's keys."""
    moe = cfg.moe
    n = aux["n"].clamp_min(1.0)
    f = aux["f_sum"] / (n * moe.top_k)
    p = aux["p_sum"] / n
    lb = moe.n_experts * torch.sum(f * p)
    return {"moe_load_balance": moe.aux_loss_coef * lb,
            "moe_router_z": 1e-3 * aux["z_sum"] / n}


def expert_ffn(w_in: torch.Tensor, w_out: torch.Tensor, x: torch.Tensor
               ) -> torch.Tensor:
    """SwiGLU experts in x.dtype. x: (E, C, D) with w_in (E, D, 2F) and
    w_out (E, F, D), or one expert's rows (C, D) with (D, 2F) and (F, D)."""
    dt = x.dtype
    g, u = torch.matmul(x, w_in.to(dt)).chunk(2, dim=-1)
    return torch.matmul(F.silu(g) * u, w_out.to(dt))


def _shared(cfg: ModelConfig, p: Mapping, x: torch.Tensor) -> torch.Tensor:
    sp = {k[len("shared_"):]: v for k, v in p.items()
          if k.startswith("shared_")}
    return apply_ffn(cfg, sp, x)


def dense_routed(cfg: ModelConfig, p: Mapping, flat: torch.Tensor,
                 idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The routed experts' f32 sum (N, D) for rows ``flat`` (N, D) routed to
    ``idx`` with weights ``w`` (N, k): every expert on every row, combined
    with the sparse top-k weights, as the reference's oracle."""
    E = padded_experts(cfg.moe)
    combine = torch.zeros(flat.shape[0], E, dtype=flat.dtype,
                          device=flat.device).scatter_add(1, idx, w)
    every = expert_ffn(p["w_in"], p["w_out"], flat.expand(E, *flat.shape))
    return torch.einsum("ne,end->nd", combine.float(), every.float())


def dispatch_routed(cfg: ModelConfig, p: Mapping, flat: torch.Tensor,
                    idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The same sum as :func:`dense_routed` by a dropless dispatch: one host
    read of the per-expert counts (counted by ``dispatch_routed.host_syncs``),
    then each non-empty expert's products on its own rows."""
    N, k = idx.shape
    E = padded_experts(cfg.moe)
    order = torch.argsort(idx.flatten(), stable=True)
    counts = torch.bincount(idx.flatten(), minlength=E).tolist()
    dispatch_routed.host_syncs += 1
    rows = flat[order // k]                     # assignments, by expert
    outs = [expert_ffn(p["w_in"][e], p["w_out"][e], part)
            for e, part in enumerate(rows.split(counts)) if len(part)]
    back = torch.empty_like(order)
    back[order] = torch.arange(order.numel(), device=order.device)
    y = torch.cat(outs)[back].reshape(N, k, -1)     # each row's k outputs
    return (y.float() * w.float()[..., None]).sum(1)


dispatch_routed.host_syncs = 0


def _moe(routed_fn, cfg: ModelConfig, p: Mapping, x: torch.Tensor
         ) -> Tuple[torch.Tensor, Aux]:
    flat = x.reshape(-1, x.shape[-1])
    idx, w, aux = route(cfg, flat, p["router"])
    y = routed_fn(cfg, p, flat, idx, w).to(x.dtype).reshape(x.shape)
    if cfg.moe.n_shared:
        y = y + _shared(cfg, p, x)
    return y, aux_loss(cfg, aux)


def moe_dense_oracle(cfg: ModelConfig, p: Mapping, x: torch.Tensor
                     ) -> Tuple[torch.Tensor, Aux]:
    """x: (B, S, D). Every expert on every row."""
    return _moe(dense_routed, cfg, p, x)


def moe_dispatch(cfg: ModelConfig, p: Mapping, x: torch.Tensor
                 ) -> Tuple[torch.Tensor, Aux]:
    """x: (B, S, D). The dropless dispatch."""
    return _moe(dispatch_routed, cfg, p, x)


def moe_apply(cfg: ModelConfig, p: Mapping, x: torch.Tensor
              ) -> Tuple[torch.Tensor, Aux]:
    """x: (B, S, D). The model's path: the dispatch from
    ``DISPATCH_MIN_ROWS`` rows on, the dense oracle below."""
    rows = x.numel() // x.shape[-1]
    fn = moe_dispatch if rows >= DISPATCH_MIN_ROWS else moe_dense_oracle
    return fn(cfg, p, x)
