"""Mixture-of-Experts FFN: token-choice top-k routing, on one device or
with expert parallelism over a mesh.

Port of ``repro/models/moe.py``. Three ways to apply the routed experts:

- :func:`moe_dense_oracle` (the reference's): every expert on every token,
  combined with the sparse top-k weights. E-fold work, but a few large
  launches and no host read.
- :func:`moe_dispatch`: a dropless dispatch on one device. The N*k
  assignments are sorted by expert (stably), the per-expert counts are
  read to the host once per call, each non-empty expert runs its two
  products on its contiguous rows, and the outputs go back to their tokens
  and are combined with the weights.
- :func:`moe_ep` (the reference's expert-parallel path): experts split
  over the ``ep_axis`` ranks of a mesh. Each rank owns a strided subset of
  its tokens (contiguous blocks for the all-gather combine), packs
  fixed-capacity per-destination buffers, exchanges them with
  ``all_to_all``, runs its local experts on a second fixed-capacity
  grouping, sends the results back, and combines with the gate weights;
  an assignment past a capacity is dropped (GShard-style), so the capacity
  factor changes the function. The per-rank outputs reassemble by a
  ``psum`` or an ``all_gather``. Its gradient runs through the same
  collectives backward (``parallel/collectives.py``): the tokens and the
  router enter each rank's share of the work through ``pvary`` (or, for
  a router held as this rank's experts' columns, an ``all_gather`` whose
  backward sums the ranks' parts), the combine is a ``psum`` or an
  invariant ``all_gather``, and the aux sums a ``psum`` over
  ``(ep_axis,) + token_axes`` divided by the EP ranks, as the reference's.

:func:`moe_apply`, the model's path, takes ``moe_ep`` when ``distributed``;
otherwise the dispatch from ``DISPATCH_MIN_ROWS`` rows on and the oracle
below. ``ServeEngine`` pads every prefill to ``max_seq`` rows, so the
choice follows its ``max_seq``; a decode step has ``max_batch`` rows.

Rounding follows the reference: the router in f32; the top-k weights
(renormalised only with ``norm_topk``) rounded to x.dtype; each expert's
products in x.dtype; the combine a product of x.dtype values summed in f32
and rounded once; then the shared block's output added. The aux terms count
every row of x, the padded rows of a prefill included, as JAX's do.
"""
from __future__ import annotations

import math
from typing import Dict, FrozenSet, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import apply_ffn, tp_apply_ffn
from repro_torch.models.params import padded_experts
from repro_torch.parallel.collectives import (all_gather, all_to_all, psum,
                                              pvary)
from repro_torch.spans import span

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
    # each expert's assignments: bincount's counts, by a scatter whose
    # output size is E (a dry run on meta cannot size bincount's)
    picks = top_i.flatten()
    counts = torch.zeros(E, dtype=torch.long, device=x.device).scatter_add_(
        0, picks, torch.ones_like(picks))
    aux = {"f_sum": counts.float(),
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


def _shared(cfg: ModelConfig, p: Mapping, x: torch.Tensor, mesh=None,
            axis: str = "model", tp_split: FrozenSet[str] = frozenset()
            ) -> torch.Tensor:
    """The shared expert block; with its hidden split over ``axis``
    (``shared_w_out`` in ``tp_split``, as a training plan leaves it),
    tensor-parallel there."""
    sp = {k[len("shared_"):]: v for k, v in p.items()
          if k.startswith("shared_")}
    if "shared_w_out" in tp_split:
        return tp_apply_ffn(cfg, sp, x, mesh, d_ff=cfg.moe.d_ff_shared,
                            axis=axis)
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
    then each non-empty expert's products on its own rows. Under a
    profiler, the call is the span ``moe.dispatch`` and the read inside it
    ``moe.host_read``."""
    with span("moe.dispatch"):
        N, k = idx.shape
        if flat.device.type == "meta":
            raise NotImplementedError(
                "dispatch_routed reads the per-expert counts on the host, "
                "which a meta tensor does not hold: a dry run reaches the "
                "MoE through moe_ep (RunFlags(distributed=True)); a dispatch "
                "without the host read is ROADMAP R8's grouped GEMM")
        E = padded_experts(cfg.moe)
        order = torch.argsort(idx.flatten(), stable=True)
        with span("moe.host_read"):
            counts = torch.bincount(idx.flatten(), minlength=E).tolist()
            dispatch_routed.host_syncs += 1
        rows = flat[order // k]                     # assignments, by expert
        outs = [expert_ffn(p["w_in"][e], p["w_out"][e], part)
                for e, part in enumerate(rows.split(counts)) if len(part)]
        back = torch.empty_like(order)
        back[order] = torch.arange(order.numel(), device=order.device)
        y = torch.cat(outs)[back].reshape(N, k, -1)  # each row's k outputs
        return (y.float() * w.float()[..., None]).sum(1)


dispatch_routed.host_syncs = 0


AUX_SUMS = ("f_sum", "p_sum", "z_sum", "n")


def _reduce_aux(aux: Aux, axes, mesh, ranks: int = 1) -> Aux:
    """The aux sums added over ``axes`` of ``mesh`` in one ``psum``, divided
    by the ``ranks`` along them that counted the same tokens."""
    sums = psum(torch.cat([aux[k].float().reshape(-1) for k in AUX_SUMS]),
                axes, mesh) / ranks
    E = aux["f_sum"].numel()
    out = dict(zip(AUX_SUMS, sums.split([E, E, 1, 1])))
    return {k: v.reshape(()) if k in ("z_sum", "n") else v
            for k, v in out.items()}


def _moe(routed_fn, cfg: ModelConfig, p: Mapping, x: torch.Tensor,
         token_axes: Sequence[str] = (), mesh=None, ep_axis: str = "model",
         tp_split: FrozenSet[str] = frozenset()
         ) -> Tuple[torch.Tensor, Aux]:
    flat = x.reshape(-1, x.shape[-1])
    idx, w, aux = route(cfg, flat, p["router"])
    y = routed_fn(cfg, p, flat, idx, w).to(x.dtype).reshape(x.shape)
    if cfg.moe.n_shared:
        y = y + _shared(cfg, p, x, mesh, ep_axis, tp_split)
    if mesh is not None and mesh.live(token_axes):
        aux = _reduce_aux(aux, token_axes, mesh)
    return y, aux_loss(cfg, aux)


def moe_dense_oracle(cfg: ModelConfig, p: Mapping, x: torch.Tensor
                     ) -> Tuple[torch.Tensor, Aux]:
    """x: (B, S, D). Every expert on every row."""
    return _moe(dense_routed, cfg, p, x)


def moe_dispatch(cfg: ModelConfig, p: Mapping, x: torch.Tensor
                 ) -> Tuple[torch.Tensor, Aux]:
    """x: (B, S, D). The dropless dispatch."""
    return _moe(dispatch_routed, cfg, p, x)


# ---------------------------------------------------------------------------
# Expert-parallel path
# ---------------------------------------------------------------------------

def ep_capacities(cfg: ModelConfig, n_rows: int, n_ranks: int
                  ) -> Tuple[int, int]:
    """(c_send, c_loc) of :func:`moe_ep` for ``n_rows`` local tokens: the
    slots a rank sends to each destination (each rank owns about
    n_rows / n_ranks tokens) and the slots of each local expert."""
    moe = cfg.moe
    E_loc = padded_experts(moe) // n_ranks
    k, cf = moe.top_k, moe.capacity_factor
    c_send = max(int(math.ceil(n_rows * k * cf / (n_ranks * n_ranks))), k, 4)
    c_loc = max(int(math.ceil(n_ranks * c_send * cf / E_loc)), 4)
    return c_send, c_loc


def _local_experts(w: torch.Tensor, E: int, E_loc: int, r: int
                   ) -> torch.Tensor:
    """This rank's experts of a stacked expert weight: the leaf itself
    when it holds E_loc (``params.serving_plan``), its block of E
    otherwise."""
    if w.shape[0] == E_loc:
        return w
    if w.shape[0] != E:
        raise ValueError(f"expert weight of {w.shape[0]} experts; expected "
                         f"{E} or this rank's {E_loc}")
    return w[r * E_loc:(r + 1) * E_loc]


def moe_ep(cfg: ModelConfig, p: Mapping, x: torch.Tensor, *,
           ep_axis: str = "model",
           token_axes: Sequence[str] = ("data",),
           combine: str = "psum", mesh=None,
           stats: Optional[dict] = None,
           tp_split: FrozenSet[str] = frozenset()
           ) -> Tuple[torch.Tensor, Aux]:
    """x: (B_loc, S, D), this rank's block of the tokens over
    ``token_axes`` (replicated over ``ep_axis``); experts split over
    ``ep_axis``, whole or as this rank's block in ``p``. ``tp_split``
    names the leaves of ``p`` a training plan splits over ``ep_axis``
    (``params.tp_split``): ``router`` held as its columns of this rank's
    experts, the shared block's hidden split; the rest are whole. Without
    a mesh, or with one rank on ``ep_axis`` or experts it does not divide,
    the dense oracle, its aux sums added over the live ``token_axes``.

    ``combine``: how the owners' outputs reassemble over ``ep_axis``:
    "psum" (each token's row is nonzero on its owner only) or "allgather"
    (contiguous ownership blocks gathered). ``moe_ep.dropped`` (a device
    count, never read here) grows by the assignments this rank dropped,
    at send and at the experts; with ``stats``, ``stats["kept"]`` is the
    (N, k) bool mask of assignments whose output came back, over every
    token (one more ``all_to_all`` and a ``psum``, for tests).
    """
    moe = cfg.moe
    E = padded_experts(moe)
    if mesh is None:
        return moe_dense_oracle(cfg, p, x)
    n_ranks = mesh.size(mesh.live((ep_axis,)))
    token_axes = mesh.live(token_axes)
    if n_ranks <= 1 or E % n_ranks != 0:
        if tuple(p["w_in"].shape) != (E, cfg.d_model, 2 * moe.d_ff_expert):
            raise NotImplementedError(
                f"{cfg.name}: the dense oracle needs every expert whole, "
                f"not blocks of {tuple(p['w_in'].shape)}")
        return _moe(dense_routed, cfg, p, x, token_axes, mesh, ep_axis,
                    tp_split)
    E_loc = E // n_ranks
    B, S, D = x.shape
    N_loc = B * S
    k = moe.top_k
    c_send, c_loc = ep_capacities(cfg, N_loc, n_ranks)
    blk = -(-N_loc // n_ranks)            # contiguous ownership block size
    dev, dt = x.device, x.dtype
    r = mesh.axis_index(ep_axis)
    w_in = _local_experts(p["w_in"], E, E_loc, r)
    w_out = _local_experts(p["w_out"], E, E_loc, r)

    router = (all_gather(p["router"], ep_axis, mesh, dim=-1)
              if "router" in tp_split else pvary(p["router"], ep_axis, mesh))
    flat = pvary(x.reshape(-1, D), ep_axis, mesh)
    n = flat.shape[0]
    idx, w, aux = route(cfg, flat, router)
    tok = torch.arange(n, device=dev)
    owner = tok // blk if combine == "allgather" else tok % n_ranks
    owned = owner == r
    a_idx = idx.reshape(-1)                                   # (n*k,)
    a_src = tok.repeat_interleave(k)
    a_valid = owned.repeat_interleave(k)
    dst = a_idx // E_loc
    e_loc = a_idx % E_loc
    # position within each destination bucket, among valid assignments
    oh = F.one_hot(dst, n_ranks) * a_valid[:, None].long()
    pos = (oh.cumsum(0) - oh).gather(1, dst[:, None])[:, 0]
    keep = a_valid & (pos < c_send)
    pos_c = torch.where(keep, pos, c_send)                    # drop slot
    send_x = torch.zeros(n_ranks, c_send + 1, D, dtype=dt, device=dev)
    send_x[dst, pos_c] = flat[a_src]
    send_e = torch.full((n_ranks, c_send + 1), E_loc, dtype=torch.int32,
                        device=dev)
    send_e[dst, pos_c] = e_loc.int()
    send_slot = torch.full((n_ranks, c_send + 1), -1, dtype=torch.long,
                           device=dev)
    send_slot[dst, pos_c] = torch.arange(n * k, device=dev)
    send_x, send_e, send_slot = (send_x[:, :c_send], send_e[:, :c_send],
                                 send_slot[:, :c_send])

    recv_x = all_to_all(send_x, ep_axis, mesh).reshape(-1, D)   # (M, D)
    recv_e = all_to_all(send_e, ep_axis, mesh).reshape(-1).long()
    # group received rows by local expert (a second fixed-capacity scatter)
    ohe = F.one_hot(recv_e, E_loc + 1)[:, :E_loc]
    e_c = recv_e.clamp_max(E_loc - 1)
    gpos = (ohe.cumsum(0) - ohe).gather(1, e_c[:, None])[:, 0]
    gvalid = (recv_e < E_loc) & (gpos < c_loc)
    gpos_c = torch.where(gvalid, gpos, c_loc)
    grp = torch.zeros(E_loc, c_loc + 1, D, dtype=dt, device=dev)
    grp[e_c, gpos_c] = recv_x
    out_grp = expert_ffn(w_in, w_out, grp[:, :c_loc])
    # ungroup to the received layout (dropped rows give zeros)
    out_recv = torch.where(gvalid[:, None],
                           out_grp[e_c, gpos.clamp_max(c_loc - 1)],
                           torch.zeros((), dtype=dt, device=dev)).to(dt)
    back = all_to_all(out_recv.reshape(n_ranks, c_send, D), ep_axis,
                      mesh).reshape(-1, D)
    # combine at the source in the original slot numbering
    slot = send_slot.reshape(-1)
    flat_y = torch.zeros(n * k, D, dtype=dt, device=dev)
    flat_y.index_add_(0, slot.clamp_min(0),
                      torch.where(slot[:, None] >= 0, back,
                                  torch.zeros((), dtype=dt, device=dev)))
    y = (flat_y.reshape(n, k, D) * w[..., None]).float().sum(1).to(dt)
    if combine == "allgather":
        pad = blk * n_ranks - n
        y_pad = F.pad(y, (0, 0, 0, pad)) if pad else y
        y = all_gather(y_pad[r * blk:(r + 1) * blk], ep_axis, mesh,
                       invariant=True)[:n]
    else:
        y = psum(y, ep_axis, mesh)
    # aux terms: equal on every EP rank, partial over token shards
    aux = _reduce_aux(aux, (ep_axis,) + tuple(token_axes), mesh, n_ranks)
    valid_recv = recv_e < E_loc
    moe_ep.dropped = moe_ep.dropped + (a_valid & ~keep).sum() \
        + (valid_recv & ~gvalid).sum()
    if stats is not None:
        came = all_to_all(gvalid.reshape(n_ranks, c_send).int(), ep_axis,
                          mesh).reshape(-1)
        kept = torch.zeros(n * k, dtype=torch.int32, device=dev)
        sent = slot >= 0
        kept[slot[sent]] = came[sent]
        stats["kept"] = psum(kept, ep_axis, mesh).reshape(n, k) > 0
    y = y.reshape(x.shape)
    if moe.n_shared:
        y = y + _shared(cfg, p, x, mesh, ep_axis, tp_split)
    return y, aux_loss(cfg, aux)


moe_ep.dropped = 0


def moe_apply(cfg: ModelConfig, p: Mapping, x: torch.Tensor, *,
              distributed: bool = False, ep_axis: str = "model",
              token_axes: Sequence[str] = ("data",),
              combine: str = "psum", mesh=None,
              tp_split: FrozenSet[str] = frozenset()
              ) -> Tuple[torch.Tensor, Aux]:
    """x: (B, S, D). The model's path: with ``distributed``, ``moe_ep``
    over ``mesh`` (``tp_split`` as there); otherwise the dispatch from
    ``DISPATCH_MIN_ROWS`` rows on and the dense oracle below."""
    if distributed:
        return moe_ep(cfg, p, x, ep_axis=ep_axis, token_axes=token_axes,
                      combine=combine, mesh=mesh, tp_split=tp_split)
    rows = x.numel() // x.shape[-1]
    fn = moe_dispatch if rows >= DISPATCH_MIN_ROWS else moe_dense_oracle
    return fn(cfg, p, x)
