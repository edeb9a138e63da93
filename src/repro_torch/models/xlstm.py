"""xLSTM mixers: mLSTM (matrix memory) and sLSTM (scalar memory). Port of
``repro/models/xlstm.py``.

Both run the stabilized recurrent form (exponential gating with a running
stabilizer ``m``) one step at a time over the sequence. The state is f32
(``m`` starts at -1e30), the projections run in the activation dtype, and
the mLSTM's conv cache holds its last ``conv_width - 1`` pre-conv rows in
bf16, as in the reference. Everything elementwise that does not depend on
the state (the f32 casts of q, k and v, log sigmoid of the forget gate) is
taken for the whole sequence before the loop.

With ``want_cache`` a sequence pass also returns the prefill cache: each
row's state after its last valid step, ``lengths - 1``, snapshotted as
the pass goes (the initial state for an empty row). The reference runs a
second, masked scan for it (``xlstm_prefill_cache``); the state is the
same, and the outputs of the pass are the unmasked ones.

Over a mesh (``mesh``; tensor parallelism over its ``model`` axis, as
GSPMD partitions the reference under ``DEFAULT_RULES``' ``dinner``) the
cache keeps the reference's layout (``parallel.sharding.cache_specs``):
the mLSTM's conv window is the rank's block of d_inner, its C, n and m and
all of the sLSTM's state are whole on every rank, and so are the
recurrences. The mLSTM's leaves are the rank's d_inner block: ``w_up``
its [u | z] columns (stored grouped, ``params.grouped_columns``), the
conv, ``skip_scale`` and the rows of ``wq``, ``wk``, ``wv``, ``w_i``,
``w_f`` and ``w_down``. q, k, v and both gates are the sums of the
ranks' partial products, taken in f32 in one psum, so the heads'
recurrence runs whole; the skip, the gate z and ``w_down`` then take the
rank's block of h, and ``w_down``'s partials are summed
(``layers.row_parallel``). The sLSTM's ``w_g``/``b_g`` hold the rank's
output columns, and its ``r_g`` (nh, dh, dh) the rank's rows of every
head's input dim, which do not line up with the heads the columns hold:
each ``r_g`` is gathered once a block (:func:`_gather_recurrent`) and the
gates' input pre-activations once a pass, so the recurrence runs whole
with no collective in its time loop, and the whole h meets ``w_out``,
which every rank holds whole.
"""
from __future__ import annotations

from typing import (Callable, Dict, FrozenSet, Mapping, Optional,
                    Sequence, Tuple)

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import TP_AXIS, row_parallel
from repro_torch.models.mamba import _causal_conv, gather_window
from repro_torch.models.params import mlstm_dims, slstm_dims
from repro_torch.parallel.collectives import all_gather, psum, pvary

Cache = Dict[str, torch.Tensor]
State = Tuple[torch.Tensor, ...]

TIME_CHUNK = 64    # steps a checkpointed chunk holds when a graph is built
M_INIT = -1e30     # the stabilizer's start


def _chunked_time_scan(step: Callable, carry: State,
                       xs: Sequence[torch.Tensor],
                       last: Optional[torch.Tensor] = None
                       ) -> Tuple[State, torch.Tensor]:
    """``step(carry, inputs at t) -> (carry, y_t)`` over axis 1 of every
    tensor in ``xs``. Returns (the final carry, or with ``last`` each row's
    carry after step ``last[b]`` (the initial carry where it is < 0), the
    y_t stacked on axis 1).

    When a graph is being built, the steps run in chunks of ``TIME_CHUNK``
    (halved until it divides S, as the reference's rule), each under
    ``torch.utils.checkpoint``: the backward keeps only the chunks'
    boundary carries and recomputes the steps inside one. Otherwise, and
    where the chunk would shrink to 1, the steps run in one plain loop."""
    S = xs[0].shape[1]
    chunk = TIME_CHUNK
    while S % chunk:
        chunk //= 2
    remat = chunk > 1 and torch.is_grad_enabled()
    if not remat:
        chunk = S
    snap = carry if last is not None else None

    def run(t0: int, carry: State, snap: Optional[State], *part):
        ys = []
        for j in range(part[0].shape[1]):
            carry, y = step(carry, [a[:, j] for a in part])
            ys.append(y)
            if snap is not None:
                hit = last == t0 + j
                snap = tuple(torch.where(hit.view((-1,) + (1,) * (c.dim() - 1)),
                                         c, s) for c, s in zip(carry, snap))
        return carry, snap, torch.stack(ys, 1)

    ys = []
    for t0 in range(0, S, chunk):
        part = [a[:, t0:t0 + chunk] for a in xs]
        if remat:
            carry, snap, y = checkpoint(run, t0, carry, snap, *part,
                                        use_reentrant=False)
        else:
            carry, snap, y = run(t0, carry, snap, *part)
        ys.append(y)
    return (carry if last is None else snap), torch.cat(ys, 1)


def _last(x: torch.Tensor, lengths: Optional[torch.Tensor]) -> torch.Tensor:
    """Each row's last valid step: lengths - 1, or S - 1 without lengths."""
    B, S = x.shape[:2]
    if lengths is None:
        return torch.full((B,), S - 1, device=x.device)
    return lengths.long() - 1


def _log_sigmoid(f_pre: torch.Tensor) -> torch.Tensor:
    return -F.softplus(-f_pre)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def _key_scale(dh: int, dt: torch.dtype) -> float:
    """sqrt(dh) taken in the activation dtype, as the reference's
    ``jnp.sqrt(jnp.asarray(dh, dt))``: 19.625 in bf16 at dh = 384."""
    return torch.tensor(dh, dtype=dt).sqrt().item()


def _mlstm_proj(p: Mapping, uc: torch.Tensor, u: torch.Tensor, mesh,
                axis: str) -> Tuple[torch.Tensor, ...]:
    """uc @ wq, uc @ wk, u @ wv, u @ w_i and u @ w_f in the activation
    dtype. Over ``mesh`` the rows are this rank's channels: the five
    partial products in f32, summed in one psum, each rounded once, as
    ``layers.row_parallel`` sums one."""
    ws = [(uc, p["wq"]), (uc, p["wk"]), (u, p["wv"]), (u, p["w_i"]),
          (u, p["w_f"])]
    if mesh is None:
        return tuple(a @ w.to(a.dtype) for a, w in ws)
    parts = torch.cat([a.float() @ w.to(a.dtype).float() for a, w in ws], -1)
    total = psum(parts, axis, mesh).to(u.dtype)
    return total.split([w.shape[-1] for _, w in ws], -1)


def _mlstm_qkv(cfg: ModelConfig, p: Mapping, x: torch.Tensor, mesh=None,
               axis: str = TP_AXIS):
    """x (B, S, D) -> q, k, v (B, S, nh, dh) in x's dtype, the gate
    pre-activations (B, S, nh) in f32, the gate z and the post-conv uc
    (B, S, di), and the pre-conv u the conv cache keeps. Over ``mesh`` z,
    uc and u are this rank's channels and the rest whole."""
    di, nh, dh = mlstm_dims(cfg)
    dt = x.dtype
    B, S, _ = x.shape
    if mesh is not None:
        x = pvary(x, axis, mesh)
    u, z = (x @ p["w_up"].to(dt)).chunk(2, -1)
    uc = F.silu(_causal_conv(u, p["conv_w"], p["conv_b"]))
    q, k, v, i_w, f_w = _mlstm_proj(p, uc, u, mesh, axis)
    q = q.reshape(B, S, nh, dh)
    k = k.reshape(B, S, nh, dh) / _key_scale(dh, dt)
    v = v.reshape(B, S, nh, dh)
    i_pre = (i_w + p["b_i"].to(dt)).float()
    f_pre = (f_w + p["b_f"].to(dt)).float()
    return q, k, v, i_pre, f_pre, z, uc, u


def _mlstm_out(p: Mapping, h: torch.Tensor, uc: torch.Tensor,
               z: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """(h + skip_scale uc) silu(z) @ w_down. h is whole; over ``mesh`` uc
    and z are this rank's channels, so it takes its block of h (entering
    its own work, ``pvary``) and ``w_down``'s partials are summed."""
    dt = h.dtype
    if mesh is not None:
        w = uc.shape[-1]
        i = mesh.axis_index(mesh.live((axis,)))
        h = pvary(h, axis, mesh)[..., i * w:(i + 1) * w]
    h = (h + uc * p["skip_scale"].to(dt)) * F.silu(z)
    if mesh is None:
        return h @ p["w_down"].to(dt)
    return row_parallel(h, p["w_down"], mesh, axis)


def _mlstm_step(C: torch.Tensor, n: torch.Tensor, m: torch.Tensor,
                q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                i_pre: torch.Tensor, logf: torch.Tensor):
    """One step. C (B, nh, dh, dh), n (B, nh, dh), m (B, nh); q, k, v (B,
    nh, dh) in f32; i_pre and logf = log sigmoid(f_pre) (B, nh). Returns
    (C, n, m, h (B, nh, dh))."""
    lm = logf + m
    m_new = torch.maximum(lm, i_pre)
    i_s = torch.exp(i_pre - m_new)
    f_s = torch.exp(lm - m_new)
    C = f_s[..., None, None] * C + i_s[..., None, None] * (
        v[..., :, None] * k[..., None, :])
    n = f_s[..., None] * n + i_s[..., None] * k
    num = (C @ q[..., None])[..., 0]
    den = torch.maximum((n * q).sum(-1).abs(), torch.exp(-m_new))
    return C, n, m_new, num / den[..., None]


def mlstm_init_cache(cfg: ModelConfig, batch: int, device: torch.device
                     ) -> Cache:
    di, nh, dh = mlstm_dims(cfg)
    dc = cfg.xlstm.conv_width
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros(batch, nh, dh, dh, **f32),
            "n": torch.zeros(batch, nh, dh, **f32),
            "m": torch.full((batch, nh), M_INIT, **f32),
            "conv": torch.zeros(batch, dc - 1, di, dtype=torch.bfloat16,
                                device=device)}


def mlstm_mixer(cfg: ModelConfig, p: Mapping, x: torch.Tensor,
                positions: Optional[torch.Tensor] = None, *,
                lengths: Optional[torch.Tensor] = None,
                want_cache: bool = False, mesh=None, axis: str = TP_AXIS
                ) -> Tuple[torch.Tensor, Optional[Cache]]:
    """The sequence pass. x: (B, S, D), the same on every rank over
    ``mesh``, where ``p`` is this rank's block (module docstring). Returns
    (y, the prefill cache after ``lengths`` tokens (all S without) or
    None)."""
    di, nh, dh = mlstm_dims(cfg)
    B, S, _ = x.shape
    dt = x.dtype
    q, k, v, i_pre, f_pre, z, uc, u = _mlstm_qkv(cfg, p, x, mesh, axis)

    def step(carry, t):
        C, n, m, h = _mlstm_step(*carry, *t)
        return (C, n, m), h

    c0 = mlstm_init_cache(cfg, B, x.device)
    last = _last(x, lengths) if want_cache else None
    state, hs = _chunked_time_scan(
        step, (c0["C"], c0["n"], c0["m"]),
        (q.float(), k.float(), v.float(), i_pre, _log_sigmoid(f_pre)), last)
    y = _mlstm_out(p, hs.reshape(B, S, di).to(dt), uc, z, mesh, axis)
    if not want_cache:
        return y, None
    conv = gather_window(u, last + 1, cfg.xlstm.conv_width - 1)
    return y, dict(zip(("C", "n", "m"), state), conv=conv.to(torch.bfloat16))


def tp_mlstm_mixer(cfg: ModelConfig, p: Mapping, x: torch.Tensor,
                   positions: Optional[torch.Tensor] = None, *,
                   lengths: Optional[torch.Tensor] = None, mesh,
                   axis: str = TP_AXIS,
                   tp_split: FrozenSet[str] = frozenset()) -> torch.Tensor:
    """The training plan's sequence pass: tensor-parallel over ``axis``
    where the plan splits d_inner (``w_up`` in ``tp_split``), else on the
    whole leaves."""
    return mlstm_mixer(cfg, p, x, lengths=lengths, axis=axis,
                       mesh=mesh if "w_up" in tp_split else None)[0]


def mlstm_decode(cfg: ModelConfig, p: Mapping, x: torch.Tensor, cache: Cache,
                 lengths: Optional[torch.Tensor] = None, *, mesh=None,
                 axis: str = TP_AXIS) -> Tuple[torch.Tensor, Cache]:
    """One token. x: (B, 1, D); cache as :func:`mlstm_init_cache`, its conv
    window this rank's block of d_inner over ``mesh`` (as ``p``). The
    window's conv is one product plus the bias, as the reference's decode
    sums it. Returns (y (B, 1, D), the new cache)."""
    di, nh, dh = mlstm_dims(cfg)
    dt = x.dtype
    B = x.shape[0]
    if mesh is not None:
        x = pvary(x, axis, mesh)
    u, z = (x[:, 0] @ p["w_up"].to(dt)).chunk(2, -1)
    window = torch.cat([cache["conv"].to(dt), u[:, None]], 1)
    uc = F.silu(torch.einsum("bcd,dc->bd", window, p["conv_w"].to(dt))
                + p["conv_b"].to(dt))
    q, k, v, i_w, f_w = _mlstm_proj(p, uc, u, mesh, axis)
    q = q.reshape(B, nh, dh)
    k = k.reshape(B, nh, dh) / _key_scale(dh, dt)
    v = v.reshape(B, nh, dh)
    i_pre = (i_w + p["b_i"].to(dt)).float()
    f_pre = (f_w + p["b_f"].to(dt)).float()
    C, n, m, h = _mlstm_step(cache["C"], cache["n"], cache["m"], q.float(),
                             k.float(), v.float(), i_pre, _log_sigmoid(f_pre))
    y = _mlstm_out(p, h.reshape(B, di).to(dt), uc, z, mesh, axis)[:, None]
    return y, {"C": C, "n": n, "m": m, "conv": window[:, 1:].to(torch.bfloat16)}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

GATES = ("z", "i", "f", "o")


def _slstm_gates(cfg: ModelConfig, p: Mapping, x: torch.Tensor, mesh=None,
                 axis: str = TP_AXIS) -> torch.Tensor:
    """The gates' input pre-activations, x @ w_g + b_g in x's dtype, then
    f32: (B, S, 4, nh, dh) in ``GATES`` order. Over ``mesh`` ``w_g`` and
    ``b_g`` hold this rank's output columns: each rank's (B, S, 4, D / n)
    are gathered whole (used alike on every rank)."""
    nh, dh = slstm_dims(cfg)
    B, S, _ = x.shape
    dt = x.dtype
    if mesh is not None:
        x = pvary(x, axis, mesh)
    pre = torch.stack([x @ p[f"w_{g}"].to(dt) + p[f"b_{g}"].to(dt)
                       for g in GATES], 2)
    if mesh is not None:
        pre = all_gather(pre, axis, mesh, dim=-1, invariant=True)
    return pre.reshape(B, S, 4, nh, dh).float()


def _gather_recurrent(r: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """A recurrent matrix (nh, dh, dh) whole from every rank's rows of each
    head's input dim: gathered once a block, used alike on every rank, so
    its backward keeps this rank's rows."""
    return all_gather(r, axis, mesh, dim=1, invariant=True)


def _recurrent(p: Mapping, mesh=None, axis: str = TP_AXIS) -> torch.Tensor:
    """The four recurrent matrices in f32, (4, nh, dh, dh); over ``mesh``
    each gathered from the ranks' rows (:func:`_gather_recurrent`)."""
    rs = [p[f"r_{g}"].float() for g in GATES]
    if mesh is not None:
        rs = [_gather_recurrent(r, mesh, axis) for r in rs]
    return torch.stack(rs)


def _slstm_step(r: torch.Tensor, state: State, pre: torch.Tensor) -> State:
    """One step. state (c, n, h, m), each (B, nh, dh); pre (B, 4, nh, dh)
    the gates' input pre-activations; r :func:`_recurrent`'s."""
    c, n, h, m = state
    g = pre + torch.einsum("bhd,ghde->bghe", h, r)
    z, o = torch.tanh(g[:, 0]), torch.sigmoid(g[:, 3])
    i_pre, lm = g[:, 1], _log_sigmoid(g[:, 2]) + m
    m_new = torch.maximum(lm, i_pre)
    i_s = torch.exp(i_pre - m_new)
    f_s = torch.exp(lm - m_new)
    c = f_s * c + i_s * z
    n = f_s * n + i_s
    return c, n, o * c / torch.clamp(n, min=1e-6), m_new


def slstm_init_cache(cfg: ModelConfig, batch: int, device: torch.device
                     ) -> Cache:
    nh, dh = slstm_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros(batch, nh, dh, **f32),
            "n": torch.zeros(batch, nh, dh, **f32),
            "h": torch.zeros(batch, nh, dh, **f32),
            "m": torch.full((batch, nh, dh), M_INIT, **f32)}


def slstm_mixer(cfg: ModelConfig, p: Mapping, x: torch.Tensor,
                positions: Optional[torch.Tensor] = None, *,
                lengths: Optional[torch.Tensor] = None,
                want_cache: bool = False, gates_mesh=None,
                recurrent_mesh=None, axis: str = TP_AXIS
                ) -> Tuple[torch.Tensor, Optional[Cache]]:
    """The sequence pass. x: (B, S, D). Returns (y, the prefill cache after
    ``lengths`` tokens (all S without) or None). Over ``gates_mesh``
    ``w_g``/``b_g`` are this rank's columns, over ``recurrent_mesh``
    ``r_g`` its rows (module docstring)."""
    B, S, D = x.shape
    dt = x.dtype
    r = _recurrent(p, recurrent_mesh, axis)

    def step(state, t):
        state = _slstm_step(r, state, t[0])
        return state, state[2]

    c0 = slstm_init_cache(cfg, B, x.device)
    last = _last(x, lengths) if want_cache else None
    state, hs = _chunked_time_scan(
        step, tuple(c0[k] for k in ("c", "n", "h", "m")),
        (_slstm_gates(cfg, p, x, gates_mesh, axis),), last)
    y = hs.reshape(B, S, D).to(dt) @ p["w_out"].to(dt)
    return y, (dict(zip(("c", "n", "h", "m"), state)) if want_cache else None)


def tp_slstm_mixer(cfg: ModelConfig, p: Mapping, x: torch.Tensor,
                   positions: Optional[torch.Tensor] = None, *,
                   lengths: Optional[torch.Tensor] = None, mesh,
                   axis: str = TP_AXIS,
                   tp_split: FrozenSet[str] = frozenset()) -> torch.Tensor:
    """The training plan's sequence pass: the gates' columns over ``axis``
    where the plan splits them (``w_z`` in ``tp_split``), the recurrent
    matrices gathered where it splits them (``r_z``); each part on whole
    leaves where it does not."""
    return slstm_mixer(
        cfg, p, x, lengths=lengths, axis=axis,
        gates_mesh=mesh if "w_z" in tp_split else None,
        recurrent_mesh=mesh if "r_z" in tp_split else None)[0]


def slstm_decode(cfg: ModelConfig, p: Mapping, x: torch.Tensor, cache: Cache,
                 lengths: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Cache]:
    """One token. x: (B, 1, D). Returns (y (B, 1, D), the new cache)."""
    dt = x.dtype
    state = _slstm_step(_recurrent(p),
                        tuple(cache[k] for k in ("c", "n", "h", "m")),
                        _slstm_gates(cfg, p, x)[:, 0])
    y = (state[2].reshape(x.shape[0], -1).to(dt) @ p["w_out"].to(dt))[:, None]
    return y, dict(zip(("c", "n", "h", "m"), state))


def xlstm_prefill_cache(cfg: ModelConfig, mixer: str, p: Mapping,
                        x: torch.Tensor, lengths: torch.Tensor) -> Cache:
    """The state after ``lengths`` tokens of x (the reference's function;
    the model takes it from the mixer's own pass)."""
    mix = mlstm_mixer if mixer == "mlstm" else slstm_mixer
    return mix(cfg, p, x, lengths=lengths, want_cache=True)[1]
