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
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.mamba import _causal_conv, gather_window
from repro_torch.models.params import mlstm_dims, slstm_dims

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


def _mlstm_qkv(cfg: ModelConfig, p: Mapping, x: torch.Tensor):
    """x (B, S, D) -> q, k, v (B, S, nh, dh) in x's dtype, the gate
    pre-activations (B, S, nh) in f32, the gate z and the post-conv uc
    (B, S, di), and the pre-conv u the conv cache keeps."""
    di, nh, dh = mlstm_dims(cfg)
    dt = x.dtype
    B, S, _ = x.shape
    u, z = (x @ p["w_up"].to(dt)).chunk(2, -1)
    uc = F.silu(_causal_conv(u, p["conv_w"], p["conv_b"]))
    q = (uc @ p["wq"].to(dt)).reshape(B, S, nh, dh)
    k = (uc @ p["wk"].to(dt)).reshape(B, S, nh, dh) / _key_scale(dh, dt)
    v = (u @ p["wv"].to(dt)).reshape(B, S, nh, dh)
    i_pre = (u @ p["w_i"].to(dt) + p["b_i"].to(dt)).float()
    f_pre = (u @ p["w_f"].to(dt) + p["b_f"].to(dt)).float()
    return q, k, v, i_pre, f_pre, z, uc, u


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
                want_cache: bool = False
                ) -> Tuple[torch.Tensor, Optional[Cache]]:
    """The sequence pass. x: (B, S, D). Returns (y, the prefill cache after
    ``lengths`` tokens (all S without) or None)."""
    di, nh, dh = mlstm_dims(cfg)
    B, S, _ = x.shape
    dt = x.dtype
    q, k, v, i_pre, f_pre, z, uc, u = _mlstm_qkv(cfg, p, x)

    def step(carry, t):
        C, n, m, h = _mlstm_step(*carry, *t)
        return (C, n, m), h

    c0 = mlstm_init_cache(cfg, B, x.device)
    last = _last(x, lengths) if want_cache else None
    state, hs = _chunked_time_scan(
        step, (c0["C"], c0["n"], c0["m"]),
        (q.float(), k.float(), v.float(), i_pre, _log_sigmoid(f_pre)), last)
    h = hs.reshape(B, S, di).to(dt)
    h = h + uc * p["skip_scale"].to(dt)
    y = (h * F.silu(z)) @ p["w_down"].to(dt)
    if not want_cache:
        return y, None
    conv = gather_window(u, last + 1, cfg.xlstm.conv_width - 1)
    return y, dict(zip(("C", "n", "m"), state), conv=conv.to(torch.bfloat16))


def mlstm_decode(cfg: ModelConfig, p: Mapping, x: torch.Tensor, cache: Cache,
                 lengths: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Cache]:
    """One token. x: (B, 1, D); cache as :func:`mlstm_init_cache`. The
    window's conv is one product plus the bias, as the reference's decode
    sums it. Returns (y (B, 1, D), the new cache)."""
    di, nh, dh = mlstm_dims(cfg)
    dt = x.dtype
    B = x.shape[0]
    u, z = (x[:, 0] @ p["w_up"].to(dt)).chunk(2, -1)
    window = torch.cat([cache["conv"].to(dt), u[:, None]], 1)
    uc = F.silu(torch.einsum("bcd,dc->bd", window, p["conv_w"].to(dt))
                + p["conv_b"].to(dt))
    q = (uc @ p["wq"].to(dt)).reshape(B, nh, dh)
    k = (uc @ p["wk"].to(dt)).reshape(B, nh, dh) / _key_scale(dh, dt)
    v = (u @ p["wv"].to(dt)).reshape(B, nh, dh)
    i_pre = (u @ p["w_i"].to(dt) + p["b_i"].to(dt)).float()
    f_pre = (u @ p["w_f"].to(dt) + p["b_f"].to(dt)).float()
    C, n, m, h = _mlstm_step(cache["C"], cache["n"], cache["m"], q.float(),
                             k.float(), v.float(), i_pre, _log_sigmoid(f_pre))
    h = h.reshape(B, di).to(dt)
    h = h + uc * p["skip_scale"].to(dt)
    y = ((h * F.silu(z)) @ p["w_down"].to(dt))[:, None]
    return y, {"C": C, "n": n, "m": m, "conv": window[:, 1:].to(torch.bfloat16)}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

GATES = ("z", "i", "f", "o")


def _slstm_gates(cfg: ModelConfig, p: Mapping, x: torch.Tensor
                 ) -> torch.Tensor:
    """The gates' input pre-activations, x @ w_g + b_g in x's dtype, then
    f32: (B, S, 4, nh, dh) in ``GATES`` order."""
    nh, dh = slstm_dims(cfg)
    B, S, _ = x.shape
    dt = x.dtype
    return torch.stack([(x @ p[f"w_{g}"].to(dt) + p[f"b_{g}"].to(dt)
                         ).reshape(B, S, nh, dh) for g in GATES], 2).float()


def _recurrent(p: Mapping) -> torch.Tensor:
    """The four recurrent matrices in f32, (4, nh, dh, dh)."""
    return torch.stack([p[f"r_{g}"].float() for g in GATES])


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
                want_cache: bool = False
                ) -> Tuple[torch.Tensor, Optional[Cache]]:
    """The sequence pass. x: (B, S, D). Returns (y, the prefill cache after
    ``lengths`` tokens (all S without) or None)."""
    B, S, D = x.shape
    dt = x.dtype
    r = _recurrent(p)

    def step(state, t):
        state = _slstm_step(r, state, t[0])
        return state, state[2]

    c0 = slstm_init_cache(cfg, B, x.device)
    last = _last(x, lengths) if want_cache else None
    state, hs = _chunked_time_scan(
        step, tuple(c0[k] for k in ("c", "n", "h", "m")),
        (_slstm_gates(cfg, p, x),), last)
    y = hs.reshape(B, S, D).to(dt) @ p["w_out"].to(dt)
    return y, (dict(zip(("c", "n", "h", "m"), state)) if want_cache else None)


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
