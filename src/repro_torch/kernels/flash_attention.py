"""Causal / full flash attention with GQA and a key-length mask: the CUDA
kernel and its plain version.

Replaces ``repro/kernels/flash_attention.py`` (``flash_attention_tpu``) and
takes over the ``lengths`` masking that ``repro/kernels/ops.py`` left to the
XLA path. Kernels: ``csrc/flash_attention.cu``, two of them, picked by
dtype: bfloat16 runs on the tensor cores (wgmma) with K/V tiles brought
in by TMA, float32 on the f32 FMA units with tiles brought in by 16-byte
cp.async. Both read strided q/k/v in place where the base and strides are
16-byte aligned (:func:`_in_place`). At the serving shapes the bf16 work is
bound by device-memory bytes on the H100 (about 190 operations per byte,
below the bf16 ridge), the f32 work by f32 operations. The source says how
each is laid out.

Layout is JAX's at the public function: q (B, S, H, D), k/v (B, S, KV, D)
with H a multiple of KV; head h reads KV head h // (H // KV). The forward
kernels are built for head dims 64, 128 and 192 (MLA's q/k width, with V
zero-padded to it by ``models/mla.py``), the backward kernels for 64, 128
and, in bf16, 192 (:data:`BWD_HEAD_DIMS`);
:func:`flash_attention` and :func:`flash_attention_bwd` run a smaller
head dim (the smoke configs' 16) zero-padded to the next of them, with the
softmax scale of the true one: the padded terms add exact zeros, so the
result is the unpadded function. The scale is 1/sqrt(head dim) unless a
caller passes its own (``scale``: MLA under YaRN). ``lengths``
(B,) int32 masks keys at or past lengths[b]. Masked scores are -1e30, so a
row with no valid key averages V. ``p`` is rounded to v.dtype before the PV
product. ``flash_attention.launches`` counts the forward kernel's launches
and ``flash_attention.splits`` names the key split the last one ran
(:func:`key_splits`, or the tuning table's entry for the shape).

Gradients: :func:`flash_attention` goes through :class:`FlashAttentionFn`.
When a gradient is needed its forward asks the kernel for the row
log-sum-exp too, and its backward runs two more kernels of the same source
in the FlashAttention-2 form (``flash_bwd_dq``, then ``flash_bwd_dkdv``; no
atomics), or :func:`flash_attention_bwd_plain` for CPU tensors. As in the
forward, bfloat16 runs on the tensor cores and reads strided q, k, v, o
and dO in place; float32 runs on the FMA units from contiguous tensors
(:func:`_bwd_inputs` prepares them). The JAX
package has no backward kernel: its gradient is XLA's autodiff of
``repro/models/attention.py`` ``flash_attention_xla``, which these hold to.
``flash_bwd_dq.launches`` and ``flash_bwd_dkdv.launches`` count their
launches.

On ``meta`` tensors (``launch/dryrun.py``) each wrapper runs its CUDA path
up to the launch, and allocates what that path allocates (outputs, the
f32 key-split scratch, planned for the H100's SMs), but launches nothing.
:func:`flash_work` and :func:`flash_bwd_work` give a call's bytes and
FLOPs, which a counter (``launch/count.py``) records once a call.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import autotune, build
from repro_torch.launch import count

NEG_INF = -1e30
HEAD_DIMS = (64, 128, 192)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the backward kernels' head dims by dtype: MLA trains in bf16 at 192; the
# f32 K1b-dkdv tiles at 192 are over a block's shared memory (ROADMAP
# Queue 2, R9's f32 half), and no config trains in f32 on the card
BWD_HEAD_DIMS = {torch.bfloat16: (64, 128, 192), torch.float32: (64, 128)}


def _mask(S: int, causal: bool, lengths: Optional[torch.Tensor],
          device: torch.device) -> torch.Tensor:
    """(B or 1, 1, S, S) bool: the keys each query may attend."""
    pos = torch.arange(S, device=device)
    mask = torch.ones(1, 1, S, S, dtype=torch.bool, device=device)
    if causal:
        mask = mask & (pos[:, None] >= pos[None, :])
    if lengths is not None:
        mask = mask & (pos[None, None, None, :]
                       < lengths.to(device)[:, None, None, None])
    return mask


def _scale(D: int, scale: Optional[float]) -> float:
    """The softmax scale: ``scale``, by default 1/sqrt(head dim)."""
    return 1.0 / math.sqrt(D) if scale is None else scale


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool,
            lengths: Optional[torch.Tensor], scale: Optional[float] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked f32 scores (B, H, S, S) with K at KV heads, and the mask."""
    B, S, H, D = q.shape
    kf = k.float().repeat_interleave(H // k.shape[2], dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * _scale(D, scale)
    mask = _mask(S, causal, lengths, q.device)
    return torch.where(mask, s, NEG_INF), mask


def _plain_forward(q, k, v, causal, lengths, scale=None):
    """(o, lse): the plain forward and its row log-sum-exp (B, H, S) f32.
    A row with no valid key (every score -1e30) stores log(S) alone: its
    max is dropped, so the backward's exp(score - lse) gives 1/S with the
    masked scores taken as 0 (see :func:`flash_attention_bwd_plain`)."""
    s, _ = _scores(q, k, causal, lengths, scale)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    vf = v.float().repeat_interleave(q.shape[2] // k.shape[2], dim=2)
    o = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), vf)
    o = o / torch.clamp(l, min=1e-30)
    lse = torch.where(m <= NEG_INF, 0.0, m) + torch.log(l)
    return o.transpose(1, 2).to(q.dtype), lse[..., 0]


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          lengths: Optional[torch.Tensor] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """The same function as the kernel, over the full f32 score matrix."""
    return _plain_forward(q, k, v, causal, lengths, scale)[0]


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor, *,
                              causal: bool = True,
                              lengths: Optional[torch.Tensor] = None,
                              scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """(dq, dk, dv) of the forward, from its output ``o`` and row
    log-sum-exp ``lse`` (B, H, S), in f32 over the full score matrix: the
    formula the backward kernels compute.

    P = exp(score - lse). The forward rounds p to v.dtype before the PV
    product, and that cast's cotangent passes through unchanged: dV uses P
    rounded to v.dtype, the softmax gradient P in f32. dS = P (dP - Delta)
    with dP = dO V^T and Delta = rowsum(dO o); a masked score takes no
    gradient. A row with no valid key (lengths 0) has P = 1/S on every key,
    so only dV sees it. dk, dv are summed over the H / KV query heads of
    each KV head."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    s, mask = _scores(q, k, causal, lengths, scale)
    if lengths is not None:         # rows with no valid key: scores 0
        empty = (lengths.to(q.device) <= 0)[:, None, None, None]
        s = torch.where(mask, s, torch.where(empty, 0.0, NEG_INF))
    p = torch.exp(s - lse.float()[..., None])
    dof = do.float().transpose(1, 2)                        # (B, H, S, D)
    kf = k.float().repeat_interleave(G, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(G, dim=2).transpose(1, 2)
    dv = p.to(v.dtype).float().transpose(-1, -2) @ dof      # (B, H, S, D)
    dp = dof @ vf.transpose(-1, -2)
    delta = (dof * o.float().transpose(1, 2)).sum(-1, keepdim=True)
    ds = torch.where(mask, p * (dp - delta), 0.0) * _scale(D, scale)
    dq = ds @ kf
    dk = ds.transpose(-1, -2) @ q.float().transpose(1, 2)

    def per_kv(t: torch.Tensor) -> torch.Tensor:      # sum the G heads
        return t.reshape(B, KV, G, S, D).sum(2).transpose(1, 2)

    return (dq.transpose(1, 2).to(q.dtype), per_kv(dk).to(k.dtype),
            per_kv(dv).to(v.dtype))


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # q, k, v, o, lse, scratch, splits, lengths, B, S, H, KV, D, strides,
    # causal, scale, dtype, stream
    "flash_attention_fwd": [_P] * 6 + [_I, _P] + [_I] * 5 + [
        ctypes.POINTER(ctypes.c_longlong), _I, ctypes.c_float, _I, _P],
    # q, k, v, o or dk, do, lse, delta, dq or dv, lengths, B, S, H, KV, D,
    # strides, causal, scale, dtype, stream
    "flash_attention_bwd_dq": [_P] * 9 + [_I] * 5 + [
        ctypes.POINTER(ctypes.c_longlong), _I, ctypes.c_float, _I, _P],
    "flash_attention_bwd_dkdv": [_P] * 9 + [_I] * 5 + [
        ctypes.POINTER(ctypes.c_longlong), _I, ctypes.c_float, _I, _P],
}


def _strides(t: torch.Tensor) -> tuple:
    """Element strides of (batch, seq, head) of a (B, S, heads, D) tensor; a
    dimension of size 1 gets the stride a contiguous tensor would have, since
    its stride is never read."""
    (B, S, n, D), (sb, ss, sh, sd) = t.shape, t.stride()
    sh = sh if n > 1 else D * sd
    ss = ss if S > 1 else n * sh
    return (sb if B > 1 else S * ss), ss, sh


def _readable(t: torch.Tensor) -> bool:
    """Whether the kernels can read ``t`` in place: head dim contiguous,
    16-byte aligned base and strides (8 bf16 or 4 f32 elements), as TMA
    (bf16) and 16-byte cp.async (f32) need."""
    per16 = 16 // t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and not any(s % per16 for s in _strides(t)))


def _in_place(t: torch.Tensor) -> tuple:
    """``t`` and its strides where the kernels can read it in place, else a
    contiguous copy and its strides."""
    if not _readable(t):
        t = t.clone(memory_format=torch.contiguous_format)
    return t, _strides(t)


def _stride_array(*ts: torch.Tensor):
    """The (batch, seq, head) strides of each tensor, in order, as the C
    entries take them."""
    st = [s for t in ts for s in _strides(t)]
    return (ctypes.c_longlong * len(st))(*st)


# blocks that share a q tile's keys where one block per 64-row q tile would
# leave SMs idle; tools/k1_f32_breakdown.py times other counts
KEY_SPLITS = 4


def key_splits(B: int, S: int, H: int, dtype: torch.dtype, sms: int) -> int:
    """How many blocks share each 64-row q tile's keys in the f32 kernel on
    a card with ``sms`` SMs: :data:`KEY_SPLITS` where one block per q tile
    would leave SMs idle, else 1 (and always 1 in bf16). The default rule
    of ``autotune.plan_key_splits``, which a tuning-table entry for the
    shape overrides."""
    if dtype != torch.float32 or B * H * -(-S // 64) >= sms:
        return 1
    return KEY_SPLITS


def _causal_pairs(B: int, S: int, causal: bool) -> int:
    """(query, key) pairs a call scores: each query's keys up to its own
    under ``causal``, else every key."""
    return B * S * (S + 1) // 2 if causal else B * S * S


def flash_work(B: int, S: int, H: int, KV: int, D: int, dtype: torch.dtype,
               causal: bool = True) -> count.Work:
    """(bytes, FLOPs, dtype) of one forward: q and o at H heads, k and v at
    KV heads, each moved once; QK^T and PV over the scored pairs."""
    el = torch.finfo(dtype).bits // 8
    return (el * (2 * B * S * H * D + 2 * B * S * KV * D),
            4.0 * H * D * _causal_pairs(B, S, causal), dtype)


def flash_bwd_work(B: int, S: int, H: int, KV: int, D: int,
                   dtype: torch.dtype, causal: bool = True) -> count.Work:
    """(bytes, FLOPs, dtype) of one backward (K1b-dq and K1b-dkdv): q, o,
    dO and dq at H heads, k, v, dk and dv at KV heads, lse and delta; five
    products over the scored pairs (QK^T again, dO V^T, dS K, dS^T Q and
    P^T dO)."""
    el = torch.finfo(dtype).bits // 8
    qb, kb, rows = B * S * H * D * el, B * S * KV * D * el, B * H * S * 4
    return (4 * qb + 4 * kb + 2 * rows,
            2.0 * D * H * _causal_pairs(B, S, causal) * 5, dtype)


def _work(fn, q, k, causal) -> count.Work:
    B, S, H, D = q.shape
    return fn(B, S, H, k.shape[2], D, q.dtype, causal)


def _check(q, k, v, lengths) -> None:
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention runs on cpu, cuda or meta "
                         f"tensors, got {q.device}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q and k/v must be (B,S,H,D) and (B,S,KV,D), got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    B, S, H, D = q.shape
    KV = k.shape[2]
    if tuple(k.shape) != (B, S, KV, D) or v.shape != k.shape or H % KV:
        raise ValueError(f"k/v {tuple(k.shape)}, {tuple(v.shape)} do not fit "
                         f"q {tuple(q.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q/k/v of "
                        f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} is not one of {HEAD_DIMS}")
    if B > 65535 or H > 65535:
        raise ValueError(f"batch {B} and heads {H} must fit a grid "
                         f"dimension (65535)")
    for t in (k, v) if lengths is None else (k, v, lengths):
        if t.device != q.device:
            raise ValueError(f"tensors on {q.device} and {t.device}")
    if lengths is not None and (lengths.dtype != torch.int32
                                or tuple(lengths.shape) != (B,)):
        raise ValueError(f"lengths must be int32 of shape ({B},), got "
                         f"{lengths.dtype} {tuple(lengths.shape)}")


def _kernel_head_dim(D: int) -> int:
    """The head dim a kernel runs ``D`` at: the least of :data:`HEAD_DIMS`
    that holds it (``D`` itself where it is one); ``D`` beyond them all is
    returned as it is, for :func:`_check` to refuse."""
    return next((h for h in HEAD_DIMS if h >= D), D)


def _pad_head_dim(D: int, *ts: torch.Tensor) -> tuple:
    return tuple(torch.nn.functional.pad(t, (0, D - t.shape[-1]))
                 for t in ts)


def _forward(q, k, v, causal, lengths, want_lse, scale=None):
    """The kernel's output, and its row log-sum-exp (B, H, S) f32 when
    ``want_lse`` (else None)."""
    D = q.shape[-1]
    if q.dim() == 4 and _kernel_head_dim(D) != D:
        o, lse = _forward_at(*_pad_head_dim(_kernel_head_dim(D), q, k, v),
                             causal, lengths, want_lse, _scale(D, scale))
        return o[..., :D].contiguous(), lse
    return _forward_at(q, k, v, causal, lengths, want_lse, _scale(D, scale))


def _fwd(q, k, v, causal, lengths, want_lse, scale=None):
    """:func:`_forward`, or on CPU tensors the plain version's (o made
    contiguous, as the kernel's is: the model's reshape of it is then a
    view on every device)."""
    if q.device.type == "cpu":
        o, lse = _plain_forward(q, k, v, causal, lengths, scale)
        return o.contiguous(), lse
    return _forward(q, k, v, causal, lengths, want_lse, scale)


def _forward_at(q, k, v, causal, lengths, want_lse, scale):
    _check(q, k, v, lengths)
    B, S, H, D = q.shape
    # project_qkv's k/v are strided views of the fused kv projection: both
    # kernels read them in place
    q, k, v = (_in_place(t)[0] for t in (q, k, v))
    if lengths is not None:
        lengths = lengths.contiguous()
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)   # contiguous
    lse = (torch.empty(B, H, S, dtype=torch.float32, device=q.device)
           if want_lse else None)
    # each run of keys' unnormalised o, row max and denominator; a dry
    # run plans the H100's splits
    meta = q.device.type == "meta"
    splits, _ = autotune.plan_key_splits(
        B, S, H, D, q.dtype, count.H100_SMS if meta else
        torch.cuda.get_device_properties(q.device).multi_processor_count)
    scratch = (torch.empty(splits * B * H * S * (D + 2), dtype=torch.float32,
                           device=q.device) if splits > 1 else None)
    if meta:
        return o, lse
    lib = build.load("flash_attention", _SIGNATURES)
    with torch.cuda.device(q.device):
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(),
            None if scratch is None else scratch.data_ptr(), splits,
            None if lengths is None else lengths.data_ptr(),
            B, S, H, k.shape[2], D, _stride_array(q, k, v), int(causal),
            scale, _DTYPES[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "flash_attention")
    flash_attention.launches += 1
    flash_attention.splits = splits
    return o, lse


def _check_bwd(q, k, v, lengths, same_as_q, rows) -> None:
    """The backward kernels' inputs: ``same_as_q`` (o, dO) shaped and typed
    as q, ``rows`` (lse, delta) (B, H, S) f32 and contiguous; q, k, v and
    ``same_as_q`` contiguous in f32, readable by TMA in bf16."""
    _check(q, k, v, lengths)
    B, S, H, _ = q.shape
    for t in (q, k, v, *same_as_q, *rows):
        if t.device != q.device:
            raise ValueError(f"tensors on {q.device} and {t.device}")
    for t in rows:
        if not t.is_contiguous():
            raise ValueError("lse and delta must be contiguous")
    for t in (q, k, v, *same_as_q):
        if q.dtype == torch.bfloat16 and not _readable(t):
            raise ValueError("the bf16 backward kernels take tensors with a "
                             "contiguous head dim and 16-byte aligned base "
                             "and strides")
        if q.dtype == torch.float32 and not t.is_contiguous():
            raise ValueError("the f32 backward kernels take contiguous "
                             "tensors")
    for t in same_as_q:
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"o and dO must be {q.dtype} "
                             f"{tuple(q.shape)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    for t in rows:
        if tuple(t.shape) != (B, H, S) or t.dtype != torch.float32:
            raise ValueError(f"lse and delta must be float32 {(B, H, S)}, "
                             f"got {t.dtype} {tuple(t.shape)}")


def _bwd_args(q, k, lengths, *strided) -> tuple:
    B, S, H, D = q.shape
    return (None if lengths is None else lengths.data_ptr(), B, S, H,
            k.shape[2], D, _stride_array(*strided))


def flash_bwd_dq(q, k, v, o, lse, do, *, causal: bool = True,
                 lengths: Optional[torch.Tensor] = None,
                 scale: Optional[float] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel K1b-dq on CUDA tensors (bf16 ones as TMA reads them, f32 ones
    contiguous): (dq, delta), dq contiguous, delta = rowsum(dO o) (B, H, S)
    f32 for :func:`flash_bwd_dkdv`. ``scale`` is the softmax scale, by
    default 1/sqrt(head dim)."""
    lengths = None if lengths is None else lengths.contiguous()
    _check_bwd(q, k, v, lengths, (o, do), (lse,))
    B, S, H, D = q.shape
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    delta = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
    if q.device.type == "meta":
        return dq, delta
    lib = build.load("flash_attention", _SIGNATURES)
    with torch.cuda.device(q.device):
        err = lib.flash_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            *_bwd_args(q, k, lengths, q, k, v, o, do), int(causal),
            _scale(D, scale), _DTYPES[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "flash_bwd_dq")
    flash_bwd_dq.launches += 1
    return dq, delta


flash_bwd_dq.launches = 0


def flash_bwd_dkdv(q, k, v, do, lse, delta, *, causal: bool = True,
                   lengths: Optional[torch.Tensor] = None,
                   scale: Optional[float] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel K1b-dkdv on CUDA tensors taken as :func:`flash_bwd_dq` takes
    them: (dk, dv) at KV heads, contiguous, each summed over its query
    heads inside one block."""
    lengths = None if lengths is None else lengths.contiguous()
    _check_bwd(q, k, v, lengths, (do,), (lse, delta))
    D = q.shape[-1]
    dk, dv = (torch.empty(k.shape, dtype=k.dtype, device=k.device)
              for _ in range(2))
    if q.device.type == "meta":
        return dk, dv
    lib = build.load("flash_attention", _SIGNATURES)
    with torch.cuda.device(q.device):
        err = lib.flash_attention_bwd_dkdv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dk.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dv.data_ptr(),
            *_bwd_args(q, k, lengths, q, k, v, do), int(causal),
            _scale(D, scale), _DTYPES[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "flash_bwd_dkdv")
    flash_bwd_dkdv.launches += 1
    return dk, dv


flash_bwd_dkdv.launches = 0


def _bwd_inputs(q, k, v, o, do, lse) -> tuple:
    """(q, k, v, o, do, lse) as the backward kernels take them: in bf16 each
    of q, k, v, o and dO as it is where TMA can read it (project_qkv's k/v
    views of the fused kv projection are), a contiguous copy only where it
    cannot; in f32 contiguous copies; lse contiguous."""
    if q.dtype == torch.bfloat16:
        q, k, v, o, do = (_in_place(t)[0] for t in (q, k, v, o, do))
    else:
        q, k, v, o, do = (t.contiguous() for t in (q, k, v, o, do))
    return q, k, v, o, do, lse.contiguous()


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool = True,
                        lengths: Optional[torch.Tensor] = None,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv): :func:`flash_attention_bwd_plain` for CPU tensors,
    else K1b-dq then K1b-dkdv on the inputs :func:`_bwd_inputs` gives (a
    small head dim zero-padded, as the forward runs it), at the softmax
    ``scale`` of the forward (by default 1/sqrt(head dim))."""
    c = count.ACTIVE
    if c is None:
        return _bwd(q, k, v, o, lse, do, causal, lengths, scale)
    with c.kernel("flash_attention_bwd", _work(flash_bwd_work, q, k, causal)):
        return _bwd(q, k, v, o, lse, do, causal, lengths, scale)


def _bwd(q, k, v, o, lse, do, causal, lengths, scale=None):
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                         lengths=lengths, scale=scale)
    return _kernel_bwd(q, k, v, o, lse, do, causal, lengths, scale)


def _kernel_bwd(q, k, v, o, lse, do, causal, lengths, scale=None):
    D = q.shape[-1]
    Dk = _kernel_head_dim(D)
    dims = BWD_HEAD_DIMS.get(q.dtype, ())
    if Dk not in dims:
        raise NotImplementedError(
            f"the {q.dtype} backward kernels run head dims {dims}, not {Dk} "
            f"(ROADMAP Queue 2, R9: K1b f32 at head dim 192)")
    if q.dim() == 4 and Dk != D:
        q, k, v, o, do = _pad_head_dim(Dk, q, k, v, o, do)
    q, k, v, o, do, lse = _bwd_inputs(q, k, v, o, do, lse)
    scale = _scale(D, scale)
    dq, delta = flash_bwd_dq(q, k, v, o, lse, do, causal=causal,
                             lengths=lengths, scale=scale)
    dk, dv = flash_bwd_dkdv(q, k, v, do, lse, delta, causal=causal,
                            lengths=lengths, scale=scale)
    if Dk != D:
        dq, dk, dv = (t[..., :D].contiguous() for t in (dq, dk, dv))
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with a kernel backward. The forward asks for the row
    log-sum-exp only when an input needs a gradient, so under
    ``torch.inference_mode`` it launches exactly the forward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal, lengths, scale=None):
        want = any(ctx.needs_input_grad[:3])
        c = count.ACTIVE
        if c is None:
            o, lse = _fwd(q, k, v, causal, lengths, want, scale)
        else:
            with c.kernel("flash_attention", _work(flash_work, q, k, causal)):
                o, lse = _fwd(q, k, v, causal, lengths, want, scale)
        if want:
            ctx.save_for_backward(q, k, v, o, lse, lengths)
            ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, lengths = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do,
                                         causal=ctx.causal, lengths=lengths,
                                         scale=ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    lengths: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,S,H,D); k, v: (B,S,KV,D); lengths: (B,) int32 or None;
    ``scale`` the softmax scale, by default 1/sqrt(D) (MLA's YaRN passes
    its own). Returns (B,S,H,D) in q.dtype, differentiable in q, k and
    v."""
    return FlashAttentionFn.apply(q, k, v, causal, lengths, scale)


flash_attention.launches = 0
flash_attention.splits = None
