"""Causal / full flash attention with GQA and a key-length mask: the CUDA
kernel and its plain version.

Replaces ``repro/kernels/flash_attention.py`` (``flash_attention_tpu``) and
takes over the ``lengths`` masking that ``repro/kernels/ops.py`` left to the
XLA path. Kernels: ``csrc/flash_attention.cu``, two of them, picked by
dtype: bfloat16 runs on the tensor cores (wgmma) with K/V tiles brought
in by TMA and reads strided q/k/v in place; float32 runs on the f32 FMA
units from contiguous tensors. At the serving shapes the work is bound by
device-memory bytes on the H100 (about 190 operations per byte, below the
bf16 ridge). The source's header says how each is laid out.

Layout is JAX's at the public function: q (B, S, H, D), k/v (B, S, KV, D)
with H a multiple of KV; head h reads KV head h // (H // KV). ``lengths``
(B,) int32 masks keys at or past lengths[b]. Masked scores are -1e30, so a
row with no valid key averages V. ``p`` is rounded to v.dtype before the PV
product. ``flash_attention.launches`` counts the kernel launches.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
HEAD_DIMS = (64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          lengths: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """The same function as the kernel, over the full f32 score matrix."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    kf = k.float().repeat_interleave(G, dim=2)
    vf = v.repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * (1.0 / math.sqrt(D))
    pos = torch.arange(S, device=q.device)
    mask = torch.ones(1, 1, S, S, dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (pos[:, None] >= pos[None, :])
    if lengths is not None:
        mask = mask & (pos[None, None, None, :]
                       < lengths.to(q.device)[:, None, None, None])
    s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), vf.float())
    o = o / torch.clamp(l, min=1e-30)
    return o.transpose(1, 2).to(q.dtype)


_P, _I = ctypes.c_void_p, ctypes.c_int
_STRIDES = ctypes.c_longlong * 9
_SIGNATURES = {"flash_attention_fwd": [
    _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.POINTER(ctypes.c_longlong),
    _I, ctypes.c_float, _I, _P]}


def _strides(t: torch.Tensor) -> tuple:
    """Element strides of (batch, seq, head) of a (B, S, heads, D) tensor; a
    dimension of size 1 gets the stride a contiguous tensor would have, since
    its stride is never read."""
    (B, S, n, D), (sb, ss, sh, sd) = t.shape, t.stride()
    sh = sh if n > 1 else D * sd
    ss = ss if S > 1 else n * sh
    return (sb if B > 1 else S * ss), ss, sh


def _in_place(t: torch.Tensor) -> tuple:
    """``t`` and its strides where the bf16 kernel's TMA can read it in
    place (head dim contiguous, 16-byte aligned base and strides), else a
    contiguous copy and its strides."""
    st = _strides(t)                    # 8 bf16 elements = 16 bytes
    if t.stride(-1) != 1 or t.data_ptr() % 16 or any(s % 8 for s in st):
        t = t.clone(memory_format=torch.contiguous_format)
        st = _strides(t)
    return t, st


def _check(q, k, v, lengths) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda tensors, got "
                         f"{q.device}")
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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B,S,H,D); k, v: (B,S,KV,D); lengths: (B,) int32 or None.
    Returns (B,S,H,D) in q.dtype."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, lengths=lengths)
    _check(q, k, v, lengths)
    lib = build.load("flash_attention", _SIGNATURES)
    B, S, H, D = q.shape
    # project_qkv's k/v are strided views of the fused kv projection: the
    # bf16 kernel reads them in place, the f32 one takes contiguous copies
    if q.dtype == torch.bfloat16:
        (q, sq), (k, sk), (v, sv) = _in_place(q), _in_place(k), _in_place(v)
    else:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        sq, sk, sv = _strides(q), _strides(k), _strides(v)
    if lengths is not None:
        lengths = lengths.contiguous()
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)   # contiguous
    with torch.cuda.device(q.device):
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lengths is None else lengths.data_ptr(),
            B, S, H, k.shape[2], D, _STRIDES(*sq, *sk, *sv), int(causal),
            1.0 / math.sqrt(D), _DTYPES[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "flash_attention")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
