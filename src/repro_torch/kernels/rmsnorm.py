"""RMSNorm and fused residual-add + RMSNorm: CUDA kernels and plain versions.

Replaces ``repro/kernels/rmsnorm.py`` (``rmsnorm_tpu``,
``rmsnorm_residual_tpu``). Kernels: ``csrc/rmsnorm.cu``, one template in
three variants (:data:`VARIANTS`): one warp per row for rows up to
:data:`WARP_MAX_WIDTH` and one block per row up to :data:`MAX_WIDTH`, both
with 16-byte accesses, and for a row or base that is not 16-byte aligned
one block per row with one element per access. :func:`pick_variant`
chooses; the source's header says why the design is what it is.

A wrapper given CPU tensors computes the plain version; given CUDA tensors it
launches its kernel or raises. ``rmsnorm.launches`` and
``rmsnorm_residual.launches`` count the kernel launches, and ``.variant``
names the variant each launched last.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_WIDTH = 16384          # kMaxWidth in csrc/rmsnorm.cu: llama3-405b's d_model
WARP_MAX_WIDTH = 2048      # kWarpMaxWidth: one warp per row up to this width
VARIANTS = ("warp", "wide", "scalar")   # by the C entries' code


def rmsnorm_plain(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
                  ) -> torch.Tensor:
    """y = x * rsqrt(mean(x^2) + eps) * w in f32, cast to x.dtype."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def rmsnorm_residual_plain(x: torch.Tensor, r: torch.Tensor, w: torch.Tensor,
                           eps: float = 1e-5
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """s = x + r rounded to x.dtype; returns (rmsnorm(s) * w, s)."""
    s = (x.float() + r.float()).to(x.dtype)
    return rmsnorm_plain(s, w, eps), s


def pick_variant(x: torch.Tensor, *others: torch.Tensor) -> int:
    """The kernel variant (an index into :data:`VARIANTS`) for the rows of
    ``x`` read beside ``others``. Where a row's bytes are a multiple of 16
    and every base is 16-byte aligned, the warp layout up to WARP_MAX_WIDTH
    and the wide one up to MAX_WIDTH; else the scalar instantiation. Raises
    for a width no variant takes."""
    D = x.shape[-1]
    if not 0 < D <= MAX_WIDTH:
        raise ValueError(f"rows of {D} are outside the kernels' widths "
                         f"1..{MAX_WIDTH}")
    vector = (D * x.element_size() % 16 == 0
              and all(t.data_ptr() % 16 == 0 for t in (x, *others)))
    if not vector:
        return 2
    return 1 if D > WARP_MAX_WIDTH else 0


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "rmsnorm_fwd": [_P, _P, _P, _I, _I, _F, _I, _I, _P],
    "rmsnorm_residual_fwd": [_P, _P, _P, _P, _P, _I, _I, _F, _I, _I, _P],
    "rmsnorm_empty": [_P],
}


def _check(x: torch.Tensor, w: torch.Tensor, *others: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm runs on cpu or cuda tensors, got {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"rmsnorm takes float32 or bfloat16, got {x.dtype}")
    D = x.shape[-1]
    if w.dtype != torch.float32 or tuple(w.shape) != (D,):
        raise ValueError(f"scale must be float32 of shape ({D},), got "
                         f"{w.dtype} {tuple(w.shape)}")
    for t in (w, *others):
        if t.device != x.device:
            raise ValueError(f"tensors on {x.device} and {t.device}")
    for t in others:
        if t.shape != x.shape or t.dtype != x.dtype:
            raise ValueError(f"residual {t.dtype} {tuple(t.shape)} does not "
                             f"match x {x.dtype} {tuple(x.shape)}")


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    """x: (..., D); w: (D,) float32. Returns rmsnorm(x) * w in x.dtype."""
    if x.device.type == "cpu":
        return rmsnorm_plain(x, w, eps)
    _check(x, w)
    x, w = x.contiguous(), w.contiguous()
    variant = pick_variant(x, w)
    y = torch.empty_like(x)
    D = x.shape[-1]
    if x.numel() == 0:
        return y
    lib = build.load("rmsnorm", _SIGNATURES)
    with torch.cuda.device(x.device):
        err = lib.rmsnorm_fwd(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                              x.numel() // D, D, eps, _DTYPES[x.dtype],
                              variant, torch.cuda.current_stream().cuda_stream)
    build.check(err, "rmsnorm")
    rmsnorm.launches += 1
    rmsnorm.variant = VARIANTS[variant]
    return y


rmsnorm.launches = 0
rmsnorm.variant = None


def rmsnorm_residual(x: torch.Tensor, r: torch.Tensor, w: torch.Tensor,
                     eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, r: (..., D). Returns (rmsnorm(s) * w, s) with s = x + r in x.dtype."""
    if x.device.type == "cpu":
        return rmsnorm_residual_plain(x, r, w, eps)
    _check(x, w, r)
    x, r, w = x.contiguous(), r.contiguous(), w.contiguous()
    variant = pick_variant(x, r, w)
    y = torch.empty_like(x)
    s = torch.empty_like(x)
    D = x.shape[-1]
    if x.numel() == 0:
        return y, s
    lib = build.load("rmsnorm", _SIGNATURES)
    with torch.cuda.device(x.device):
        err = lib.rmsnorm_residual_fwd(
            x.data_ptr(), r.data_ptr(), w.data_ptr(), y.data_ptr(),
            s.data_ptr(), x.numel() // D, D, eps, _DTYPES[x.dtype], variant,
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "rmsnorm_residual")
    rmsnorm_residual.launches += 1
    rmsnorm_residual.variant = VARIANTS[variant]
    return y, s


rmsnorm_residual.launches = 0
rmsnorm_residual.variant = None


def launch_empty() -> None:
    """Launch the rmsnorm library's empty kernel (one block of 128 threads
    that does nothing) on the current stream: the floor under any launch's
    time. Not counted as a launch of either wrapper."""
    lib = build.load("rmsnorm", _SIGNATURES)
    build.check(lib.rmsnorm_empty(torch.cuda.current_stream().cuda_stream),
                "rmsnorm_empty")
