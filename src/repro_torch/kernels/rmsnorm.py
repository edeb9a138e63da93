"""RMSNorm and fused residual-add + RMSNorm: CUDA kernels and plain versions.

Replaces ``repro/kernels/rmsnorm.py`` (``rmsnorm_tpu``,
``rmsnorm_residual_tpu``). Kernels: ``csrc/rmsnorm.cu``. Both are bound by
device-memory bytes on the H100; the kernels read each input once and write
each output once, one block per row.

A wrapper given CPU tensors computes the plain version; given CUDA tensors it
launches its kernel or raises. ``rmsnorm.launches`` and
``rmsnorm_residual.launches`` count the kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "rmsnorm_fwd": [_P, _P, _P, _I, _I, _F, _I, _P],
    "rmsnorm_residual_fwd": [_P, _P, _P, _P, _P, _I, _I, _F, _I, _P],
    "rmsnorm_max_width": [],
}


def _checked_lib(x: torch.Tensor, w: torch.Tensor,
                 *others: torch.Tensor) -> ctypes.CDLL:
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
    lib = build.load("rmsnorm", _SIGNATURES)
    if D > lib.rmsnorm_max_width():
        raise ValueError(f"rows of {D} exceed the kernel's "
                         f"{lib.rmsnorm_max_width()}")
    return lib


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    """x: (..., D); w: (D,) float32. Returns rmsnorm(x) * w in x.dtype."""
    if x.device.type == "cpu":
        return rmsnorm_plain(x, w, eps)
    lib = _checked_lib(x, w)
    x = x.contiguous()
    w = w.contiguous()
    y = torch.empty_like(x)
    D = x.shape[-1]
    with torch.cuda.device(x.device):
        err = lib.rmsnorm_fwd(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                              x.numel() // D, D, eps, _DTYPES[x.dtype],
                              torch.cuda.current_stream().cuda_stream)
    build.check(err, "rmsnorm")
    rmsnorm.launches += 1
    return y


rmsnorm.launches = 0


def rmsnorm_residual(x: torch.Tensor, r: torch.Tensor, w: torch.Tensor,
                     eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, r: (..., D). Returns (rmsnorm(s) * w, s) with s = x + r in x.dtype."""
    if x.device.type == "cpu":
        return rmsnorm_residual_plain(x, r, w, eps)
    lib = _checked_lib(x, w, r)
    x, r, w = x.contiguous(), r.contiguous(), w.contiguous()
    y = torch.empty_like(x)
    s = torch.empty_like(x)
    D = x.shape[-1]
    with torch.cuda.device(x.device):
        err = lib.rmsnorm_residual_fwd(
            x.data_ptr(), r.data_ptr(), w.data_ptr(), y.data_ptr(),
            s.data_ptr(), x.numel() // D, D, eps, _DTYPES[x.dtype],
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "rmsnorm_residual")
    rmsnorm_residual.launches += 1
    return y, s


rmsnorm_residual.launches = 0
