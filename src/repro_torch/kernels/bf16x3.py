"""An f32 matrix as three exact bf16 terms: ``csrc/bf16x3.cu`` on the card,
beside its plain version.

The unembedding's backward on tensor cores (``models/layers.py``
``UnembedProduct``) takes its f32 cotangent as hi + mid + lo bf16 terms, so
that bf16 GEMMs with f32 accumulation form the f32 product's exact
products. The kernel makes the three terms in one pass: 4 bytes read and 6
written an element, where the plain version's five PyTorch ops move 38.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.launch import count

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    # g, ld, parts, rows, cols, vec, stream
    "split_bf16x3": [_P, _LL, _P, _LL, _LL, _I, _P],
}


def split_work(rows: int, cols: int) -> count.Work:
    """(bytes, FLOPs, dtype) of one split: each f32 element read once,
    its three bf16 terms written once; no product."""
    return rows * cols * (4 + 3 * 2), 0.0, torch.float32


def split_bf16x3_plain(g: torch.Tensor) -> torch.Tensor:
    """The split in PyTorch ops: hi = bf16(g), mid = bf16(g - hi), lo =
    bf16(g - hi - mid), each rounded to nearest, as (N, 3, C) in the
    order lo, mid, hi."""
    parts = torch.empty(g.shape[0], 3, g.shape[1], dtype=torch.bfloat16,
                        device=g.device)
    parts[:, 2] = g
    rest = g - parts[:, 2]
    parts[:, 1] = rest
    rest -= parts[:, 1]
    parts[:, 0] = rest
    return parts


def split_bf16x3(g: torch.Tensor) -> torch.Tensor:
    """An f32 matrix g (N, C) as three bf16 terms (N, 3, C), in ascending
    order lo, mid, hi: hi = bf16(g), mid = bf16(g - hi), lo = bf16(g - hi
    - mid), each rounded to nearest. (hi + mid) + lo is g bit for bit
    wherever |g| is 0 or at least 2**-110 (below, lo misses the bits under
    bf16's least subnormal, 2**-133; -0 comes back +0) and hi is finite.
    g's columns must be adjacent; its rows may lie any distance apart (a
    block of columns of a wider matrix). The kernel on the card, the
    plain version on the CPU."""
    if g.dtype != torch.float32 or g.dim() != 2:
        raise TypeError(f"split_bf16x3 takes a 2-d float32 tensor, got "
                        f"{g.dtype} {tuple(g.shape)}")
    c = count.ACTIVE
    if c is None:
        return _split(g)
    with c.kernel("split_bf16x3", split_work(*g.shape)):
        return _split(g)


def _split(g: torch.Tensor) -> torch.Tensor:
    if g.device.type == "cpu":
        return split_bf16x3_plain(g)
    if g.stride(1) != 1:
        g = g.contiguous()
    N, C = g.shape
    parts = torch.empty(N, 3, C, dtype=torch.bfloat16, device=g.device)
    if g.numel() == 0 or g.device.type == "meta":
        return parts
    ld = g.stride(0) if N > 1 else C
    vec = 4 if C % 4 == 0 and ld % 4 == 0 and g.data_ptr() % 16 == 0 else 1
    lib = build.load("bf16x3", _SIGNATURES)
    with torch.cuda.device(g.device):
        err = lib.split_bf16x3(g.data_ptr(), ld, parts.data_ptr(), N, C, vec,
                               torch.cuda.current_stream().cuda_stream)
    build.check(err, "split_bf16x3")
    split_bf16x3.launches += 1
    return parts


split_bf16x3.launches = 0
