"""RMSNorm and fused residual-add + RMSNorm: CUDA kernels and plain versions.

Replaces ``repro/kernels/rmsnorm.py`` (``rmsnorm_tpu``,
``rmsnorm_residual_tpu``). Kernels: ``csrc/rmsnorm.cu``, one template in
three variants (:data:`VARIANTS`): one warp per row for rows up to
:data:`WARP_MAX_WIDTH` and one block per row up to :data:`MAX_WIDTH`, both
with 16-byte accesses, and for a row or base that is not 16-byte aligned
one block per row with one element per access. :func:`pick_variant`
chooses, unless the tuning table (``kernels/autotune.py``) holds a variant
for the shape that the call can take; the backward always takes
:func:`pick_variant`'s. The source's header says why the design is what it
is.

A wrapper given CPU tensors computes the plain version; given CUDA tensors it
launches its kernel or raises. ``rmsnorm.launches`` and
``rmsnorm_residual.launches`` count the kernel launches, and ``.variant``
names the variant each launched last.

Gradients: :func:`rmsnorm` and :func:`rmsnorm_residual` go through
:class:`RMSNormFn` and :class:`RMSNormResidualFn`, whose backward is one
launch of a kernel of the same source in the same three variants (K2b,
K3b): dx, and dw, which each block's partial sum and, in the same launch,
a sum of those partials by the last few blocks give in an order fixed by
the code (:data:`REDUCE_LANES`). The JAX package has no backward kernel;
these hold to ``jax.grad`` of ``repro/kernels/ref.py`` ``rmsnorm_ref`` and
of the model's unfused ``x + y; norm``. ``rmsnorm_bwd.launches`` and
``rmsnorm_residual_bwd.launches`` count their launches.

On ``meta`` tensors (``launch/dryrun.py``) each wrapper runs its CUDA path
up to the launch and allocates its outputs (and the backward its dw
scratch) without launching. :func:`norm_work` and :func:`norm_bwd_work`
give a call's bytes and FLOPs, which a counter (``launch/count.py``)
records once a call.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import autotune, build
from repro_torch.launch import count

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_WIDTH = 16384          # kMaxWidth in csrc/rmsnorm.cu: llama3-405b's d_model
WARP_MAX_WIDTH = 2048      # kWarpMaxWidth: one warp per row up to this width
VARIANTS = ("warp", "wide", "scalar")   # by the C entries' code
ROWS_PER_BLOCK = 4         # kRowsPerBlock: rows of one warp-layout block
BWD_BLOCKS = 264           # kBwdBlocks: most blocks of a backward launch
REDUCERS = 48              # kReducers: most blocks that sum dw's columns
REDUCE_LANES = 16          # kReduceLanes: dw adds every 16th partial row


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


def rmsnorm_bwd_plain(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                      eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, dw) of :func:`rmsnorm_plain` in f32, from x and the output's
    cotangent dy: with r = rsqrt(mean(x^2) + eps) and g = dy w,
    dx = r (g - x r^2 mean(g x)) cast to x.dtype, dw = sum over rows of
    dy x r (f32)."""
    xf, g = x.float(), dy.float() * w.float()
    r = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    dx = r * (g - xf * r * r * (g * xf).mean(-1, keepdim=True))
    dw = (dy.float() * xf * r).reshape(-1, x.shape[-1]).sum(0)
    return dx.to(x.dtype), dw


def rmsnorm_residual_bwd_plain(s: torch.Tensor, w: torch.Tensor,
                               dy: torch.Tensor, ds: torch.Tensor,
                               eps: float = 1e-5
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dt, dw) of :func:`rmsnorm_residual_plain` from the saved sum s and
    the cotangents of its two outputs: dt = ds + dx_norm(s), added in f32
    and rounded once to s.dtype, is the gradient of both x and r."""
    dx, dw = rmsnorm_bwd_plain(s.float(), w, dy, eps)
    return (ds.float() + dx).to(s.dtype), dw


def pick_variant(x: torch.Tensor, *others: torch.Tensor) -> int:
    """The kernel variant (an index into :data:`VARIANTS`) for the rows of
    ``x`` read beside ``others``. Where a row's bytes are a multiple of 16
    and every base is 16-byte aligned, the warp layout up to WARP_MAX_WIDTH
    and the wide one up to MAX_WIDTH; else the scalar instantiation. Raises
    for a width no variant takes."""
    return variant_for(x.shape[-1], vector_access(x, *others))


def variant_for(D: int, vector: bool) -> int:
    """:func:`pick_variant`'s rule for rows of D, given whether the
    16-byte variants take the call (:func:`vector_access`)."""
    if not 0 < D <= MAX_WIDTH:
        raise ValueError(f"rows of {D} are outside the kernels' widths "
                         f"1..{MAX_WIDTH}")
    if not vector:
        return 2
    return 1 if D > WARP_MAX_WIDTH else 0


def vector_access(x: torch.Tensor, *others: torch.Tensor) -> bool:
    """Whether the 16-byte variants take these tensors: a row of ``x`` a
    multiple of 16 bytes and every base 16-byte aligned."""
    return (x.shape[-1] * x.element_size() % 16 == 0
            and all(t.data_ptr() % 16 == 0 for t in (x, *others)))


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "rmsnorm_fwd": [_P, _P, _P, _I, _I, _F, _I, _I, _P],
    "rmsnorm_residual_fwd": [_P, _P, _P, _P, _P, _I, _I, _F, _I, _I, _P],
    "rmsnorm_empty": [_P],
    # x or s, dy, ds, w, dx, dw, scratch, arrivals, N, D, eps, dtype,
    # variant, blocks, stream
    "rmsnorm_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _I, _I,
                    _P],
    "rmsnorm_residual_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _I,
                             _I, _I, _P],
    "rmsnorm_capture_id": [_P, ctypes.POINTER(ctypes.c_ulonglong)],
}


def norm_work(N: int, D: int, dtype: torch.dtype, residual: bool
              ) -> count.Work:
    """(bytes, FLOPs, dtype) of one forward over N rows of D: x (and r) in,
    y (and s) out, w; the norm's f32 operations."""
    el = torch.finfo(dtype).bits // 8
    rows = 4 if residual else 2
    return (el * rows * N * D + 4 * D, (5.0 if residual else 4.0) * N * D,
            torch.float32)


def norm_bwd_work(N: int, D: int, dtype: torch.dtype, residual: bool
                  ) -> count.Work:
    """(bytes, FLOPs, dtype) of one backward: x (or s), dy (and ds) in, dx
    out, w in and dw out in f32."""
    el = torch.finfo(dtype).bits // 8
    rows = 4 if residual else 3
    return el * rows * N * D + 8 * D, 8.0 * N * D, torch.float32


def _work(fn, x: torch.Tensor, residual: bool) -> count.Work:
    D = x.shape[-1]
    return fn(x.numel() // max(D, 1), D, x.dtype, residual)


def _check(x: torch.Tensor, w: torch.Tensor, *others: torch.Tensor) -> None:
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"rmsnorm runs on cpu, cuda or meta tensors, got "
                         f"{x.device}")
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
    """x: (..., D); w: (D,) float32. Returns rmsnorm(x) * w in x.dtype,
    differentiable in x and w."""
    c = count.ACTIVE
    if c is None:
        return RMSNormFn.apply(x, w, eps)
    with c.kernel("rmsnorm", _work(norm_work, x, False)):
        return RMSNormFn.apply(x, w, eps)


def _rmsnorm_fwd(x: torch.Tensor, w: torch.Tensor, eps: float
                 ) -> torch.Tensor:
    if x.device.type == "cpu":
        return rmsnorm_plain(x, w, eps)
    _check(x, w)
    x, w = x.contiguous(), w.contiguous()
    variant, _ = autotune.plan_rmsnorm_variant(x, w)
    y = torch.empty_like(x)
    D = x.shape[-1]
    if x.numel() == 0 or x.device.type == "meta":
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
    """x, r: (..., D). Returns (rmsnorm(s) * w, s) with s = x + r in x.dtype,
    differentiable in x, r and w."""
    c = count.ACTIVE
    if c is None:
        return RMSNormResidualFn.apply(x, r, w, eps)
    with c.kernel("rmsnorm_residual", _work(norm_work, x, True)):
        return RMSNormResidualFn.apply(x, r, w, eps)


def _rmsnorm_residual_fwd(x: torch.Tensor, r: torch.Tensor, w: torch.Tensor,
                          eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    if x.device.type == "cpu":
        return rmsnorm_residual_plain(x, r, w, eps)
    _check(x, w, r)
    x, r, w = x.contiguous(), r.contiguous(), w.contiguous()
    variant, _ = autotune.plan_rmsnorm_variant(x, r, w)
    y = torch.empty_like(x)
    s = torch.empty_like(x)
    D = x.shape[-1]
    if x.numel() == 0 or x.device.type == "meta":
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


def bwd_blocks(rows: int, variant: int) -> int:
    """Blocks of a backward launch, and so rows of its dw partials: a
    block per ROWS_PER_BLOCK rows (warp layout) or per row (the others),
    at most BWD_BLOCKS, each walking its rows with a grid stride."""
    per = ROWS_PER_BLOCK if variant == 0 else 1
    return max(1, min(-(-rows // per), BWD_BLOCKS))


# The backward's scratch (one partial row of dw per block) and its arrival
# counter, by (device, stream, CUDA graph capture id or 0, D, blocks). A
# launch advances its counter by its block count and expects it at a
# multiple of that count: so launches on one stream, which run in turn,
# share a counter for one block count, but two launches on different
# streams could run at once and count each other's blocks, and each stream
# has its own. A set made during a graph capture is zeroed by a node of
# that graph at each replay, before its launches; it is never used outside
# that capture.
_scratch: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def _capture_id(lib, stream: int) -> int:
    if not torch.cuda.is_current_stream_capturing():
        return 0
    cid = ctypes.c_ulonglong(0)
    build.check(lib.rmsnorm_capture_id(stream, ctypes.byref(cid)),
                "rmsnorm_capture_id")
    return cid.value


def _bwd_scratch(lib, device: torch.device, stream: int, D: int, blocks: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    key = (device.index, stream, _capture_id(lib, stream), D, blocks)
    got = _scratch.get(key)
    if got is None:
        got = (torch.empty(BWD_BLOCKS * D, dtype=torch.float32, device=device),
               torch.zeros(1, dtype=torch.int64, device=device))
        _scratch[key] = got
    return got


def _bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
         ds: Optional[torch.Tensor], eps: float
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of K2b (``ds`` None) or K3b on CUDA tensors: (dx, dw).
    On CPU tensors the plain version's."""
    if x.device.type == "cpu":
        return (rmsnorm_bwd_plain(x, w, dy, eps) if ds is None else
                rmsnorm_residual_bwd_plain(x, w, dy, ds, eps))
    others = (dy,) if ds is None else (dy, ds)
    _check(x, w, *others)
    x, w = x.contiguous(), w.contiguous()
    others = tuple(t.contiguous() for t in others)
    variant = pick_variant(x, w, *others)
    D = x.shape[-1]
    N = x.numel() // D
    dx = torch.empty_like(x)
    if N == 0:
        return dx, torch.zeros(D, dtype=torch.float32, device=x.device)
    dw = torch.empty(D, dtype=torch.float32, device=x.device)
    if x.device.type == "meta":     # the scratch a launch would take
        torch.empty(BWD_BLOCKS * D, dtype=torch.float32, device=x.device)
        return dx, dw
    entry = "rmsnorm_bwd" if ds is None else "rmsnorm_residual_bwd"
    lib = build.load("rmsnorm", _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        blocks = bwd_blocks(N, variant)
        scratch, arrivals = _bwd_scratch(lib, x.device, stream, D, blocks)
        err = getattr(lib, entry)(
            x.data_ptr(), others[0].data_ptr(),
            None if ds is None else others[1].data_ptr(), w.data_ptr(),
            dx.data_ptr(), dw.data_ptr(), scratch.data_ptr(),
            arrivals.data_ptr(), N, D, eps, _DTYPES[x.dtype], variant, blocks,
            stream)
    build.check(err, entry)
    fn = rmsnorm_bwd if ds is None else rmsnorm_residual_bwd
    fn.launches += 1
    fn.variant = VARIANTS[variant]
    return dx, dw


def rmsnorm_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx in x.dtype, dw f32) of rmsnorm at x for the cotangent dy."""
    c = count.ACTIVE
    if c is None:
        return _bwd(x, w, dy, None, eps)
    with c.kernel("rmsnorm_bwd", _work(norm_bwd_work, x, False)):
        return _bwd(x, w, dy, None, eps)


rmsnorm_bwd.launches = 0
rmsnorm_bwd.variant = None


def rmsnorm_residual_bwd(s: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                         ds: torch.Tensor, eps: float = 1e-5
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dt, dw) of rmsnorm_residual from its saved sum s and the cotangents
    of (y, s); dt is the gradient of both x and r."""
    c = count.ACTIVE
    if c is None:
        return _bwd(s, w, dy, ds, eps)
    with c.kernel("rmsnorm_residual_bwd", _work(norm_bwd_work, s, True)):
        return _bwd(s, w, dy, ds, eps)


rmsnorm_residual_bwd.launches = 0
rmsnorm_residual_bwd.variant = None


class RMSNormFn(torch.autograd.Function):
    """rmsnorm with the K2b backward."""

    @staticmethod
    def forward(ctx, x, w, eps):
        y = _rmsnorm_fwd(x, w, eps)
        if any(ctx.needs_input_grad[:2]):
            ctx.save_for_backward(x, w)
            ctx.eps = eps
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = rmsnorm_bwd(x, w, dy, ctx.eps)
        return dx, dw, None


class RMSNormResidualFn(torch.autograd.Function):
    """rmsnorm_residual with the K3b backward: one dt for x and r."""

    @staticmethod
    def forward(ctx, x, r, w, eps):
        y, s = _rmsnorm_residual_fwd(x, r, w, eps)
        if any(ctx.needs_input_grad[:3]):
            ctx.save_for_backward(s, w)
            ctx.eps = eps
        return y, s

    @staticmethod
    def backward(ctx, dy, ds):
        s, w = ctx.saved_tensors
        # autograd gives zeros for an output that took no gradient
        dt, dw = rmsnorm_residual_bwd(s, w, dy, ds, ctx.eps)
        return dt, dt, dw, None


def launch_empty() -> None:
    """Launch the rmsnorm library's empty kernel (one block of 128 threads
    that does nothing) on the current stream: the floor under any launch's
    time. Not counted as a launch of either wrapper."""
    lib = build.load("rmsnorm", _SIGNATURES)
    build.check(lib.rmsnorm_empty(torch.cuda.current_stream().cuda_stream),
                "rmsnorm_empty")
