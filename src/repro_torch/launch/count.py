"""Counting the work of a step as it runs: on the card, on the CPU, or on
the ``meta`` device, where nothing is computed (``launch/dryrun.py``).

:class:`Counter` is a ``TorchDispatchMode``. Every aten op run under it
adds its FLOPs (``torch.utils.flop_counter``'s formulas: matmuls and
convolutions), by the dtype of its first tensor input, and its bytes (each
tensor input read once, each output written once; an op whose outputs all
lie on its inputs' storages without writing them, a view, moves none; an
``empty`` allocates without writing). It also follows the storages made
while it counts, so that ``peak`` is the most bytes they held at once: the
counterpart of XLA's temporary buffers, autograd's saved tensors and
``remat``'s recompute included.

On meta, an op's outputs depend on its inputs' shapes, strides and dtypes
and its other arguments alone, and most of their cost is PyTorch's Python
shape rules (a time-step loop runs the same few ops thousands of times):
with ``memo`` (the default on meta) the counter keeps the outputs' shapes,
strides and dtypes of each op that allocates new outputs, by those
arguments, and makes empty ones for a call it has seen.

A hand-written kernel does not show as aten ops on the card, and runs its
plain version's many ops on the CPU. So each kernel wrapper, under an
active counter (:data:`ACTIVE`), opens :meth:`Counter.kernel` with the
kernel's own work (the ``*_work`` function beside it, which
``benchmarks_torch/bench_kernels_torch.py`` reads for its bounds): the
work is recorded once, under the kernel's name, and the ops inside are not
counted (their storages still are). With no counter active, a wrapper
costs one module-attribute test more than its kernel call.

The H100 constants here are the one copy the port's benches, the roofline
and ``chip_smoke.py`` read: NVIDIA's data sheet for the H100 SXM5, dense,
at 700 W.
"""
from __future__ import annotations

import contextlib
import weakref
from typing import Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

# H100 SXM5 (NVIDIA data sheet, dense, 700 W): HBM3 bytes/s, bf16
# tensor-core FLOP/s, f32 FLOP/s outside the tensor cores, NVLink 4 bytes/s
# each way (900 GB/s both ways), SMs, and the device memory
# torch.cuda.get_device_properties reads on the 80 GB part (chip_smoke.py
# phase 20 prints it)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
NVLINK_BYTES_PER_S = 450e9
H100_SMS = 132
H100_MEMORY_BYTES = int(79.18 * 2 ** 30)

ACTIVE: Optional["Counter"] = None

aten = torch.ops.aten
# composite ops that reach the mode whole under inference mode, and are
# counted as the matmuls and convolutions they are made of
_DECOMPOSE = {aten.matmul, aten.linear, aten.einsum, aten.tensordot,
              aten.bilinear, aten.conv1d, aten.conv2d, aten.conv3d}
_ALLOCATE_ONLY = ("empty", "empty_like", "empty_strided", "new_empty",
                  "new_empty_strided")

Work = Tuple[int, float, torch.dtype]        # (bytes, flops, dtype)


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).rsplit(".", 1)[-1]


def _tensors(*groups) -> list:
    """The tensors among ``groups``' items and inside their lists and
    tuples (an aten op's arguments and results nest no deeper)."""
    out = []
    for g in groups:
        for x in g:
            if isinstance(x, torch.Tensor):
                out.append(x)
            elif isinstance(x, (list, tuple)):
                out.extend(y for y in x if isinstance(y, torch.Tensor))
    return out


def _fresh(func) -> bool:
    """Whether ``func``'s schema says it writes no argument and returns
    new tensors (``_unsafe_view`` returns a view all the same: the first
    call that shows an output on an input's storage clears the op from
    the memo)."""
    schema = func._schema
    return not schema.is_mutable and all(
        r.alias_info is None for r in schema.returns)


_FRESH: Dict = {}


def _arg_key(x):
    if isinstance(x, torch.Tensor):
        if x.device.type != "meta":
            raise TypeError
        return (tuple(x.shape), x.stride(), x.dtype, x.storage_offset())
    if isinstance(x, (list, tuple)):
        return tuple(_arg_key(y) for y in x)
    hash(x)
    return x


def _key(func, args, kwargs):
    """The memo key of a call on meta tensors of an op that allocates its
    outputs, or None."""
    fresh = _FRESH.get(func)
    if fresh is None:
        fresh = _FRESH[func] = _fresh(func)
    if not fresh:
        return None
    try:
        return (func, _arg_key(args),
                tuple((k, _arg_key(v)) for k, v in sorted(kwargs.items())))
    except TypeError:
        return None


def _spec(out):
    """What :func:`_remake` needs to make ``out`` again: meta tensors
    only (a factory's CPU output keeps its values)."""
    if isinstance(out, torch.Tensor):
        if out.device.type != "meta":
            return None
        return (tuple(out.shape), out.stride(), out.dtype)
    if isinstance(out, (list, tuple)):
        specs = tuple(_spec(t) for t in out)
        if all(isinstance(t, torch.Tensor) for t in out) and all(specs):
            return (type(out), specs)
    return None


def _remake(spec):
    if isinstance(spec[0], type):
        return spec[0](_remake(s) for s in spec[1])
    shape, stride, dtype = spec
    return torch.empty_strided(shape, stride, dtype=dtype, device="meta")


class Counter(TorchDispatchMode):
    """FLOPs by dtype, bytes, each kernel's calls and work, and the peak of
    the storages made while counting. ``track`` is the device type whose
    storages the peak follows (``meta`` for a dry run, ``cuda`` on the
    card); None follows every device's."""

    def __init__(self, track: Optional[str] = None,
                 memo: Optional[bool] = None):
        super().__init__()
        self.track = track
        self._memo: Optional[Dict] = (
            {} if (track == "meta" if memo is None else memo) else None)
        self.flops: Dict[str, float] = {}
        self.flops_by_op: Dict[str, float] = {}
        self.bytes = 0
        self.ops = 0
        self.kernels: Dict[str, Dict] = {}
        self.live = 0
        self.peak = 0
        self._quiet = 0
        self._alive: Dict[int, tuple] = {}
        self._outer: list = []

    def __enter__(self):
        global ACTIVE
        self._outer.append(ACTIVE)
        ACTIVE = self
        return super().__enter__()

    def __exit__(self, *exc):
        global ACTIVE
        ACTIVE = self._outer.pop()
        return super().__exit__(*exc)

    @contextlib.contextmanager
    def kernel(self, name: str, work: Work):
        """One call of kernel ``name`` with ``work``'s bytes and FLOPs; the
        ops run inside are left uncounted."""
        nbytes, flops, dtype = work
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                           "bytes": 0, "dtype":
                                           dtype_name(dtype)})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        if not self._quiet:
            if flops:                   # a split or copy does no product
                self._add_flops(dtype_name(dtype), flops)
            self.bytes += nbytes
        self._quiet += 1
        try:
            yield
        finally:
            self._quiet -= 1

    def _add_flops(self, dtype: str, flops: float) -> None:
        self.flops[dtype] = self.flops.get(dtype, 0.0) + flops

    def _follow(self, st: torch.UntypedStorage) -> None:
        key = id(st)
        if key in self._alive or (self.track is not None
                                  and st.device.type != self.track):
            return
        n = st.nbytes()
        self._alive[key] = (n, weakref.ref(st, lambda _, k=key: self._free(
            k)))
        self.live += n
        self.peak = max(self.peak, self.live)

    def _free(self, key: int) -> None:
        n, _ = self._alive.pop(key, (0, None))
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func._overloadpacket in _DECOMPOSE:
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = None
        key = None if self._memo is None else _key(func, args, kwargs)
        if key is not None:
            spec = self._memo.get(key)
            if spec is not None:
                out = _remake(spec)
        ins = _tensors(args, kwargs.values())
        if out is None:
            out = func(*args, **kwargs)
            outs = _tensors((out,))
            # an output on an input's storage is a view, or the input
            # itself (an in-place op, ``to`` of the same dtype): it
            # allocates nothing
            mine = {id(t.untyped_storage()) for t in ins}
            new = [t for t in outs if id(t.untyped_storage()) not in mine]
            if key is not None:
                spec = _spec(out) if len(new) == len(outs) else None
                if spec is not None:
                    self._memo[key] = spec
                elif len(new) < len(outs):     # a view its schema hides
                    _FRESH[func] = False
        else:
            outs = new = _tensors((out,))
        for t in new:
            self._follow(t.untyped_storage())
        if self._quiet:
            return out
        self.ops += 1
        packet = func._overloadpacket
        if packet in flop_registry:
            # the formulas take no out_dtype (``mm(..., out_dtype=)``'s
            # overloads): drop it
            fargs = tuple(a for a in args if not isinstance(a, torch.dtype))
            n = float(flop_registry[packet](*fargs, **kwargs, out_val=out))
            src = ins[0] if ins else outs[0]
            self._add_flops(dtype_name(src.dtype), n)
            name = packet.__name__
            self.flops_by_op[name] = self.flops_by_op.get(name, 0.0) + n
        written = outs if func._schema.is_mutable else new
        if written:
            moved = sum(t.numel() * t.element_size() for t in written)
            if packet.__name__ not in _ALLOCATE_ONLY:
                moved += sum(t.numel() * t.element_size() for t in ins)
            self.bytes += moved
        return out

    def total_flops(self) -> float:
        return sum(self.flops.values())

    def report(self) -> Dict:
        return {"flops": self.total_flops(), "flops_by_dtype": dict(
            self.flops), "flops_by_op": dict(self.flops_by_op),
            "bytes_accessed": self.bytes, "ops": self.ops,
            "kernels": {k: dict(v) for k, v in self.kernels.items()},
            "peak_bytes": self.peak}
