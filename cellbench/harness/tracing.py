"""A short profiled stretch of a run, reduced to what the per-layer
metrics read: the device's operations as intervals, its busy time as their
union, the idle gaps labelled by what the host was doing, and the top of
both for the result's ``breakdown``.

The harness marks its own calls into the program with spans
(:func:`span`, ``torch.profiler.record_function``); nothing is written to
disk.
"""
from __future__ import annotations

import sys
import time
from collections import defaultdict
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

PREFIX = "cellbench."
Interval = Tuple[float, float]           # seconds on the profiler's clock


def span(name: str, on: bool = True):
    """A host span named ``cellbench.<name>`` (a no-op when ``on`` is
    false)."""
    if not on:
        return nullcontext()
    return torch.profiler.record_function(PREFIX + name)


def union(intervals: List[Interval]) -> List[Interval]:
    """Overlapping intervals merged, in order."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def gaps(busy: List[Interval], lo: float, hi: float) -> List[Interval]:
    """The stretches of [lo, hi] that no busy interval covers."""
    out, t = [], lo
    for a, b in busy:
        if a > t:
            out.append((t, min(a, hi)))
        t = max(t, b)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(a, b) for a, b in out if b > a]


@dataclass
class Trace:
    window: Interval                          # the traced stretch
    device: List[Tuple[str, float, float]]    # (name, start, end)
    host: List[Tuple[str, float, float]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy(self) -> List[Interval]:
        lo, hi = self.window
        return union([(max(a, lo), min(b, hi)) for _, a, b in self.device
                      if b > lo and a < hi])

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy())

    def kernel_s(self, match: Callable[[str], bool]) -> float:
        """Device seconds of the operations whose name ``match`` takes."""
        return sum(b - a for n, a, b in self.device if match(n))

    def top_ops(self, n: int = 10) -> List[list]:
        per: Dict[str, float] = defaultdict(float)
        for name, a, b in self.device:
            per[name[:160]] += b - a
        return [[k, v] for k, v in sorted(per.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10, longest: int = 200) -> List[list]:
        """The idle time by what the host was doing: each of the ``longest``
        gaps labelled by the harness span and the innermost host operation
        around its middle, summed by label, the ``n`` largest."""
        found = sorted(gaps(self.busy(), *self.window),
                       key=lambda g: g[0] - g[1])[:longest]
        per: Dict[str, float] = defaultdict(float)
        starts = np.array([s for _, s, _ in self.host])
        ends = np.array([e for _, _, e in self.host])
        for a, b in found:
            mid = (a + b) / 2
            inside = [(ends[i] - starts[i], self.host[i][0]) for i in
                      np.nonzero((starts <= mid) & (ends >= mid))[0]]
            spans = sorted(x for x in inside if x[1].startswith(PREFIX))
            ops = sorted(x for x in inside if not x[1].startswith(PREFIX))
            label = " > ".join(
                [spans[0][1] if spans else "outside the harness's spans"]
                + ([ops[0][1]] if ops else []))
            per[label] += b - a
        return [[k, v] for k, v in sorted(per.items(),
                                          key=lambda kv: -kv[1])[:n]]


def capture(fn: Callable[[], object]) -> Tuple[Trace, object]:
    """Run ``fn`` under ``torch.profiler`` (host and device), the device
    synchronised before and after, and reduce the profile to a
    :class:`Trace`; also returns what ``fn`` returned."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    with profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else [])) as prof:
        with span("trace_window"):
            out = fn()
            sync()
    device, host, window = [], [], None
    on_card = torch.autograd.DeviceType.CUDA
    for e in prof.events():
        a, b = e.time_range.start / 1e6, e.time_range.end / 1e6
        if e.name.startswith(PREFIX) or getattr(e, "is_user_annotation",
                                                False):
            if e.name == PREFIX + "trace_window" and e.device_type != on_card:
                window = (a, b)
            elif e.device_type != on_card:
                host.append((e.name, a, b))
        elif e.device_type == on_card:
            device.append((e.name, a, b))
        else:
            host.append((e.name, a, b))
    if window is None:
        raise RuntimeError("the profile holds no trace_window span")
    return Trace(window, device, host), out


def clock() -> float:
    return time.perf_counter()


def log(what: str) -> None:
    """A progress line on standard error, with the process's clock."""
    print(f"cellbench: {clock():.3f} {what}", file=sys.stderr, flush=True)
