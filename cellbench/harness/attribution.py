"""The program's own spans in a traced stretch (``repro_torch.<name>``,
opened by ``repro_torch.spans`` while the profiler runs): the device's idle
time charged to them, and the CUDA runtime's calls counted inside them.

Every idle gap of the stretch (``tracing.gaps`` of the busy intervals over
the window, each one, however short) is charged whole to the innermost
program span that contains its midpoint, or to no span (``None``). The
runtime's calls are the host events the profiler records under their own
names; a call belongs to a span when its start lies inside it.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, FrozenSet, List, Optional, Tuple

import numpy as np

from cellbench.harness.tracing import Trace, gaps

PREFIX = "repro_torch."
# runtime calls that block the host until the device has caught up (a
# blocking copy in PyTorch is cudaMemcpyAsync, then cudaStreamSynchronize)
SYNCS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                   "cudaEventSynchronize", "cudaMemcpy"})
LAUNCHES = frozenset({"cudaLaunchKernel", "cudaLaunchKernelExC",
                      "cuLaunchKernel", "cuLaunchKernelEx"})

Span = Tuple[str, float, float]          # (name less the prefix, start, end)


def spans(trace: Trace) -> List[Span]:
    return [(n[len(PREFIX):], a, b) for n, a, b in trace.host
            if n.startswith(PREFIX)]


def idle_by_span(trace: Trace) -> Dict[Optional[str], float]:
    """Idle seconds by the innermost program span around each gap's
    midpoint; ``None`` holds those of gaps no program span contains."""
    found = gaps(trace.busy(), *trace.window)
    if not found:
        return {}
    g = np.array(found)
    mids, lengths = g.mean(1), g[:, 1] - g[:, 0]
    owner = np.full(len(g), -1)
    sp = spans(trace)
    # longest first, so a shorter span inside it takes the gaps it holds
    for i in sorted(range(len(sp)), key=lambda i: sp[i][1] - sp[i][2]):
        owner[(mids >= sp[i][1]) & (mids <= sp[i][2])] = i
    out: Dict[Optional[str], float] = defaultdict(float)
    for i, s in zip(owner, lengths):
        out[sp[i][0] if i >= 0 else None] += float(s)
    return dict(out)


def idle_share(ctx, names: FrozenSet[str]) -> Optional[float]:
    """The idle time charged to the spans ``names``, in % of the serving
    stretch; None where the trace holds none of them."""
    if ctx.get("kind") != "serve":
        return None
    t = ctx["trace"]
    if not any(n in names for n, _, _ in spans(t)):
        return None
    idle = idle_by_span(t)
    return 100.0 * sum(idle.get(n, 0.0) for n in names) / t.window_s


def calls_per_span(ctx, name: str, calls: FrozenSet[str]
                   ) -> Optional[float]:
    """The runtime calls named in ``calls`` that start inside a span
    ``name``, over the number of those spans; None where there is none."""
    if ctx.get("kind") != "serve":
        return None
    t = ctx["trace"]
    outer = [(a, b) for n, a, b in spans(t) if n == name]
    if not outer:
        return None
    starts = np.sort([a for n, a, _ in t.host if n in calls])
    lo, hi = np.array(outer).T
    inside = (np.searchsorted(starts, hi, "right")
              - np.searchsorted(starts, lo, "left"))
    return float(inside.sum()) / len(outer)
