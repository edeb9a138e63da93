"""The port's spans: named host ranges at the serving engine's and the MoE
dispatch's boundaries (their names are listed in ``PERF.md`` §3).

``span(name)`` is the only way the port opens one. While a profiler runs,
it is ``torch.profiler.record_function("repro_torch." + name)``, a range on
the profiler's clock, the clock its device intervals are aligned to. So an
operator sees the phases

- in a ``torch.profiler`` trace (``export_chrome_trace``), beside the
  kernels and the CUDA runtime's calls they issue;
- as NVTX ranges under ``torch.autograd.profiler.emit_nvtx()``;

and when nothing profiles, a span costs one boolean check and hands back
one shared no-op context.
"""
from __future__ import annotations

import contextlib

import torch

PREFIX = "repro_torch."
_OFF = contextlib.nullcontext()


def span(name: str, args=None):
    """A range named ``repro_torch.<name>`` (``args``, if given, recorded
    as its string) while a profiler runs; the shared no-op otherwise."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(
        PREFIX + name, None if args is None else str(args))
