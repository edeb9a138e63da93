"""launches_per_mla_decode.serve (count): the kernel-launch CUDA runtime
calls (``attribution.LAUNCHES``) that start inside an ``mla.decode`` span
(one layer's decode attention with its cache write), over the number of
those spans."""
from cellbench.harness.attribution import LAUNCHES, calls_per_span


def read(ctx):
    return calls_per_span(ctx, "mla.decode", LAUNCHES)
