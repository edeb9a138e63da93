"""launches_per_decode_step.serve (count): the kernel-launch CUDA runtime
calls (``attribution.LAUNCHES``) that start inside an ``engine.decode``
span, over the number of those spans."""
from cellbench.harness.attribution import LAUNCHES, calls_per_span


def read(ctx):
    return calls_per_span(ctx, "engine.decode", LAUNCHES)
