"""host_syncs_per_decode_step.serve (count): the blocking CUDA runtime
calls (``attribution.SYNCS``) that start inside an ``engine.decode`` span,
over the number of those spans."""
from cellbench.harness.attribution import SYNCS, calls_per_span


def read(ctx):
    return calls_per_span(ctx, "engine.decode", SYNCS)
