"""host_syncs_per_prefill.serve (count): the blocking CUDA runtime calls
(``attribution.SYNCS``) that start inside an ``engine.prefill`` span, over
the number of those spans."""
from cellbench.harness.attribution import SYNCS, calls_per_span


def read(ctx):
    return calls_per_span(ctx, "engine.prefill", SYNCS)
