"""idle_sample_share.serve (%): the device's idle time charged to sampling
on the host (``engine.sample``: the logits copied to the host, the pick,
the slots' bookkeeping), over the traced stretch."""
from cellbench.harness.attribution import idle_share

SPANS = frozenset({"engine.sample"})


def read(ctx):
    return idle_share(ctx, SPANS)
