"""idle_mla_share.serve (%): the device's idle time charged to multi-head
latent attention (``mla.sequence``: a layer's sequence pass in a prefill;
``mla.decode``: a layer's decode attention, its cache write included),
over the traced stretch."""
from cellbench.harness.attribution import idle_share

SPANS = frozenset({"mla.sequence", "mla.decode"})


def read(ctx):
    return idle_share(ctx, SPANS)
