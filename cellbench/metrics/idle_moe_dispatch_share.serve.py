"""idle_moe_dispatch_share.serve (%): the device's idle time charged to the
MoE dispatch (``moe.dispatch``, ``moe.host_read``: its host read of the
per-expert counts and its per-expert launches), over the traced stretch."""
from cellbench.harness.attribution import idle_share

SPANS = frozenset({"moe.dispatch", "moe.host_read"})


def read(ctx):
    return idle_share(ctx, SPANS)
