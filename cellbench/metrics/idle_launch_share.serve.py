"""idle_launch_share.serve (%): the device's idle time charged to the host
issuing work: the model's calls (``model.prefill``, ``model.decode``), the
splice, and a prefill's or decode step's own span outside its phases, over
the traced stretch."""
from cellbench.harness.attribution import idle_share

SPANS = frozenset({"model.prefill", "model.decode", "engine.splice",
                   "engine.prefill", "engine.decode"})


def read(ctx):
    return idle_share(ctx, SPANS)
