"""idle_upload_share.serve (%): the device's idle time charged to the
engine's uploads (``engine.upload``: a prefill's tokens and lengths, a
decode step's tokens and occupied mask), over the traced stretch."""
from cellbench.harness.attribution import idle_share

SPANS = frozenset({"engine.upload"})


def read(ctx):
    return idle_share(ctx, SPANS)
