"""prefill_ms_p50.serve (ms): the median of the engine's own host-clock
time of each prefill in the window (``ServeEngine.timings["prefill"]``:
from the call to its first token on the host)."""
from cellbench.harness.stats import percentile


def read(ctx):
    if ctx.get("kind") != "serve" or not ctx["prefill_s"]:
        return None
    return 1e3 * percentile(ctx["prefill_s"], 50)
