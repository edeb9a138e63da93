"""ttft_p90_ms.serve (ms): the 90th percentile, over every request sent
in the window, of the time from when its client sent it to when its first
token reached the host (a request sent near the close is waited for)."""
from cellbench.harness.stats import percentile


def read(ctx):
    if ctx.get("kind") != "serve" or not ctx["ttft_s"]:
        return None
    return 1e3 * percentile(ctx["ttft_s"], 90)
