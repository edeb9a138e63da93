"""decode_step_ms_mean.serve (ms): the engine's own host-clock time of the
window's decode steps (``ServeEngine.timings["decode"]``), summed, over
their count."""


def read(ctx):
    if ctx.get("kind") != "serve" or not ctx["decode_s"]:
        return None
    return 1e3 * sum(ctx["decode_s"]) / len(ctx["decode_s"])
