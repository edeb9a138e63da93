"""device_idle_share.serve (%): the share of the traced stretch in which no
kernel, copy or fill ran on the device (one minus the union of their
intervals over the stretch)."""


def read(ctx):
    if ctx.get("kind") != "serve":
        return None
    t = ctx["trace"]
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
