"""norm_roofline.train (%): the bound time of the traced steps' RMSNorms
(per microbatch every K2 and K3 call of a pass, ``work.norm_calls``,
forward and, as K2b and K3b, backward; no recompute) over the device time
of every ``rmsnorm`` kernel in the trace."""
from cellbench.harness import work


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    tr = ctx["traffic"]
    N = tr["global_batch"] // tr["microbatches"] * tr["seq_len"]
    b = lambda w: work.bound_s(w)[0]                     # noqa: E731
    per_micro = sum(n * (b(work.norm_fwd(N, width, residual))
                         + b(work.norm_bwd(N, width, residual)))
                    for (width, residual), n in
                    work.norm_calls(ctx["model"]).items())
    bound = ctx["traced_steps"] * tr["microbatches"] * per_micro
    spent = ctx["trace"].kernel_s(lambda n: "rmsnorm" in n)
    return 100.0 * bound / spent if spent > 0 and bound > 0 else None
