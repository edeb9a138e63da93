"""norm_roofline.train (%): the bound time of the traced steps' RMSNorms
(per layer and microbatch one K2 and one K3 forward, one K2b and one K3b
backward; the final norm's K2 and K2b once; no recompute) over the device
time of every ``rmsnorm`` kernel in the trace."""
from cellbench.harness import work


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    m, tr = ctx["model"], ctx["traffic"]
    N = tr["global_batch"] // tr["microbatches"] * tr["seq_len"]
    D, L = m["d_model"], m["n_layers"]
    b = lambda w: work.bound_s(w)[0]                     # noqa: E731
    per_micro = ((L + 1) * (b(work.norm_fwd(N, D, False))
                            + b(work.norm_bwd(N, D, False)))
                 + L * (b(work.norm_fwd(N, D, True))
                        + b(work.norm_bwd(N, D, True))))
    bound = ctx["traced_steps"] * tr["microbatches"] * per_micro
    spent = ctx["trace"].kernel_s(lambda n: "rmsnorm" in n)
    return 100.0 * bound / spent if spent > 0 else None
