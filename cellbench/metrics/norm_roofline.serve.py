"""norm_roofline.serve (%): the bound time of the traced RMSNorms at the
rows the kernels run (a prefill's K2 per layer and the final one, and its
K3 per layer, at the traffic's ``max_seq`` padded rows; a decode step's the
same at ``max_batch`` rows, occupied or not) over the device time of every
``rmsnorm`` kernel in the trace."""
from cellbench.harness import work


def read(ctx):
    if ctx.get("kind") != "serve":
        return None
    m, tr = ctx["model"], ctx["traffic"]
    D, L = m["d_model"], m["n_layers"]
    rows = ([tr["max_seq"]] * len(ctx["traced"]["prefill_lengths"])
            + [tr["max_batch"]] * len(ctx["traced"]["decode_rows"]))
    bound = sum((L + 1) * work.bound_s(work.norm_fwd(N, D, False))[0]
                + L * work.bound_s(work.norm_fwd(N, D, True))[0]
                for N in rows)
    spent = ctx["trace"].kernel_s(lambda n: "rmsnorm" in n)
    return 100.0 * bound / spent if spent > 0 and bound > 0 else None
