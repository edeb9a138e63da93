"""norm_roofline.serve (%): the bound time of the traced RMSNorms at the
rows the kernels run (every K2 and K3 call of a pass, ``work.norm_calls``:
a prefill's at the traffic's ``max_seq`` padded rows, a decode step's at
``max_batch`` rows, occupied or not) over the device time of every
``rmsnorm`` kernel in the trace."""
from cellbench.harness import work


def read(ctx):
    if ctx.get("kind") != "serve":
        return None
    tr, calls = ctx["traffic"], work.norm_calls(ctx["model"])
    rows = ([tr["max_seq"]] * len(ctx["traced"]["prefill_lengths"])
            + [tr["max_batch"]] * len(ctx["traced"]["decode_rows"]))
    bound = sum(sum(n * work.bound_s(work.norm_fwd(N, width, residual))[0]
                    for (width, residual), n in calls.items())
                for N in rows)
    spent = ctx["trace"].kernel_s(lambda n: "rmsnorm" in n)
    return 100.0 * bound / spent if spent > 0 and bound > 0 else None
