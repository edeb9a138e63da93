"""attn_roofline.serve (%): the bound time of K1 in the traced prefills
(one call a layer, at the rows the kernel runs: the traffic's ``max_seq``
padded rows, its keys masked at the prompt's length) over the device time
of every ``flash_`` kernel in the trace. What the padding wastes shows in
``mfu.serve``, which counts each prompt at its own length."""
from cellbench.harness import work


def read(ctx):
    if ctx.get("kind") != "serve":
        return None
    m, S = ctx["model"], ctx["traffic"]["max_seq"]
    bound = sum(m["n_layers"] * work.bound_s(work.flash_fwd_masked(
        S, L, m["n_heads"], m["n_kv_heads"], m["head_dim"]))[0]
        for L in ctx["traced"]["prefill_lengths"])
    spent = ctx["trace"].kernel_s(lambda n: "flash_" in n)
    return 100.0 * bound / spent if spent > 0 and bound > 0 else None
