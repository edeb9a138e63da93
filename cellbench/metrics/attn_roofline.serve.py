"""attn_roofline.serve (%): the bound time of K1 in the traced prefills
(one call an attention layer, at the shape each layer calls it with,
``work.attn_shapes``, and at the rows the kernel runs: the traffic's
``max_seq`` padded rows, its keys masked at the prompt's length) over the
device time of every ``flash_`` kernel in the trace. What the padding
wastes shows in ``mfu.serve``, which counts each prompt at its own
length."""
from cellbench.harness import work


def read(ctx):
    if ctx.get("kind") != "serve":
        return None
    S, shapes = ctx["traffic"]["max_seq"], work.attn_shapes(ctx["model"])
    bound = sum(sum(n * work.bound_s(work.flash_fwd_masked(S, L, *shape))[0]
                    for shape, n in shapes.items())
                for L in ctx["traced"]["prefill_lengths"])
    spent = ctx["trace"].kernel_s(lambda n: "flash_" in n)
    return 100.0 * bound / spent if spent > 0 and bound > 0 else None
