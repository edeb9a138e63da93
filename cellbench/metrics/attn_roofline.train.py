"""attn_roofline.train (%): the bound time of the traced steps' attention
(K1 forward and K1b backward once per attention layer and microbatch, at
the shape each layer calls them with, ``work.attn_shapes``: a recompute
is not needed work) over the device time of every ``flash_`` kernel in
the trace."""
from cellbench.harness import work


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    tr = ctx["traffic"]
    B = tr["global_batch"] // tr["microbatches"]
    bound = sum(
        ctx["traced_steps"] * tr["microbatches"] * n
        * (work.bound_s(work.flash_fwd(B, tr["seq_len"], *shape))[0]
           + work.bound_s(work.flash_bwd(B, tr["seq_len"], *shape))[0])
        for shape, n in work.attn_shapes(ctx["model"]).items())
    spent = ctx["trace"].kernel_s(lambda n: "flash_" in n)
    return 100.0 * bound / spent if spent > 0 and bound > 0 else None
