"""attn_roofline.train (%): the bound time of the traced steps' attention
(K1 forward and K1b backward once per layer and microbatch: a recompute is
not needed work) over the device time of every ``flash_`` kernel in the
trace."""
from cellbench.harness import work


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    m, tr = ctx["model"], ctx["traffic"]
    B = tr["global_batch"] // tr["microbatches"]
    shape = (B, tr["seq_len"], m["n_heads"], m["n_kv_heads"], m["head_dim"])
    calls = ctx["traced_steps"] * tr["microbatches"] * m["n_layers"]
    bound = calls * (work.bound_s(work.flash_fwd(*shape))[0]
                     + work.bound_s(work.flash_bwd(*shape))[0])
    spent = ctx["trace"].kernel_s(lambda n: "flash_" in n)
    return 100.0 * bound / spent if spent > 0 else None
