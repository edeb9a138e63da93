"""mfu.serve (%): model FLOPs of the window's prompts and generated tokens
(active parameters, attention over each token's real context, one row of
logits a token; ``harness/work.py``) over the window times the H100's bf16
dense peak."""
from cellbench.harness.work import PEAK_BF16


def read(ctx):
    if ctx.get("kind") != "serve" or not ctx["window"]["flops"]:
        return None
    return 100.0 * ctx["window"]["flops"] / (ctx["window_s"] * PEAK_BF16)
