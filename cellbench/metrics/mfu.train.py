"""mfu.train (%): model FLOPs of the window's training steps (no recompute;
``harness/work.py`` ``train_flops``) over the window times the H100's bf16
dense peak."""
from cellbench.harness.work import PEAK_BF16


def read(ctx):
    if ctx.get("kind") != "train" or not ctx.get("steps"):
        return None
    return 100.0 * ctx["model_flops"] / (ctx["window_s"] * PEAK_BF16)
