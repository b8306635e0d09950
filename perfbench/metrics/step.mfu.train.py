"""step.mfu.train: the model FLOPs of the window's steps over the traced
window's wall, against the card's bf16 dense peak, in %. The FLOPs
(``work/flops.py``): 6 × dense params × real tokens, attention's forward
and backward over the causal pairs the lengths give, the positive and
negative logits forward and backward; recompute not counted."""
LAYER = "whole step"
UNIT = "%"
MOVES = "train_tokens_per_s"


def read(ctx):
    from perfbench.work import flops
    f = ctx["steps"] * flops.train_step_flops(ctx["cfgj"], ctx["lengths"])
    return 100.0 * f / ctx["window_s"] / flops.PEAK_FLOPS["bfloat16"]
