"""step_mfu.train: the model FLOPs of the window's tokens (6 N_nonemb and the
causal attention products a token, no recompute; counts.py) over the
window's host-clock seconds, as a share of the card's bf16 peak, in %."""

from benchmark import counts


def read(ctx: dict):
    if ctx.get("kind") != "train" or not ctx.get("window_s"):
        return None
    return 100.0 * ctx["flops"] / ctx["window_s"] / counts.peak(ctx["device"])["bf16_flops"]
