"""idle_share.train: the share of the traced steps' window in which no
kernel, copy or memset ran on the card (the union of their intervals
taken out), in %."""


def read(ctx: dict):
    tr = ctx.get("trace")
    if ctx.get("kind") != "train" or not tr or not tr["kernels"] or not tr["window_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
