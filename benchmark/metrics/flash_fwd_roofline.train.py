"""flash_fwd_roofline.train: B1's least time (counts.flash_fwd_bound_s at the
step's attention shape) over B1's device time, summed over its launches in
the traced steps (kernel `fwd_wgmma_kernel`), in %."""

from benchmark import counts


def read(ctx: dict):
    tr = ctx.get("trace")
    if ctx.get("kind") != "train" or not tr:
        return None
    runs = [k["s"] for k in tr["marked"] if k["marker"] == "fwd_wgmma_kernel"]
    if not runs:
        return None
    sh = ctx["shape"]
    bound = counts.flash_fwd_bound_s(sh["b"], sh["s"], sh["h"], sh["hkv"], sh["d"],
                                     counts.peak(ctx["device"]))
    return 100.0 * bound * len(runs) / sum(runs)
