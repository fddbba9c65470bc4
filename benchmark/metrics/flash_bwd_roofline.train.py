"""flash_bwd_roofline.train: the attention backward's least time (B2, B3 and
the delta pre-pass; counts.flash_bwd_bound_s) over the device time of every
kernel that the autograd node `_FlashAttentionBackward` launched in the
traced steps, in %. One B2 launch (`dq_wgmma_kernel`) per backward call."""

from benchmark import counts

SCOPE = "autograd::engine::evaluate_function: _FlashAttentionBackward"


def read(ctx: dict):
    tr = ctx.get("trace")
    if ctx.get("kind") != "train" or not tr or not tr["scoped_s"].get(SCOPE):
        return None
    calls = sum(1 for k in tr["marked"] if k["marker"] == "dq_wgmma_kernel")
    if not calls:
        return None
    sh = ctx["shape"]
    bound = counts.flash_bwd_bound_s(sh["b"], sh["s"], sh["h"], sh["hkv"], sh["d"],
                                     counts.peak(ctx["device"]))
    return 100.0 * bound * calls / tr["scoped_s"][SCOPE]
