"""peak_gib.train: torch.cuda.max_memory_allocated() over the window's steps
(reset when the window opens), in GiB."""


def read(ctx: dict):
    if ctx.get("kind") != "train" or not ctx.get("window_peak_bytes"):
        return None
    return ctx["window_peak_bytes"] / 2 ** 30
