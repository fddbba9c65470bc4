"""optimizer_roofline.train: the least time of the step after the backward
(counts.adamw_least_bytes of the trained parameters at the card's peak
bytes/s) over the device time a traced step launched in the program's
spans `lm::grad_norm` and `lm::optimizer`, in % (spans.context_metrics)."""

from benchmark import spans


def read(ctx: dict):
    return spans.context_metrics(ctx).get("optimizer_roofline")
