"""backward_ms.train: device ms a traced step of what was launched in the
program's span `lm::backward`, from any thread (autograd's device thread
included), remat's recompute with it (spans.context_metrics)."""

from benchmark import spans


def read(ctx: dict):
    return spans.context_metrics(ctx).get("backward_ms")
