"""forward_ms.train: device ms a traced step of the kernels, copies and
memsets launched while the program's span `lm::forward` or `lm::loss` was
the innermost open one (spans.context_metrics)."""

from benchmark import spans


def read(ctx: dict):
    return spans.context_metrics(ctx).get("forward_ms")
