"""setup_first_step_s.train: host seconds of the process's first
`lm::train_step` span in set-up, less the nvcc seconds (the kernel loader's
`compile_s`) of the `cuda::load_library` spans inside it
(spans.first_step)."""

from benchmark import spans


def read(ctx: dict):
    return spans.context_metrics(ctx).get("setup_first_step_s")
