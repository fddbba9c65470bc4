"""Hand-written CUDA kernels (sources in ray_tpu_torch/csrc/), each with
its plain PyTorch version: flash attention's beside it, the optimizer's
clip + AdamW (`adamw`) in `ray_tpu_torch/models/lm.py`."""
