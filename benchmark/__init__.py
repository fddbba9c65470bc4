"""The benchmark of ray_tpu_torch, the PyTorch/CUDA port: one command runs
one cell (`python benchmark/run.py --workload <cell> ...`). See PERF.md."""
