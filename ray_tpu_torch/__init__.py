"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu's compute layer.

Mirrors the paths of the JAX package (`ray_tpu/`), which stays the
reference. This package imports torch and nothing of jax or ray_tpu:

- `ray_tpu_torch.ops`: RoPE, reference/blockwise attention, the attention
  dispatcher and flash attention, whose CUDA kernels (forward
  `csrc/flash_attn_fwd.cu`, backward `csrc/flash_attn_bwd.cu`, sm_90a) are
  built with nvcc at first use;
- `ray_tpu_torch.models`: the Llama-family decoder on one device (forward
  with remat, `LMTrainContext` training step), and `params_from_numpy` /
  `state_from_numpy` to carry weights over from the JAX tree;
- `ray_tpu_torch.serve`: `@serve.batch`, thread-based request batching.

Entry points run on `cuda` unless the caller passes `device="cpu"`.
"""
