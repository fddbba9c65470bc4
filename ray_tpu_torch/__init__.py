"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu's compute layer.

Mirrors the paths of the JAX package (`ray_tpu/`), which stays the
reference. This package imports torch and nothing of jax or ray_tpu:

- `ray_tpu_torch.ops`: RoPE, reference/blockwise attention, the attention
  dispatcher and flash attention, whose CUDA kernels (forward
  `csrc/flash_attn_fwd.cu`, backward `csrc/flash_attn_bwd.cu`, sm_90a) are
  built with nvcc at first use;
- `ray_tpu_torch.ops.ring_attention`: ring attention over a sequence split
  across ranks, through the same kernels;
- `ray_tpu_torch.models`: the Llama-family decoder (forward with remat,
  `LMTrainContext` training step) on one device or sharded over a mesh by
  the dp/fsdp/tp/fsdp_tp/sp/ep rules, and `params_from_numpy` /
  `state_from_numpy` to carry weights over from the JAX tree;
- `ray_tpu_torch.parallel`: meshes (`torch.distributed` DeviceMesh), the
  sharding rules, the process-group bootstrap and the device collectives;
- `ray_tpu_torch.serve`: `@serve.batch`, thread-based request batching.

Entry points run on `cuda` unless the caller passes `device="cpu"`.
"""
