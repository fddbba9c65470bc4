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
- `ray_tpu_torch.serve`: `@serve.batch`, thread-based request batching;
- `ray_tpu_torch.air`, `ray_tpu_torch.train`, `ray_tpu_torch.data`: the
  checkpoint, the data-parallel trainer (`TorchTrainer`, worker actors
  joined by `TorchConfig` into an NCCL or gloo group) and datasets;
- `ray_tpu_torch.tune`, `workflow`, `train.torch` and the
  `util.multiprocessing` and `util.joblib` bridges: copies of the JAX
  package's libraries over the runtime (a Tuner over `TorchTrainer` runs
  its trials on the cards in turn), and `parallel`'s host
  `CollectiveGroup`;
- the actor runtime below them (`init`, `remote`, `get`, `put`, `wait`,
  `kill`, ...): a copy of `ray_tpu`'s runtime, package name rewritten,
  whose only changes are that it detects GPUs (`/dev/nvidia<N>`),
  registers the `"GPU"` resource that `num_gpus=` reserves, and gives a
  grant of whole cards their ids (`get_gpu_ids`), which its worker sees as
  its CUDA_VISIBLE_DEVICES.

Entry points run on `cuda` unless the caller passes `device="cpu"`.

Importing ray_tpu_torch must stay light: no torch import happens until
you touch ray_tpu_torch.ops / models / parallel / air / train / tune.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ray_tpu_torch import exceptions
from ray_tpu_torch._private.client import client
from ray_tpu_torch._private.refs import ObjectRef
from ray_tpu_torch.actor import ActorClass, ActorHandle, exit_actor, get_actor
from ray_tpu_torch.remote_function import RemoteFunction, remote

__version__ = "0.1.0"

__all__ = [
    "init",
    "shutdown",
    "is_initialized",
    "remote",
    "get",
    "put",
    "wait",
    "kill",
    "cancel",
    "get_actor",
    "exit_actor",
    "ObjectRef",
    "ActorClass",
    "ActorHandle",
    "RemoteFunction",
    "available_resources",
    "cluster_resources",
    "exceptions",
    "nodes",
]


def init(
    num_cpus: Optional[int] = None,
    resources: Optional[Dict[str, float]] = None,
    namespace: str = "default",
    ignore_reinit_error: bool = False,
    _system_config: Optional[Dict[str, Any]] = None,
    address: Optional[str] = None,
    _authkey: Optional[str] = None,
    log_to_driver: bool = True,
    **_unused,
):
    """Start the per-host runtime (driver mode), or ATTACH to a standalone
    head process when `address` is given (head-split mode — the analogue of
    ray.init(address=...) / the Ray Client ray:// attach).

    address: path to a head.json / its session dir (written by
    `python -m ray_tpu_torch._private.head`), or "host:port" with `_authkey`.
    An attached driver can die (even kill -9) without taking the cluster
    down; detached actors keep serving and a new driver can re-attach.

    Inside a worker process this is a no-op (the worker is already connected),
    matching the reference's behavior for nested init.

    _system_config: programmatic overrides of the runtime knob table
    (ray: ray.init(_system_config=...); see _private/config.py for the
    knobs — env form is RAY_TPU_<NAME>).  Applied driver-side; workers read
    the env forms they inherit.
    """
    from ray_tpu_torch._private import runtime as rt
    from ray_tpu_torch._private.worker_proc import get_worker_runtime

    if get_worker_runtime() is not None:
        return
    if rt.is_initialized():
        if ignore_reinit_error:
            return
        raise RuntimeError("ray_tpu_torch.init() called twice (pass ignore_reinit_error=True)")
    if _system_config:
        from ray_tpu_torch._private import config as _cfg

        _cfg.set_system_config(_system_config)
    if address is not None:
        from ray_tpu_torch._private import driver_client

        driver_client.attach(
            address, authkey=_authkey, namespace=namespace,
            log_to_driver=log_to_driver,
        )
        return
    runtime = rt.init_runtime(
        num_cpus=num_cpus, resources=resources, namespace=namespace
    )
    # Honor the flag in LOCAL driver mode too (the runtime's default comes
    # from the log_to_driver config knob).
    runtime.log_to_driver = bool(log_to_driver) and runtime.log_to_driver


def shutdown():
    from ray_tpu_torch._private import driver_client
    from ray_tpu_torch._private import runtime as rt

    if driver_client.is_attached():
        driver_client.detach()
        return
    rt.shutdown_runtime()


def is_initialized() -> bool:
    from ray_tpu_torch._private import runtime as rt
    from ray_tpu_torch._private.worker_proc import get_worker_runtime

    return rt.is_initialized() or get_worker_runtime() is not None


def _auto_init():
    from ray_tpu_torch._private import runtime as rt
    from ray_tpu_torch._private.worker_proc import get_worker_runtime

    if not rt.is_initialized() and get_worker_runtime() is None:
        init()


def get(refs, *, timeout: Optional[float] = None):
    _auto_init()
    return client.get(refs, timeout)


def put(value: Any) -> ObjectRef:
    _auto_init()
    return client.put(value)


def wait(refs, *, num_returns: int = 1, timeout: Optional[float] = None, fetch_local=True):
    _auto_init()
    if not isinstance(refs, list):
        raise TypeError("ray_tpu_torch.wait() expects a list of ObjectRefs")
    if num_returns > len(refs):
        raise ValueError("num_returns exceeds number of refs")
    return client.wait(refs, num_returns, timeout, fetch_local)


def kill(actor: ActorHandle, *, no_restart: bool = True):
    client.kill_actor(actor._id, no_restart)


def cancel(ref: ObjectRef, *, force: bool = False):
    client.cancel(ref, force)


def available_resources() -> Dict[str, float]:
    _auto_init()
    return client.available_resources()


def cluster_resources() -> Dict[str, float]:
    _auto_init()
    return client.cluster_resources()


def nodes():
    """List cluster nodes (ray: ray.nodes())."""
    from ray_tpu_torch._private.runtime import get_runtime

    rt = get_runtime()
    return [
        {
            "NodeID": n.node_id,
            "Alive": n.alive,
            "Resources": dict(n.resources),
            "Available": dict(n.available),
            "IsHead": n.is_head,
        }
        for n in rt.state.nodes.values()
    ]


def get_gpu_ids():
    """The card ids of this worker's whole-"GPU" grant (ray: ray.get_gpu_ids()):
    indices into the cards the runtime process sees. The worker's own
    CUDA_VISIBLE_DEVICES names those cards, so its "cuda" is the first of
    them. Empty in the process that started the runtime, and for a
    fractional "GPU" request."""
    from ray_tpu_torch._private.gpu_ids import get_gpu_ids as ids

    return ids()
