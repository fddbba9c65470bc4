"""ray_tpu_torch.serve — model serving on the actor runtime.

ray: python/ray/serve/ — controller/replica reconciliation
(controller.py:64, _private/deployment_state.py:1812), router with
power-of-two-choices + max-in-flight (_private/router.py:221), HTTP proxy
(_private/http_proxy.py:234), @serve.batch batching (batching.py).

TPU-first design notes:
- replicas are plain actors whose callable jits once and then serves
  batched inference; @serve.batch keeps the MXU on large matmuls;
- the request path is ONE actor hop (router lives in the caller);
- the controller is a named actor running a reconcile loop — membership
  flows to routers via version-gated pulls, not per-request lookups.
"""

from ray_tpu_torch.serve.api import (
    Application,
    Deployment,
    delete,
    deployment,
    get_deployment_handle,
    get_http_address,
    run,
    shutdown,
    start,
    status,
)
from ray_tpu_torch.serve.batching import batch
from ray_tpu_torch.serve.config import AutoscalingConfig, DeploymentConfig, HTTPOptions
from ray_tpu_torch.serve.router import DeploymentHandle

__all__ = [
    "Application",
    "AutoscalingConfig",
    "Deployment",
    "DeploymentConfig",
    "DeploymentHandle",
    "HTTPOptions",
    "batch",
    "delete",
    "deployment",
    "get_deployment_handle",
    "get_http_address",
    "run",
    "shutdown",
    "start",
    "status",
]
