"""ray_tpu_torch.autoscaler — demand-driven node fleet reconciliation.

ray: python/ray/autoscaler/ (StandardAutoscaler at
_private/autoscaler.py:168, ResourceDemandScheduler :103, NodeProvider ABC
at node_provider.py:13).  TPU-first notes: node types are host shapes
(optionally whole TPU slices via TPUPodNodeProvider); demand is read
straight from the runtime's queued tasks + pending gang bundles rather
than a separate load-metrics pipeline.
"""

from ray_tpu_torch.autoscaler.autoscaler import (
    AutoscalerConfig,
    NodeTypeConfig,
    StandardAutoscaler,
)
from ray_tpu_torch.autoscaler.node_provider import (
    LocalNodeProvider,
    NodeProvider,
    TPUPodNodeProvider,
)

__all__ = [
    "AutoscalerConfig",
    "LocalNodeProvider",
    "NodeProvider",
    "NodeTypeConfig",
    "StandardAutoscaler",
    "TPUPodNodeProvider",
]
