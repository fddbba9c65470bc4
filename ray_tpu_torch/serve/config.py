"""Serve configuration objects.

ray: python/ray/serve/config.py — DeploymentConfig / AutoscalingConfig /
HTTPOptions.  Kept as plain dataclasses; validation happens here so the
controller can trust what it stores.
"""

from __future__ import annotations

from dataclasses import dataclass, field, asdict
from typing import Any, Dict, Optional


@dataclass
class AutoscalingConfig:
    """Queue-depth autoscaling (ray: serve/_private/autoscaling_policy.py).

    desired = ceil(total_ongoing_requests / target_ongoing_requests),
    clamped to [min_replicas, max_replicas]; scale decisions are debounced
    by upscale_delay_s / downscale_delay_s of consistent signal.
    """

    min_replicas: int = 1
    max_replicas: int = 1
    target_ongoing_requests: float = 2.0
    upscale_delay_s: float = 0.5
    downscale_delay_s: float = 3.0

    def __post_init__(self):
        if self.min_replicas < 0 or self.max_replicas < self.min_replicas:
            raise ValueError("need 0 <= min_replicas <= max_replicas")
        if self.target_ongoing_requests <= 0:
            raise ValueError("target_ongoing_requests must be > 0")


@dataclass
class DeploymentConfig:
    """Per-deployment target state held by the controller
    (ray: serve/config.py DeploymentConfig)."""

    num_replicas: int = 1
    max_concurrent_queries: int = 8
    user_config: Optional[Any] = None
    autoscaling_config: Optional[AutoscalingConfig] = None
    health_check_period_s: float = 0.25
    health_check_timeout_s: float = 10.0
    graceful_shutdown_timeout_s: float = 5.0
    ray_actor_options: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        if isinstance(self.autoscaling_config, dict):
            self.autoscaling_config = AutoscalingConfig(**self.autoscaling_config)
        if self.num_replicas < 0:
            raise ValueError("num_replicas must be >= 0")
        if self.max_concurrent_queries < 1:
            raise ValueError("max_concurrent_queries must be >= 1")

    def to_dict(self) -> Dict[str, Any]:
        d = asdict(self)
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DeploymentConfig":
        d = dict(d)
        ac = d.get("autoscaling_config")
        if isinstance(ac, dict):
            d["autoscaling_config"] = AutoscalingConfig(**ac)
        return cls(**d)


@dataclass
class HTTPOptions:
    """ray: serve/config.py HTTPOptions. port=0 picks a free port."""

    host: str = "127.0.0.1"
    port: int = 8000
    # 0 = the serve_proxy_max_connections config knob.  Connections beyond
    # the bound are refused with 503 at accept (ray: uvicorn
    # limit-concurrency role).
    max_connections: int = 0


# Controller actor's well-known name (ray: serve/_private/constants.py
# SERVE_CONTROLLER_NAME).
SERVE_CONTROLLER_NAME = "_serve_controller"
SERVE_NAMESPACE = "_serve"
