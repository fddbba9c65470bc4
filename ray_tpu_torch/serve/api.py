"""Public Serve API.

ray: python/ray/serve/api.py (serve.run :458, @serve.deployment :254,
serve.start, serve.shutdown, serve.get_deployment_handle).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional, Union

import cloudpickle

import ray_tpu_torch
from ray_tpu_torch.serve.config import (
    SERVE_CONTROLLER_NAME,
    SERVE_NAMESPACE,
    AutoscalingConfig,
    DeploymentConfig,
    HTTPOptions,
)
from ray_tpu_torch.serve.controller import ServeController
from ray_tpu_torch.serve.http_proxy import HTTPProxy
from ray_tpu_torch.serve.router import DeploymentHandle, Router

_lock = threading.Lock()
_controller = None  # ActorHandle
_proxy = None  # ActorHandle
_router: Optional[Router] = None


def start(
    http_options: Optional[Union[HTTPOptions, dict]] = None,
    detached: bool = True,
) -> None:
    """Start (or connect to) the Serve controller; optionally an HTTP proxy.

    ray: serve.start — one controller per cluster, found by name."""
    global _controller, _proxy, _router
    ray_tpu_torch.init(ignore_reinit_error=True)
    with _lock:
        if _controller is None:
            _controller = (
                ray_tpu_torch.remote(ServeController)
                .options(
                    name=SERVE_CONTROLLER_NAME,
                    namespace=SERVE_NAMESPACE,
                    get_if_exists=True,
                    # Every router (driver, proxy, each graph replica)
                    # parks one long-poll listener on a concurrency slot;
                    # leave generous headroom for control calls.
                    max_concurrency=64,
                    # A crash-killed controller restarts instead of taking
                    # the control plane down with it (ray: the serve
                    # controller is detached + supervised the same way).
                    # Deployment state is re-declared by the next deploy();
                    # live replicas keep serving through the router tables
                    # the proxy already holds.
                    max_restarts=-1,
                )
                .remote()
            )
            ray_tpu_torch.get(_controller.ping.remote(), timeout=30)
            _router = Router(_controller)
        if http_options is not None and _proxy is None:
            if isinstance(http_options, dict):
                http_options = HTTPOptions(**http_options)
            _proxy = (
                ray_tpu_torch.remote(HTTPProxy)
                # max_restarts: a crash-killed proxy rebinds and serves
                # again (PR 1 soak gap (c): it used to stay dead).  The
                # restarted instance re-runs __init__ with the original
                # creation args — controller handle included — and
                # re-learns the routing table from the live controller.
                .options(max_concurrency=32, max_restarts=-1)
                .remote(
                    _controller, http_options.host, http_options.port,
                    http_options.max_connections,
                )
            )
            ray_tpu_torch.get(_proxy.ping.remote(), timeout=30)


def _ensure_started():
    if _controller is None:
        start()


class Application:
    """A deployment bound to its init args (ray: serve 2.x Application —
    the object `serve.run` accepts).

    Init args may contain OTHER Applications (deployment graphs,
    ray: serve/deployment_graph_build.py): `serve.run` deploys children
    first and the parent receives their DeploymentHandles — the ingress
    fans out to downstream deployments over plain handle calls."""

    def __init__(self, deployment: "Deployment", args: tuple, kwargs: dict):
        self.deployment = deployment
        self.init_args = args
        self.init_kwargs = kwargs

    def _resolve(self, _deployed: Optional[Dict[int, "DeploymentHandle"]] = None) -> "DeploymentHandle":
        """Deploy this node's children (depth-first, each once — the memo
        threads through the WHOLE graph so a diamond-shared child deploys
        a single time), then this deployment with child handles substituted
        into its init args."""
        deployed = _deployed if _deployed is not None else {}

        def subst(value):
            if isinstance(value, Application):
                if id(value) not in deployed:
                    deployed[id(value)] = value._resolve(deployed)
                return deployed[id(value)]
            if isinstance(value, list):
                return [subst(v) for v in value]
            if isinstance(value, tuple):
                return tuple(subst(v) for v in value)
            if isinstance(value, dict):
                return {k: subst(v) for k, v in value.items()}
            return value

        args = tuple(subst(a) for a in self.init_args)
        kwargs = {k: subst(v) for k, v in self.init_kwargs.items()}
        return self.deployment.deploy(*args, **kwargs)


class Deployment:
    """Result of @serve.deployment (ray: serve/deployment.py Deployment)."""

    def __init__(self, target: Union[type, Callable], name: str, config: DeploymentConfig):
        self._target = target
        self.name = name
        self.config = config

    def options(self, **opts) -> "Deployment":
        cfg = self.config.to_dict()
        name = opts.pop("name", self.name)
        for k, v in opts.items():
            if k not in cfg:
                raise TypeError(f"unknown deployment option {k!r}")
            cfg[k] = v
        return Deployment(self._target, name, DeploymentConfig.from_dict(cfg))

    def bind(self, *args, **kwargs) -> Application:
        return Application(self, args, kwargs)

    def deploy(self, *init_args, **init_kwargs) -> DeploymentHandle:
        _ensure_started()
        blob = cloudpickle.dumps(self._target)
        ray_tpu_torch.get(
            _controller.deploy.remote(
                self.name, blob, init_args, init_kwargs, self.config.to_dict()
            ),
            timeout=60,
        )
        ray_tpu_torch.get(
            _controller.wait_for_ready.remote(self.name, 60.0), timeout=70
        )
        return DeploymentHandle(self.name, _router)

    def __call__(self, *a, **kw):
        raise TypeError(
            "deployments are not directly callable; use .deploy() + handle.remote()"
        )


def deployment(
    _target: Optional[Union[type, Callable]] = None,
    *,
    name: Optional[str] = None,
    num_replicas: int = 1,
    max_concurrent_queries: int = 8,
    user_config: Any = None,
    autoscaling_config: Optional[Union[AutoscalingConfig, dict]] = None,
    health_check_period_s: float = 0.25,
    health_check_timeout_s: float = 10.0,
    graceful_shutdown_timeout_s: float = 5.0,
    ray_actor_options: Optional[Dict[str, Any]] = None,
):
    """@serve.deployment decorator (ray: serve/api.py:254)."""

    def deco(target):
        cfg = DeploymentConfig(
            num_replicas=num_replicas,
            max_concurrent_queries=max_concurrent_queries,
            user_config=user_config,
            autoscaling_config=autoscaling_config,
            health_check_period_s=health_check_period_s,
            health_check_timeout_s=health_check_timeout_s,
            graceful_shutdown_timeout_s=graceful_shutdown_timeout_s,
            ray_actor_options=ray_actor_options or {},
        )
        return Deployment(target, name or target.__name__, cfg)

    if _target is not None:
        return deco(_target)
    return deco


def run(app: Union[Application, Deployment], **kwargs) -> DeploymentHandle:
    """Deploy an application — including any deployment GRAPH bound into
    its init args — and return the ingress handle (ray: serve.run :458)."""
    if isinstance(app, Deployment):
        app = app.bind()
    return app._resolve()


def get_deployment_handle(name: str) -> DeploymentHandle:
    _ensure_started()
    return DeploymentHandle(name, _router)


def get_http_address() -> Optional[str]:
    if _proxy is None:
        return None
    return ray_tpu_torch.get(_proxy.address.remote(), timeout=10)


def status() -> Dict[str, Any]:
    _ensure_started()
    return ray_tpu_torch.get(_controller.list_deployments.remote(), timeout=10)


def delete(name: str) -> None:
    _ensure_started()
    ray_tpu_torch.get(_controller.delete_deployment.remote(name), timeout=30)


def shutdown() -> None:
    """Tear down all deployments + the controller/proxy."""
    global _controller, _proxy, _router
    with _lock:
        if _controller is not None:
            try:
                ray_tpu_torch.get(_controller.shutdown.remote(), timeout=30)
                ray_tpu_torch.kill(_controller)
            except Exception:
                pass
        if _proxy is not None:
            try:
                ray_tpu_torch.get(_proxy.shutdown.remote(), timeout=10)
                ray_tpu_torch.kill(_proxy)
            except Exception:
                pass
        if _router is not None:
            _router.stop()
        from ray_tpu_torch.serve import router as _router_mod

        with _router_mod._process_router_lock:
            if _router_mod._process_router is not None:
                _router_mod._process_router.stop()
                _router_mod._process_router = None
        _controller = None
        _proxy = None
        _router = None
