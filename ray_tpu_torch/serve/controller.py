"""ServeController: the reconciliation brain of Serve.

ray: python/ray/serve/controller.py:64 (ServeController; deploy :363) +
_private/deployment_state.py:962,1812 (DeploymentState(Manager) reconcile).
One named controller actor holds the target state for every deployment and
runs a background reconcile loop:

  target num_replicas  vs  live replicas  →  start / drain+kill
  health checks (pull)  →  dead replica   →  replace
  queue-depth metrics   →  autoscaler     →  adjust target within bounds

Routers learn membership by polling `get_routing_table(version)` — the
pull analogue of the reference's LongPollHost (long_poll.py:185): the
version bumps on every membership change, so callers cheaply detect "no
change" without shipping the table.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import ray_tpu_torch
from ray_tpu_torch.serve.config import AutoscalingConfig, DeploymentConfig
from ray_tpu_torch.serve.replica import Replica


class _DeploymentState:
    """Controller-side record for one deployment
    (ray: deployment_state.py DeploymentState)."""

    def __init__(self, name: str, blob: bytes, init_args, init_kwargs, config: DeploymentConfig):
        self.name = name
        self.blob = blob
        self.init_args = init_args or ()
        self.init_kwargs = init_kwargs or {}
        self.config = config
        self.replicas: Dict[str, Any] = {}  # replica_id -> ActorHandle
        self.inflight_health: Dict[str, Any] = {}  # replica_id -> pending ref
        self.last_metrics: Dict[str, float] = {}  # replica_id -> ongoing
        self.autoscale_target: Optional[int] = None  # autoscaler's current decision
        self._scale_signal_since: Optional[float] = None
        self._scale_signal_dir = 0
        self._counter = 0

    def next_replica_id(self) -> str:
        self._counter += 1
        return f"{self.name}#{self._counter}"

    def target_replicas(self) -> int:
        if self.config.autoscaling_config is not None:
            ac = self.config.autoscaling_config
            if self.autoscale_target is None:
                self.autoscale_target = max(ac.min_replicas, min(self.config.num_replicas, ac.max_replicas))
            return self.autoscale_target
        return self.config.num_replicas


class ServeController:
    def __init__(self, reconcile_period_s: float = 0.25):
        self._deployments: Dict[str, _DeploymentState] = {}
        self._lock = threading.RLock()
        self._version = 0
        # Long-poll push (ray: _private/long_poll.py:185 LongPollHost):
        # routers park a listen_for_change call on the SHARED pubsub
        # long-poll abstraction (pubsub.py — the same Publisher plane the
        # runtime and GCS use); every version bump notifies them, so
        # membership/config changes reach the data plane in push latency.
        from ray_tpu_torch._private.pubsub import LongPollHost

        self._longpoll = LongPollHost()
        self._stop = threading.Event()
        self._period = reconcile_period_s
        self._thread = threading.Thread(
            target=self._reconcile_loop, daemon=True, name="serve-reconciler"
        )
        self._thread.start()

    def _bump_version_locked(self) -> None:
        self._version += 1
        self._longpoll.notify("routing", self._version)

    def listen_for_change(
        self, known_version: int, timeout_s: float = 30.0
    ) -> Optional[Dict[str, Any]]:
        """Park until the routing table moves past known_version (or the
        chunk timeout lapses — caller immediately re-listens).  Runs on one
        of the controller actor's concurrency slots
        (ray: LongPollHost.listen_for_change)."""
        moved = self._longpoll.wait_for_change(
            "routing",
            lambda: self._version > known_version or self._stop.is_set(),
            timeout_s,
        )
        if not moved or self._version <= known_version:
            return None
        return self.get_routing_table(known_version)

    # -- public control API (called by serve.api / routers) ----------------
    def deploy(
        self,
        name: str,
        callable_blob: bytes,
        init_args: tuple,
        init_kwargs: dict,
        config_dict: Dict[str, Any],
    ) -> None:
        config = DeploymentConfig.from_dict(config_dict)
        with self._lock:
            existing = self._deployments.get(name)
            if existing is None:
                self._deployments[name] = _DeploymentState(
                    name, callable_blob, init_args, init_kwargs, config
                )
            else:
                code_changed = callable_blob != existing.blob or (
                    (init_args, init_kwargs) != (existing.init_args, existing.init_kwargs)
                )
                user_config_changed = config.user_config != existing.config.user_config
                existing.blob = callable_blob
                existing.init_args = init_args or ()
                existing.init_kwargs = init_kwargs or {}
                existing.config = config
                existing.autoscale_target = None
                if code_changed:
                    # Code redeploy: replace every replica (reference does a
                    # rolling update; all-at-once keeps v0 simple & correct).
                    for rid, h in list(existing.replicas.items()):
                        self._drain_and_kill(existing, rid, h)
                elif user_config_changed and config.user_config is not None:
                    for h in existing.replicas.values():
                        h.reconfigure.remote(config.user_config)
            self._bump_version_locked()
        # Reconcile synchronously once so deploy() returning means "replicas
        # are starting" (tests and users can then poll wait_for_ready).
        self._reconcile_once()

    def delete_deployment(self, name: str) -> None:
        with self._lock:
            st = self._deployments.pop(name, None)
            if st is not None:
                for rid, h in list(st.replicas.items()):
                    self._drain_and_kill(st, rid, h)
                self._bump_version_locked()

    def list_deployments(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {
                name: {
                    "target_replicas": st.target_replicas(),
                    "live_replicas": len(st.replicas),
                    "config": st.config.to_dict(),
                }
                for name, st in self._deployments.items()
            }

    def routing_version(self) -> int:
        return self._version

    def get_routing_table(
        self, known_version: int = -1
    ) -> Optional[Dict[str, Any]]:
        """Return {deployment: {replicas, max_concurrent_queries}}, or None
        when the caller's version is current (cheap no-change path)."""
        with self._lock:
            if known_version == self._version:
                return None
            table = {}
            for name, st in self._deployments.items():
                table[name] = {
                    "replicas": list(st.replicas.items()),
                    "max_concurrent_queries": st.config.max_concurrent_queries,
                }
            return {"version": self._version, "table": table}

    def wait_for_ready(self, name: str, timeout_s: float = 30.0) -> bool:
        """Block until the deployment has its target replica count live."""
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            with self._lock:
                st = self._deployments.get(name)
                if st is not None and len(st.replicas) >= st.target_replicas() > 0:
                    return True
            time.sleep(0.05)
        return False

    def shutdown(self) -> None:
        self._stop.set()
        with self._lock:
            for st in self._deployments.values():
                for rid, h in list(st.replicas.items()):
                    self._drain_and_kill(st, rid, h)
            self._deployments.clear()
            self._bump_version_locked()

    def ping(self) -> str:
        return "pong"

    # -- reconciliation -----------------------------------------------------
    def _start_replica(self, st: _DeploymentState) -> None:
        rid = st.next_replica_id()
        opts = dict(st.config.ray_actor_options or {})
        # +2 control slots: check_health / reconfigure / drain must answer
        # while all query slots are busy.
        handle = (
            ray_tpu_torch.remote(Replica)
            .options(
                max_concurrency=st.config.max_concurrent_queries + 2,
                **opts,
            )
            .remote(
                st.name,
                rid,
                st.blob,
                st.init_args,
                st.init_kwargs,
                st.config.user_config,
            )
        )
        st.replicas[rid] = handle

    def _drain_and_kill(self, st: _DeploymentState, rid: str, handle) -> None:
        st.replicas.pop(rid, None)
        st.inflight_health.pop(rid, None)
        st.last_metrics.pop(rid, None)
        try:
            # Fire-and-forget drain, then kill. The drain ref is collected by
            # the kill below regardless of outcome.
            handle.prepare_for_shutdown.remote(st.config.graceful_shutdown_timeout_s)
            ray_tpu_torch.kill(handle)
        except Exception:
            pass

    def _reconcile_once(self) -> None:
        with self._lock:
            states = list(self._deployments.values())
        changed = False
        for st in states:
            with self._lock:
                changed |= self._check_health(st)
                changed |= self._autoscale(st)
                target = st.target_replicas()
                live = len(st.replicas)
                if live < target:
                    for _ in range(target - live):
                        self._start_replica(st)
                    changed = True
                elif live > target:
                    # Drop the newest replicas first (oldest have warm caches /
                    # compiled programs — keep them).
                    doomed = sorted(st.replicas.keys())[target - live :]
                    for rid in doomed:
                        self._drain_and_kill(st, rid, st.replicas[rid])
                    changed = True
        if changed:
            with self._lock:
                self._bump_version_locked()
        self._publish_replica_targets()

    def _publish_replica_targets(self) -> None:
        """Publish {deployment: {target, live}} to GCS kv so the head's
        demand summary (and the elastic autoscaler behind it) can see serve
        capacity pressure without holding an actor handle to this
        controller.  Best-effort: the kv row is advisory demand telemetry,
        a missed publish just means the autoscaler acts one reconcile
        period later."""
        import json

        with self._lock:
            targets = {
                name: {
                    "target": st.target_replicas(),
                    "live": len(st.replicas),
                }
                for name, st in self._deployments.items()
            }
        try:
            from ray_tpu_torch._private.client import client

            client.kv_put(
                "replica_targets",
                json.dumps(targets, sort_keys=True).encode(),
                namespace="serve",
            )
        except Exception:
            pass

    def _check_health(self, st: _DeploymentState) -> bool:
        """Pull-based health check (ray: gcs_health_check_manager.h:39 at the
        node level; serve replica checks at deployment_state.py).  Issues
        check_health to every replica, reaps answers next cycle."""
        changed = False
        # Collect previously issued checks.
        for rid, (ref, issued_at) in list(st.inflight_health.items()):
            if rid not in st.replicas:
                st.inflight_health.pop(rid)
                continue
            ready, _ = ray_tpu_torch.wait([ref], num_returns=1, timeout=0)
            if not ready:
                # Replicas that never answered a check yet are still
                # STARTING (jax import + first jit can take tens of seconds);
                # give them a generous grace before declaring them hung
                # (ray: deployment_state.py distinguishes STARTING from
                # RUNNING health checks).
                limit = st.config.health_check_timeout_s
                if rid not in st.last_metrics:
                    limit = max(limit, 120.0)
                if time.time() - issued_at > limit:
                    # Hung replica: treat as dead (ray: deployment_state.py
                    # health-check timeout path).
                    st.inflight_health.pop(rid)
                    h = st.replicas.pop(rid, None)
                    st.last_metrics.pop(rid, None)
                    if h is not None:
                        try:
                            ray_tpu_torch.kill(h)
                        except Exception:
                            pass
                    changed = True
                continue
            st.inflight_health.pop(rid)
            try:
                m = ray_tpu_torch.get(ref, timeout=1)
                st.last_metrics[rid] = float(m.get("ongoing", 0))
            except Exception:
                # Dead or failing replica: remove; the sizing pass replaces it.
                h = st.replicas.pop(rid, None)
                st.last_metrics.pop(rid, None)
                if h is not None:
                    try:
                        ray_tpu_torch.kill(h)
                    except Exception:
                        pass
                changed = True
        # Issue fresh checks for replicas without one in flight.
        for rid, h in st.replicas.items():
            if rid not in st.inflight_health:
                try:
                    st.inflight_health[rid] = (h.check_health.remote(), time.time())
                except Exception:
                    changed = True
        return changed

    def _autoscale(self, st: _DeploymentState) -> bool:
        ac = st.config.autoscaling_config
        if ac is None or not st.replicas:
            return False
        total_ongoing = sum(st.last_metrics.get(rid, 0.0) for rid in st.replicas)
        desired = math.ceil(total_ongoing / ac.target_ongoing_requests)
        desired = max(ac.min_replicas, min(desired, ac.max_replicas))
        current = st.target_replicas()
        if desired == current:
            st._scale_signal_since = None
            st._scale_signal_dir = 0
            return False
        direction = 1 if desired > current else -1
        now = time.time()
        if st._scale_signal_dir != direction:
            st._scale_signal_dir = direction
            st._scale_signal_since = now
            return False
        delay = ac.upscale_delay_s if direction > 0 else ac.downscale_delay_s
        if now - (st._scale_signal_since or now) >= delay:
            st.autoscale_target = desired
            st._scale_signal_since = None
            st._scale_signal_dir = 0
            return True
        return False

    def _reconcile_loop(self) -> None:
        while not self._stop.wait(self._period):
            try:
                self._reconcile_once()
            except Exception:
                # The reconciler must never die; errors surface via health
                # checks and deploy() retries.
                pass
