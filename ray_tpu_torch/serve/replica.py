"""Replica: the actor that hosts one copy of a deployment's user callable.

ray: python/ray/serve/_private/replica.py:57 (RayServeReplica;
handle_request :507).  The replica actor runs with
max_concurrency = max_concurrent_queries + control slots, so health checks
and metrics answer even while every query slot is busy — the same reason the
reference separates its control-plane concurrency group.
"""

from __future__ import annotations

import inspect
import threading
import time
from typing import Any, Dict, Optional

import cloudpickle

_STREAM_END = object()


class Replica:
    """Actor payload.  Instantiated by the controller via
    `ray_tpu_torch.remote(Replica).options(...).remote(...)`."""

    def __init__(
        self,
        deployment_name: str,
        replica_id: str,
        callable_blob: bytes,
        init_args: tuple,
        init_kwargs: dict,
        user_config: Any = None,
    ):
        self._deployment_name = deployment_name
        self._replica_id = replica_id
        target = cloudpickle.loads(callable_blob)
        if inspect.isclass(target):
            self._callable = target(*init_args, **(init_kwargs or {}))
            self._is_function = False
        else:
            self._callable = target
            self._is_function = True
        self._lock = threading.Lock()
        self._ongoing = 0
        self._processed = 0
        self._start_time = time.time()
        self._streams: Dict[str, Any] = {}  # stream_id -> live generator
        self._stream_counter = 0
        # Replica telemetry (ray: serve's autoscaling_metrics push): queue
        # depth + request latency recorded into this process's registry,
        # shipped to the head by the worker's generic metric push — the
        # measurement ROADMAP item 3's autoscaler consumes.
        from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram

        tags = {"deployment": deployment_name, "replica": replica_id}
        self._m_queue = Gauge(
            "serve_replica_queue_depth",
            "in-flight requests on this replica",
            tag_keys=("deployment", "replica"),
        ).set_default_tags(tags)
        self._m_latency = Histogram(
            "serve_replica_request_latency_s",
            "request handling latency",
            boundaries=[0.001, 0.005, 0.02, 0.1, 0.5, 2.0, 10.0],
            tag_keys=("deployment", "replica"),
        ).set_default_tags(tags)
        self._m_requests = Counter(
            "serve_replica_requests",
            "requests processed (by outcome)",
            tag_keys=("deployment", "replica", "outcome"),
        ).set_default_tags(tags)
        if user_config is not None:
            self.reconfigure(user_config)

    # -- data plane -------------------------------------------------------
    def handle_request(self, method_name: str, args: tuple, kwargs: dict):
        """Execute one request.  Called concurrently from the actor's
        thread pool (one slot per in-flight query)."""
        from ray_tpu_torch.util import tracing

        t0 = time.perf_counter()
        outcome = "error"
        with self._lock:
            self._ongoing += 1
            self._m_queue.set(self._ongoing)
        try:
            if self._is_function:
                fn = self._callable
            else:
                fn = getattr(self._callable, method_name or "__call__")
            # The request span tree's leaf: parents to the ambient
            # run::handle_request span, which carries the proxy's trace
            # id via the spec's trace_ctx — one parented tree per serve
            # request in the merged timeline.
            with tracing.span(
                "serve::replica",
                attrs={
                    "deployment": self._deployment_name,
                    "replica": self._replica_id,
                },
            ):
                out = fn(*args, **(kwargs or {}))
                if inspect.iscoroutine(out):
                    import asyncio

                    out = asyncio.run(out)
            outcome = "ok"
            return out
        finally:
            with self._lock:
                self._ongoing -= 1
                self._processed += 1
                self._m_queue.set(self._ongoing)
            self._m_latency.observe(time.perf_counter() - t0)
            self._m_requests.inc(tags={"outcome": outcome})

    # -- streaming data plane (ray: replica.py handle_request_streaming /
    #    ObjectRefGenerator semantics, pulled replica-side) ----------------
    def stream_start(self, method_name: str, args: tuple, kwargs: dict) -> str:
        """Begin a streaming call: the user method must return a generator
        (e.g. an LM decode loop yielding tokens).  Returns a stream id the
        caller pulls with stream_next — sticky to THIS replica."""
        import inspect as _inspect

        if self._is_function:
            fn = self._callable
        else:
            fn = getattr(self._callable, method_name or "__call__")
        gen = fn(*args, **(kwargs or {}))
        if not (_inspect.isgenerator(gen) or hasattr(gen, "__next__")):
            gen = iter([gen])  # non-generator result: one-item stream
        with self._lock:
            self._stream_counter += 1
            sid = f"s{self._stream_counter}"
            self._streams[sid] = gen
            self._ongoing += 1  # a live stream occupies queue capacity
        return sid

    def stream_next(self, sid: str, max_items: int = 1):
        """Pull the next item from the stream.  Returns (items, done).
        One item per call: a sync generator has no "ready" notion, so
        pulling more would block on FUTURE items and destroy
        time-to-first-token — the per-token RPC is the price of streaming
        over a sync generator (the reference streams per-item over its
        generator refs for the same reason)."""
        gen = self._streams.get(sid)
        if gen is None:
            return [], True
        try:
            item = next(gen)
        except StopIteration:
            self._close_stream(sid)
            return [], True
        except Exception:
            self._close_stream(sid)
            raise
        return [item], False

    def stream_cancel(self, sid: str) -> None:
        """Client abandoned the stream (disconnect / GC'd iterator): drop
        the generator so its captured state frees and it stops counting as
        an ongoing query."""
        gen = self._streams.get(sid)
        if gen is not None and hasattr(gen, "close"):
            try:
                gen.close()  # runs the generator's finally blocks
            except Exception:
                pass
        self._close_stream(sid)

    def _close_stream(self, sid: str) -> None:
        with self._lock:
            if self._streams.pop(sid, None) is not None:
                self._ongoing -= 1
                self._processed += 1

    # -- control plane ----------------------------------------------------
    def reconfigure(self, user_config: Any) -> None:
        """ray: replica.py reconfigure — forwarded to the user callable's
        `reconfigure` method when it defines one."""
        if not self._is_function and hasattr(self._callable, "reconfigure"):
            self._callable.reconfigure(user_config)

    def check_health(self) -> Dict[str, Any]:
        """Liveness + the queue metric the autoscaler consumes
        (ray: _private/autoscaling_metrics.py pushes; we pull on the same
        health-check RPC to halve control traffic)."""
        if not self._is_function and hasattr(self._callable, "check_health"):
            # User-defined health check: raising marks the replica unhealthy.
            self._callable.check_health()
        with self._lock:
            return {
                "replica_id": self._replica_id,
                "ongoing": self._ongoing,
                "processed": self._processed,
                "uptime_s": time.time() - self._start_time,
            }

    def prepare_for_shutdown(self, timeout_s: float = 5.0) -> bool:
        """Drain: wait for in-flight queries to finish before the controller
        kills the actor (ray: replica.py graceful shutdown)."""
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            with self._lock:
                if self._ongoing == 0:
                    return True
            time.sleep(0.02)
        return False
