"""Router + DeploymentHandle: the request data plane.

ray: python/ray/serve/_private/router.py:221 (ReplicaSet.assign_replica —
power-of-two-choices with max-in-flight) and handle.py (DeploymentHandle).
The router lives in the CALLER's process (driver or HTTP proxy actor) and
talks straight to replica actors — the controller is only consulted to
refresh membership (version-gated pull, see controller.get_routing_table),
never per-request.  That keeps the request path one actor hop, the property
the reference's direct actor transport exists for (SURVEY §3.6).
"""

from __future__ import annotations

import random
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import ray_tpu_torch


class _StreamToken:
    """In-flight marker for a LIVE stream: a stream's first ref resolves
    immediately (stream_start returns a sid), so admission control tracks
    this token instead — it stays in-flight until the stream closes."""

    __slots__ = ("done",)

    def __init__(self):
        self.done = False


class _ReplicaSet:
    """Replica membership + local in-flight accounting for one deployment.

    Thread-safe on its OWN lock: assign() can block (backpressure) and
    must not hold the Router's lock while doing so — the long-poll push
    that adds capacity has to be able to land mid-wait."""

    def __init__(self, max_concurrent_queries: int):
        self._lock = threading.Lock()
        self.max_concurrent = max_concurrent_queries
        self.replicas: List[Tuple[str, Any]] = []  # (replica_id, handle)
        # replica_id -> outstanding refs + live-stream tokens
        self.inflight: Dict[str, List[Any]] = {}

    def update(self, replicas: List[Tuple[str, Any]], max_concurrent: int):
        with self._lock:
            self.replicas = list(replicas)
            self.max_concurrent = max_concurrent
            live = {rid for rid, _ in replicas}
            self.inflight = {
                rid: refs for rid, refs in self.inflight.items() if rid in live
            }

    _STALE_ENTRY_S = 120.0

    @staticmethod
    def _ref_state(ref):
        """Local-only readiness: True = definitively pending, False =
        definitively done, None = unknowable here.  The caller's direct
        transport knows the state of its own calls without ANY head
        traffic; a head wait here (the old implementation) put a hidden
        owner round trip on every assignment AND stalled the whole data
        plane for the reconnect window during a head outage — the proxy
        must keep serving while the head is down."""
        from ray_tpu_torch._private.worker_proc import get_worker_runtime

        wr = get_worker_runtime()
        if wr is not None:
            if wr.direct is not None:
                r = wr.direct.ready_local(ref.id)
                if r is not None:
                    return not r  # owned: definitive either way
            # Relayed ref (e.g. the first calls before the direct route
            # resolved): the process still KNOWS completion once anything
            # here resolved the value (get_value marks known_materialized).
            if wr.known_materialized(ref.id):
                return False
            return None
        # Driver-side handle: the in-process runtime's store answers
        # readiness as a local dict check.
        from ray_tpu_torch._private import runtime as rt_mod

        if rt_mod.is_initialized():
            return not rt_mod.get_runtime().store.is_ready(ref.id)
        return None

    def _purge_locked(self, rid: str):
        entries = self.inflight.get(rid)
        if not entries:
            return
        now = time.monotonic()
        keep = []
        for e, ts in entries:
            if isinstance(e, _StreamToken):
                if not e.done:
                    keep.append((e, ts))
                continue
            state = self._ref_state(e)
            if state is True:
                keep.append((e, ts))  # definitively pending: NEVER aged —
                # a 5-minute inference must keep counting against capacity
            elif state is None and now - ts < self._STALE_ENTRY_S:
                # Unknowable here (relayed, never resolved locally): age
                # out so it can't count against capacity forever.
                keep.append((e, ts))
        self.inflight[rid] = keep

    def record(self, rid: str, entry: Any) -> None:
        with self._lock:
            self.inflight.setdefault(rid, []).append((entry, time.monotonic()))

    def has_replicas(self) -> bool:
        with self._lock:
            return bool(self.replicas)

    def assign(self) -> Tuple[str, Any]:
        """Pick a replica: power-of-two-choices on local in-flight count
        (ray: router.py:221).  Blocks (with purging) while every replica is
        at max_concurrent — that's the handle-side backpressure."""
        deadline = time.time() + 60.0
        while True:
            with self._lock:
                if not self.replicas:
                    raise RuntimeError("no live replicas")
                if len(self.replicas) == 1:
                    cands = [self.replicas[0]]
                else:
                    cands = random.sample(self.replicas, 2)
                for rid, _h in cands:
                    self._purge_locked(rid)
                rid, h = min(
                    cands, key=lambda rh: len(self.inflight.get(rh[0], ()))
                )
                if len(self.inflight.get(rid, ())) < self.max_concurrent:
                    return rid, h
            if time.time() > deadline:
                raise TimeoutError(
                    "all replicas at max_concurrent_queries for 60s"
                )
            time.sleep(0.001)


class Router:
    """Per-process router over all deployments (ray: router.py Router).

    Membership arrives by PUSH: a background thread keeps one long-poll
    parked on the controller (ray: long_poll.py:185 LongPollClient), so a
    config/membership change reaches every router in push latency with
    zero per-request controller traffic."""

    def __init__(self, controller_handle, listen_chunk_s: float = 30.0):
        self._controller = controller_handle
        self._chunk = listen_chunk_s
        self._lock = threading.Lock()
        self._version = -1
        self._sets: Dict[str, _ReplicaSet] = {}
        self._stopped = False
        # Bootstrap table fetch is best-effort: a router built INSIDE a
        # replica's __init__ (graph ingress unpickling a child handle) must
        # not fail actor creation on a busy controller — the long-poll
        # listener below delivers the table moments later, and
        # assign_request force-pulls on a miss.
        try:
            self._refresh()
        except Exception:
            pass
        self._listen_thread = threading.Thread(
            target=self._listen_loop, daemon=True, name="serve-router-longpoll"
        )
        self._listen_thread.start()

    def _apply_table(self, out) -> None:
        if out is None:
            return
        with self._lock:
            if out["version"] <= self._version:
                return
            self._version = out["version"]
            live = set(out["table"].keys())
            for name, info in out["table"].items():
                rs = self._sets.get(name)
                if rs is None:
                    rs = self._sets[name] = _ReplicaSet(info["max_concurrent_queries"])
                rs.update(info["replicas"], info["max_concurrent_queries"])
            for name in list(self._sets.keys()):
                if name not in live:
                    del self._sets[name]

    def _refresh(self):
        out = ray_tpu_torch.get(
            self._controller.get_routing_table.remote(self._version), timeout=10
        )
        self._apply_table(out)

    def stop(self) -> None:
        """Stop the long-poll listener (serve.shutdown): without this the
        daemon thread would hot-retry a dead controller forever."""
        self._stopped = True

    def _listen_loop(self) -> None:
        while not self._stopped:
            try:
                out = ray_tpu_torch.get(
                    self._controller.listen_for_change.remote(
                        self._version, self._chunk
                    ),
                    timeout=self._chunk + 15,
                )
            except Exception:
                if self._stopped:
                    return
                time.sleep(0.5)  # controller restarting: retry
                continue
            self._apply_table(out)

    def assign_request(
        self, deployment: str, method_name: str, args: tuple, kwargs: dict,
        stream: bool = False, trace_parent=None,
    ):
        """Pick a replica and submit; returns the result ObjectRef (or a
        replica-sticky stream handle when stream=True).  Blocking
        backpressure happens on the replica set's OWN lock — the router
        lock is only held for map lookups, so the long-poll push can land
        while callers wait for capacity.

        trace_parent: the proxy's serve::request span context — the
        routing decision records as a child span, and the remote submit
        inside it stamps the spec's trace_ctx, so the replica's run span
        parents into the SAME request tree (one request id end to end)."""
        from ray_tpu_torch.util import tracing

        with self._lock:
            rs = self._sets.get(deployment)
        if rs is None or not rs.has_replicas():
            # Push may still be in flight for a just-deployed app: force
            # one pull before failing.
            self._refresh()
            with self._lock:
                rs = self._sets.get(deployment)
            if rs is None or not rs.has_replicas():
                raise RuntimeError(f"deployment {deployment!r} has no replicas")
        with tracing.span(
            "serve::route", parent=trace_parent,
            attrs={"deployment": deployment},
        ):
            rid, handle = rs.assign()
            if stream:
                token = _StreamToken()
                sid_ref = handle.stream_start.remote(method_name, args, kwargs)
                rs.record(rid, token)  # live stream counts as in-flight
                return _StreamIterator(handle, sid_ref, token=token)
            ref = handle.handle_request.remote(method_name, args, kwargs)
            rs.record(rid, ref)
            return ref


class _StreamIterator:
    """Client side of a streaming call (ray: DeploymentResponseGenerator).

    Pulls item batches from the REPLICA that owns the generator (sticky —
    a generator cannot move between replicas).  Lazy: each __next__ fetches
    the next ready chunk, so the consumer sees early items while the
    replica is still producing later ones (token streaming)."""

    def __init__(self, replica_handle, sid_ref, batch: int = 1, token=None):
        self._h = replica_handle
        self._sid_ref = sid_ref
        self._sid = None
        self._batch = batch
        self._buf: List[Any] = []
        self._done = False
        self._token = token

    def __iter__(self):
        return self

    def _finish(self) -> None:
        self._done = True
        if self._token is not None:
            self._token.done = True  # release the router's in-flight slot

    def __next__(self):
        while not self._buf:
            if self._done:
                raise StopIteration
            try:
                if self._sid is None:
                    # Inside the try: a failed stream_start (bad method,
                    # replica death) must release the router's in-flight
                    # token, or the failed stream occupies a routing slot
                    # forever.
                    self._sid = ray_tpu_torch.get(self._sid_ref, timeout=60)
                items, done = ray_tpu_torch.get(
                    self._h.stream_next.remote(self._sid, self._batch), timeout=300
                )
            except Exception:
                self._finish()
                raise
            if done:
                self._finish()
            self._buf.extend(items)
        return self._buf.pop(0)

    def close(self) -> None:
        """Abandon the stream: tell the replica to drop the generator so
        it stops counting against its queue and frees captured state."""
        if self._done:
            return
        self._finish()
        try:
            if self._sid is None:
                self._sid = ray_tpu_torch.get(self._sid_ref, timeout=10)
            self._h.stream_cancel.remote(self._sid)
        except Exception:
            pass  # replica already dead: nothing to cancel

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class DeploymentHandle:
    """User-facing handle (ray: serve/handle.py DeploymentHandle).

    `h.remote(*a)` calls the deployment's __call__; `h.method.remote(*a)`
    calls a named method.  Results are ObjectRefs: ray_tpu_torch.get() them, or
    `await` them inside async code (async handle API).
    `h.options(stream=True).remote(*a)` returns an iterator of the
    deployment generator's items (streaming responses)."""

    def __init__(
        self,
        deployment_name: str,
        router: Router,
        method_name: Optional[str] = None,
        stream: bool = False,
    ):
        self._name = deployment_name
        self._router = router
        self._method = method_name
        self._stream = stream

    def options(
        self, *, method_name: Optional[str] = None, stream: Optional[bool] = None
    ) -> "DeploymentHandle":
        return DeploymentHandle(
            self._name,
            self._router,
            method_name if method_name is not None else self._method,
            self._stream if stream is None else stream,
        )

    def remote(self, *args, **kwargs):
        return self._router.assign_request(
            self._name, self._method or "__call__", args, kwargs,
            stream=self._stream,
        )

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return DeploymentHandle(self._name, self._router, name, self._stream)

    def __reduce__(self):
        # Handles ship into OTHER processes (deployment-graph ingress
        # replicas hold child handles): rebuild there with a fresh Router
        # bound to the named controller — the local Router holds locks and
        # a live controller handle wrapper that don't pickle.
        return (_rebuild_handle, (self._name, self._method, self._stream))

    def __repr__(self):
        m = f".{self._method}" if self._method else ""
        return f"DeploymentHandle({self._name}{m})"


_process_router: Optional[Router] = None
_process_router_lock = threading.Lock()


def _rebuild_handle(
    name: str, method: Optional[str], stream: bool = False
) -> "DeploymentHandle":
    """ONE Router per process, shared by every unpickled handle: per-handle
    routers would each get their own in-flight accounting (N handles could
    push N x max_concurrent to one replica) and each poll the controller."""
    global _process_router
    with _process_router_lock:
        if _process_router is None:
            import ray_tpu_torch
            from ray_tpu_torch.serve.config import SERVE_CONTROLLER_NAME, SERVE_NAMESPACE

            controller = ray_tpu_torch.get_actor(SERVE_CONTROLLER_NAME, SERVE_NAMESPACE)
            _process_router = Router(controller)
    return DeploymentHandle(name, _process_router, method, stream)
