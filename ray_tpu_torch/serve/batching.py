"""@serve.batch — transparent request batching inside a replica.

ray: python/ray/serve/batching.py (the `@serve.batch` decorator).  The
reference's batcher is asyncio-based; replicas here execute requests on a
thread pool (one slot per concurrent query), so the batcher is thread-based:
the first caller into an empty batch becomes the leader, waits up to
batch_wait_timeout_s for the batch to fill to max_batch_size, runs the
wrapped function ONCE on the list of items, and distributes results.

This is the TPU serving hot path: batched JAX inference amortizes dispatch
and keeps the MXU fed with large matmuls instead of batch-1 GEMVs.
"""

from __future__ import annotations

import functools
import inspect
import threading
from typing import Any, Callable, List, Optional


class _Slot:
    __slots__ = ("item", "event", "result", "error")

    def __init__(self, item):
        self.item = item
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None


class _Batcher:
    def __init__(self, fn: Callable, max_batch_size: int, batch_wait_timeout_s: float):
        self._fn = fn
        self._max = max_batch_size
        self._timeout = batch_wait_timeout_s
        self._lock = threading.Lock()
        self._pending: List[_Slot] = []
        self._leader_active = False

    def submit(self, instance, item) -> Any:
        slot = _Slot(item)
        lead = False
        with self._lock:
            self._pending.append(slot)
            if not self._leader_active:
                self._leader_active = True
                lead = True
        if lead:
            self._run_leader(instance)
        # Leader completes its own slot synchronously; followers wait here.
        slot.event.wait()
        if slot.error is not None:
            raise slot.error
        return slot.result

    def _run_leader(self, instance):
        deadline = threading.Event()
        # Wait for the batch to fill or the window to expire.  Polling in
        # small slices keeps the window tight without a condition variable
        # per slot (the window is ~ms; precision beyond that doesn't matter).
        waited = 0.0
        step = min(0.002, self._timeout) if self._timeout > 0 else 0.0
        while waited < self._timeout:
            with self._lock:
                if len(self._pending) >= self._max:
                    break
            deadline.wait(step)
            waited += step
        with self._lock:
            batch, self._pending = self._pending[: self._max], self._pending[self._max :]
            # Hand leadership to the next waiter if items remain; they're
            # already blocked in submit() so a new leader must be crowned
            # here, not there.
            self._leader_active = bool(self._pending)
            relead = self._pending[0] if self._leader_active else None
        if relead is not None:
            threading.Thread(
                target=self._run_leader, args=(instance,), daemon=True
            ).start()
        items = [s.item for s in batch]
        try:
            out = self._fn(instance, items) if instance is not None else self._fn(items)
            if inspect.iscoroutine(out):
                import asyncio

                out = asyncio.run(out)
            if not isinstance(out, (list, tuple)) or len(out) != len(items):
                raise TypeError(
                    f"@serve.batch function must return a list of "
                    f"{len(items)} results (one per item), got {type(out)}"
                )
            for s, r in zip(batch, out):
                s.result = r
        except BaseException as e:  # noqa: BLE001 — every waiter must wake
            for s in batch:
                s.error = e
        finally:
            for s in batch:
                s.event.set()


def batch(
    _fn: Optional[Callable] = None,
    *,
    max_batch_size: int = 8,
    batch_wait_timeout_s: float = 0.01,
):
    """Decorate a method taking a LIST of items and returning a LIST of
    results; callers invoke it with a SINGLE item and get a single result.

    ray: python/ray/serve/batching.py `@serve.batch`.
    """

    def deco(fn: Callable):
        batcher_attr = f"__serve_batcher_{fn.__name__}"

        @functools.wraps(fn)
        def wrapper(self, item):
            b = getattr(self, batcher_attr, None)
            if b is None:
                # Two concurrent first calls must share ONE batcher, or the
                # first batch window splits in half.  dict.setdefault is
                # atomic under the GIL — no lock (a closed-over Lock would
                # make decorated classes unpicklable for replica shipping);
                # the losing thread's _Batcher is garbage-collected unused.
                b = self.__dict__.setdefault(
                    batcher_attr, _Batcher(fn, max_batch_size, batch_wait_timeout_s)
                )
            return b.submit(self, item)

        wrapper._serve_batch_params = {
            "max_batch_size": max_batch_size,
            "batch_wait_timeout_s": batch_wait_timeout_s,
        }
        return wrapper

    if _fn is not None:
        return deco(_fn)
    return deco
