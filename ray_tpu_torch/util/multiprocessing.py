"""multiprocessing.Pool API over the task runtime.

ray: python/ray/util/multiprocessing/pool.py — the drop-in Pool that turns
`pool.map(f, xs)` into cluster tasks.  Re-built on this runtime's task
surface: each submission is one @remote task (the scheduler does the
load-balancing the reference's per-actor round-robin does by hand), and
laziness/chunking match the stdlib contract.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Iterable, List, Optional

import ray_tpu_torch


class AsyncResult:
    """stdlib-shaped handle over object refs."""

    def __init__(self, refs: List[Any], single: bool, chunked: bool = False):
        self._refs = refs
        self._single = single
        self._chunked = chunked

    def get(self, timeout: Optional[float] = None):
        out = ray_tpu_torch.get(self._refs, timeout=timeout)
        if self._chunked:
            out = [x for chunk in out for x in chunk]
        return out[0] if self._single else out

    def wait(self, timeout: Optional[float] = None) -> None:
        ray_tpu_torch.wait(self._refs, num_returns=len(self._refs), timeout=timeout)

    def ready(self) -> bool:
        done, _ = ray_tpu_torch.wait(
            self._refs, num_returns=len(self._refs), timeout=0
        )
        return len(done) == len(self._refs)

    def successful(self) -> bool:
        if not self.ready():
            raise ValueError("result is not ready")
        try:
            ray_tpu_torch.get(self._refs, timeout=0)
            return True
        except Exception:
            return False


class Pool:
    """Drop-in for multiprocessing.Pool (the reference's util.multiprocessing).

    processes bounds in-flight tasks (backpressure), not worker count —
    the runtime's worker pool is shared cluster-wide.
    """

    def __init__(self, processes: Optional[int] = None, **_compat):
        ray_tpu_torch.init(ignore_reinit_error=True)
        self._max_inflight = processes or 0
        self._closed = False

    # -- helpers ----------------------------------------------------------
    def _task(self, func: Callable):
        return ray_tpu_torch.remote(func)

    def _chunks(self, it: Iterable, size: int):
        it = iter(it)
        while True:
            chunk = list(itertools.islice(it, size))
            if not chunk:
                return
            yield chunk

    def _submit_all(self, task, chunks: List[list]) -> List[Any]:
        refs = []
        for chunk in chunks:
            if self._max_inflight and len(refs) >= self._max_inflight:
                # Backpressure: wait for ONE in-flight chunk before the next
                # submit, bounding cluster memory like a real pool bounds
                # concurrency.
                ray_tpu_torch.wait(refs, num_returns=len(refs) - self._max_inflight + 1)
            refs.append(task.remote(chunk))
        return refs

    def _check_open(self):
        if self._closed:
            raise ValueError("Pool not running")

    # -- stdlib surface ---------------------------------------------------
    def apply(self, func, args=(), kwds=None):
        return self.apply_async(func, args, kwds).get()

    def apply_async(self, func, args=(), kwds=None):
        self._check_open()
        ref = self._task(func).remote(*args, **(kwds or {}))
        return AsyncResult([ref], single=True)

    def map(self, func, iterable, chunksize: Optional[int] = None):
        return self.map_async(func, iterable, chunksize).get()

    def map_async(self, func, iterable, chunksize: Optional[int] = None):
        self._check_open()
        items = list(iterable)
        size = chunksize or max(1, len(items) // 64 or 1)

        def run_chunk(chunk):
            return [func(x) for x in chunk]

        refs = self._submit_all(self._task(run_chunk), list(self._chunks(items, size)))
        return AsyncResult(refs, single=False, chunked=True)

    def starmap(self, func, iterable, chunksize: Optional[int] = None):
        return self.map(lambda args: func(*args), iterable, chunksize)

    def _chunk_task(self, func: Callable):
        def run_chunk(chunk):
            return [func(x) for x in chunk]

        return self._task(run_chunk)

    def imap(self, func, iterable, chunksize: Optional[int] = None):
        """Lazy iterator in ORDER; at most `processes` chunks in flight
        and the input consumed lazily (the class's backpressure contract —
        a huge iterable never floods the cluster)."""
        self._check_open()  # at CALL time, like the stdlib
        task = self._chunk_task(func)
        window = self._max_inflight or 64

        def gen():
            from collections import deque

            refs = deque()
            for chunk in self._chunks(iterable, chunksize or 1):
                refs.append(task.remote(chunk))
                if len(refs) >= window:
                    # Ordered: drain the HEAD, blocking until it's done.
                    yield from ray_tpu_torch.get(refs.popleft())
            while refs:
                yield from ray_tpu_torch.get(refs.popleft())

        return gen()

    def imap_unordered(self, func, iterable, chunksize: Optional[int] = None):
        """Lazy iterator in COMPLETION order; same in-flight window."""
        self._check_open()
        task = self._chunk_task(func)
        window = self._max_inflight or 64

        def gen():
            pending: List[Any] = []
            for chunk in self._chunks(iterable, chunksize or 1):
                pending.append(task.remote(chunk))
                if len(pending) >= window:
                    done, pending[:] = ray_tpu_torch.wait(pending, num_returns=1)
                    for r in done:
                        yield from ray_tpu_torch.get(r)
            while pending:
                done, pending[:] = ray_tpu_torch.wait(pending, num_returns=1)
                for r in done:
                    yield from ray_tpu_torch.get(r)

        return gen()

    def close(self) -> None:
        self._closed = True

    def terminate(self) -> None:
        self._closed = True

    def join(self) -> None:
        if not self._closed:
            raise ValueError("Pool is still running")

    def __enter__(self) -> "Pool":
        return self

    def __exit__(self, *exc) -> None:
        self.terminate()
