"""joblib backend: scikit-learn's `n_jobs=-1` parallelism on the cluster.

ray: python/ray/util/joblib/ — register_ray() + a joblib ParallelBackend
that turns every joblib batch (GridSearchCV fits, cross_val_score folds,
bagging members) into runtime tasks.  Usage:

    from ray_tpu_torch.util.joblib import register_ray
    register_ray()
    with joblib.parallel_backend("ray_tpu_torch"):
        GridSearchCV(...).fit(X, y)
"""

from __future__ import annotations

import threading
from typing import Any, Callable, List, Optional

import ray_tpu_torch
from joblib._parallel_backends import ParallelBackendBase


@ray_tpu_torch.remote
def _run_batch(payload):
    """The one exported trampoline: joblib hands zero-arg BatchedCalls
    callables; a module-level remote fn exports ONCE per session instead
    of re-pickling an identical closure per batch."""
    return payload()


class _Future:
    """concurrent.futures-shaped handle over an ObjectRef (what joblib's
    retrieve path expects back from submit)."""

    def __init__(self, ref):
        self.ref = ref
        self._done = threading.Event()
        self._result: List[Any] = []
        self._error: List[BaseException] = []

    def _complete(self) -> None:
        if not self._done.is_set():
            try:
                self._result.append(ray_tpu_torch.get(self.ref, timeout=0))
            except BaseException as e:  # noqa: BLE001 — joblib re-raises
                self._error.append(e)
            self._done.set()

    def result(self, timeout: Optional[float] = None):
        if not self._done.is_set():
            done, _ = ray_tpu_torch.wait([self.ref], num_returns=1, timeout=timeout)
            if not done:
                # NOT latched: the task may still finish — a later result()
                # must return the value, not replay a stale timeout.
                raise TimeoutError(
                    f"result not ready within {timeout}s"
                )  # concurrent.futures contract
            self._complete()
        if self._error:
            raise self._error[0]
        return self._result[0]

    get = result  # legacy AsyncResult surface


class RayTpuBackend(ParallelBackendBase):
    """joblib backend over the task runtime.

    Implements the MODERN submit/retrieve_result_callback contract
    (apply_async is deprecated in joblib 1.5): a single watcher thread
    waits on outstanding refs and fires joblib's completion callbacks as
    tasks ACTUALLY finish, so dispatch of later batches never stalls
    behind an in-order straggler.
    """

    supports_retrieve_callback = True
    supports_inner_max_num_threads = False
    uses_threads = False
    supports_sharedmem = False

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._lock = threading.Lock()
        self._watching: dict = {}  # ref -> (_Future, callback)
        self._wake = threading.Event()
        self._watcher: Optional[threading.Thread] = None
        self._stopped = False

    # -- lifecycle --------------------------------------------------------
    def configure(self, n_jobs: int = 1, parallel=None, **_kw) -> int:
        ray_tpu_torch.init(ignore_reinit_error=True)
        self.parallel = parallel
        self._n_jobs = self.effective_n_jobs(n_jobs)
        return self._n_jobs

    def effective_n_jobs(self, n_jobs: int) -> int:
        if n_jobs == 0:
            raise ValueError("n_jobs == 0 has no meaning")
        ray_tpu_torch.init(ignore_reinit_error=True)
        total = int(ray_tpu_torch.cluster_resources().get("CPU", 1))
        if n_jobs is None:
            return total
        if n_jobs < 0:
            # joblib convention: -1 = all, -2 = all but one, ...
            return max(1, total + 1 + n_jobs)
        return min(n_jobs, total)

    # -- submission -------------------------------------------------------
    def submit(self, func: Callable[[], Any], callback=None):
        ref = _run_batch.remote(func)
        fut = _Future(ref)
        # A terminated backend can be reused (joblib documents reusing a
        # Parallel object): retire any stopping watcher FIRST — outside the
        # lock, since the watcher takes it per iteration and a locked join
        # would deadlock — then register under a fresh one.
        with self._lock:
            old = self._watcher
            need_restart = (
                self._stopped or old is None or not old.is_alive()
            )
        if need_restart:
            if old is not None and old.is_alive():
                self._stopped = True
                self._wake.set()
            if old is not None:
                old.join(timeout=5)
            with self._lock:
                if self._stopped or self._watcher is None or not self._watcher.is_alive():
                    self._stopped = False
                    self._watcher = threading.Thread(
                        target=self._watch_loop, daemon=True, name="joblib-raytpu"
                    )
                    self._watcher.start()
        with self._lock:
            self._watching[ref] = (fut, callback)
        self._wake.set()
        return fut

    def retrieve_result_callback(self, future: _Future):
        return future.result()

    def _watch_loop(self) -> None:
        while not self._stopped:
            with self._lock:
                refs = list(self._watching)
            if not refs:
                self._wake.wait(timeout=0.5)
                self._wake.clear()
                continue
            try:
                done, _ = ray_tpu_torch.wait(refs, num_returns=1, timeout=0.2)
            except Exception as e:  # runtime shut down mid-Parallel
                # Fail every outstanding future so joblib surfaces the
                # error instead of hanging on callbacks that never fire.
                with self._lock:
                    entries = list(self._watching.values())
                    self._watching.clear()
                for fut, callback in entries:
                    fut._error.append(e)
                    fut._done.set()
                    if callback is not None:
                        try:
                            callback(fut)
                        except Exception:
                            pass
                return
            for ref in done:
                with self._lock:
                    entry = self._watching.pop(ref, None)
                if entry is None:
                    continue
                fut, callback = entry
                fut._complete()
                if callback is not None:
                    try:
                        callback(fut)
                    except Exception:
                        pass  # joblib's callback errors are its own affair

    def abort_everything(self, ensure_ready: bool = True) -> None:
        # A failed fold aborts the Parallel call: cancel what's still
        # running so the cluster doesn't burn CPU on doomed batches.
        with self._lock:
            pending = list(self._watching)
            self._watching.clear()
        for ref in pending:
            try:
                ray_tpu_torch.cancel(ref)
            except Exception:
                pass
        if ensure_ready:
            self.configure(n_jobs=self._n_jobs, parallel=self.parallel)

    def terminate(self) -> None:
        self._stopped = True
        self._wake.set()


def register_ray() -> None:
    """Register the 'ray_tpu_torch' joblib backend (ray: util/joblib register_ray)."""
    from joblib import register_parallel_backend

    register_parallel_backend("ray_tpu_torch", RayTpuBackend)
