"""ray_tpu_torch.workflow — durable workflows: DAGs with persisted step results.

ray: python/ray/workflow/ (api.py:120 run, :232 resume, :297 get_output;
workflow_storage.py; workflow_state_from_storage.py).  Every step's result
is written to storage before the workflow advances; resume() replays the
DAG, skipping steps whose results are already durable — so a crashed
driver (or machine) continues where it left off instead of recomputing.

Storage is a filesystem directory (workflow_dir/<workflow_id>/<step>.pkl
+ status files); steps are content-addressed by their position in the DAG.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import tempfile
import time
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.dag import DAGNode

RUNNING = "RUNNING"
SUCCEEDED = "SUCCEEDED"
FAILED = "FAILED"

_storage_dir: Optional[str] = None


def init(storage: Optional[str] = None) -> None:
    """Set the durable storage root (default: $TMPDIR/ray_tpu_workflows).

    Steps persist their results INTO this directory from the workers that
    run them, so on a multi-node cluster it must be a filesystem every node
    can write (NFS / GCS-fuse / Filestore) — the same shared-storage
    contract the reference imposes (ray: workflow requires a storage URL
    reachable from all nodes).  The single-host default is only durable
    against driver restarts on that host."""
    global _storage_dir
    _storage_dir = storage or os.path.join(
        tempfile.gettempdir(), "ray_tpu_workflows"
    )
    os.makedirs(_storage_dir, exist_ok=True)


def _storage() -> str:
    if _storage_dir is None:
        init()
    return _storage_dir


def _wf_dir(workflow_id: str) -> str:
    return os.path.join(_storage(), workflow_id)


def _step_key(node: DAGNode, order: List[DAGNode]) -> str:
    """Stable step id: function name + position among same-named steps in
    topological order (deterministic across replays of the same DAG)."""
    idx = sum(
        1
        for other in order[: order.index(node)]
        if other._fn.__name__ == node._fn.__name__
    )
    return f"{node._fn.__name__}-{idx}"


def _atomic_write(path: str, data: bytes) -> None:
    tmp = path + f".tmp-{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


@ray_tpu_torch.remote
def _run_step(wf_dir: str, key: str, fn_blob: bytes, args, kwargs):
    """Execute one step remotely, persisting the result BEFORE returning —
    the durability point (ray: workflow_storage commit-before-advance)."""
    import cloudpickle

    fn = cloudpickle.loads(fn_blob)

    # Upstream step results arrive as refs nested anywhere in the args
    # (only top-level task args auto-resolve): fetch them worker-side,
    # descending containers the same way the DAG substitution does.
    def resolve(value):
        if isinstance(value, ray_tpu_torch.ObjectRef):
            return ray_tpu_torch.get(value)
        if isinstance(value, list):
            return [resolve(v) for v in value]
        if isinstance(value, tuple):
            return tuple(resolve(v) for v in value)
        if isinstance(value, set):
            return {resolve(v) for v in value}
        if isinstance(value, dict):
            return {k: resolve(v) for k, v in value.items()}
        return value

    args = [resolve(a) for a in args]
    kwargs = {k: resolve(v) for k, v in kwargs.items()}
    out = fn(*args, **kwargs)
    _atomic_write(os.path.join(wf_dir, f"{key}.pkl"), pickle.dumps(out))
    return out


def run(
    dag: DAGNode,
    *,
    workflow_id: Optional[str] = None,
) -> Any:
    """Run a DAG durably; returns the final result (ray: workflow.run)."""
    return ray_tpu_torch.get(run_async(dag, workflow_id=workflow_id), timeout=None)


def run_async(dag: DAGNode, *, workflow_id: Optional[str] = None):
    """Submit a durable DAG; returns the final step's ObjectRef."""
    import cloudpickle
    import uuid

    workflow_id = workflow_id or f"wf-{uuid.uuid4().hex[:10]}"
    wf_dir = _wf_dir(workflow_id)
    os.makedirs(wf_dir, exist_ok=True)
    # Persist the DAG itself so resume() can replay it without user code.
    _atomic_write(os.path.join(wf_dir, "dag.pkl"), cloudpickle.dumps(dag))
    _atomic_write(os.path.join(wf_dir, "status"), RUNNING.encode())

    ref = _submit_dag(workflow_id, dag)

    # Completion marker: a tiny chained step flips status when the root
    # result lands (no driver thread needed; survives via resume if not).
    @ray_tpu_torch.remote
    def _finalize(result, wf_dir=wf_dir):
        _atomic_write(os.path.join(wf_dir, "status"), SUCCEEDED.encode())
        return result

    out = _finalize.remote(ref)

    # A failed step never reaches _finalize (dep-error propagation), so a
    # watcher flips the durable status to FAILED when the root ref errors.
    import threading

    def _watch():
        try:
            ray_tpu_torch.get(out, timeout=None)
        except Exception:
            try:
                _atomic_write(os.path.join(wf_dir, "status"), FAILED.encode())
            except OSError:
                pass

    threading.Thread(target=_watch, daemon=True, name="wf-watch").start()
    return out


def _submit_dag(workflow_id: str, dag: DAGNode):
    import cloudpickle

    wf_dir = _wf_dir(workflow_id)
    order = dag.topological_order()
    results: Dict[int, Any] = {}
    for node in order:
        key = _step_key(node, order)
        done_path = os.path.join(wf_dir, f"{key}.pkl")
        if os.path.exists(done_path):
            # Durable result exists: skip re-execution (resume semantics).
            with open(done_path, "rb") as f:
                results[id(node)] = ray_tpu_torch.put(pickle.load(f))
            continue
        def subst(value):
            if isinstance(value, DAGNode):
                return results[id(value)]
            if isinstance(value, list):
                return [subst(v) for v in value]
            if isinstance(value, tuple):
                return tuple(subst(v) for v in value)
            if isinstance(value, set):
                return {subst(v) for v in value}
            if isinstance(value, dict):
                return {k: subst(v) for k, v in value.items()}
            return value

        args = [subst(a) for a in node._args]
        kwargs = {k: subst(v) for k, v in node._kwargs.items()}
        fn_blob = cloudpickle.dumps(node._fn._fn)
        results[id(node)] = _run_step.options(
            name=f"wf:{workflow_id}:{key}"
        ).remote(wf_dir, key, fn_blob, args, kwargs)
    return results[id(dag)]


def resume(workflow_id: str) -> Any:
    """Resume after a crash: completed steps load from storage, the rest
    re-execute (ray: workflow.resume :232)."""
    import cloudpickle

    wf_dir = _wf_dir(workflow_id)
    with open(os.path.join(wf_dir, "dag.pkl"), "rb") as f:
        dag = cloudpickle.load(f)
    ref = _submit_dag(workflow_id, dag)
    try:
        out = ray_tpu_torch.get(ref, timeout=None)
    except Exception:
        _atomic_write(os.path.join(wf_dir, "status"), FAILED.encode())
        raise
    _atomic_write(os.path.join(wf_dir, "status"), SUCCEEDED.encode())
    return out


def get_status(workflow_id: str) -> str:
    try:
        with open(os.path.join(_wf_dir(workflow_id), "status"), "rb") as f:
            return f.read().decode()
    except FileNotFoundError:
        raise ValueError(f"no workflow {workflow_id!r}")


def get_output(workflow_id: str) -> Any:
    """Final result of a SUCCEEDED workflow (from durable storage)."""
    if get_status(workflow_id) != SUCCEEDED:
        raise ValueError(f"workflow {workflow_id} is {get_status(workflow_id)}")
    return resume(workflow_id)  # all steps durable: pure storage replay


def list_all() -> List[Dict[str, str]]:
    root = _storage()
    out = []
    for wid in sorted(os.listdir(root)):
        try:
            out.append({"workflow_id": wid, "status": get_status(wid)})
        except ValueError:
            continue
    return out


def delete(workflow_id: str) -> None:
    import shutil

    shutil.rmtree(_wf_dir(workflow_id), ignore_errors=True)
