"""Job submission: run driver scripts as supervised subprocesses.

ray: dashboard/modules/job/ (JobSubmissionClient at sdk.py:40, job manager/
supervisor).  v0 scope: jobs run on the submitting machine as independent
driver processes (each job creates its own ray_tpu_torch runtime), with captured
logs, status tracking, env_vars runtime env, and stop.  The surface
(submit/status/logs/list/stop/wait) matches the reference so cluster-level
execution can slot in behind it later.
"""

from __future__ import annotations

import os
import subprocess
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

PENDING = "PENDING"
RUNNING = "RUNNING"
SUCCEEDED = "SUCCEEDED"
FAILED = "FAILED"
STOPPED = "STOPPED"

_TERMINAL = (SUCCEEDED, FAILED, STOPPED)


@dataclass
class JobInfo:
    job_id: str
    entrypoint: str
    status: str = PENDING
    submission_time: float = field(default_factory=time.time)
    start_time: Optional[float] = None
    end_time: Optional[float] = None
    return_code: Optional[int] = None
    log_path: str = ""
    metadata: Dict[str, Any] = field(default_factory=dict)


class JobSubmissionClient:
    """ray: JobSubmissionClient (dashboard/modules/job/sdk.py:40)."""

    def __init__(self, log_dir: Optional[str] = None):
        import tempfile

        self._log_dir = log_dir or os.path.join(
            tempfile.gettempdir(), f"raytpu-jobs-{os.getpid()}"
        )
        os.makedirs(self._log_dir, exist_ok=True)
        self._jobs: Dict[str, JobInfo] = {}
        self._procs: Dict[str, subprocess.Popen] = {}
        self._lock = threading.Lock()

    def submit_job(
        self,
        *,
        entrypoint: str,
        runtime_env: Optional[Dict[str, Any]] = None,
        metadata: Optional[Dict[str, Any]] = None,
        submission_id: Optional[str] = None,
    ) -> str:
        job_id = submission_id or f"raytpu-job-{uuid.uuid4().hex[:12]}"
        renv = runtime_env or {}
        pip_path = None
        if renv:
            from ray_tpu_torch._private.runtime_env import (
                pip_env_dir,
                validate_runtime_env,
            )

            # Same submit-time contract as tasks/actors: typos and
            # conda/container fail fast with guidance, never silently drop.
            # Raises happen BEFORE the job registers — a rejected
            # submission must not leave a ghost PENDING entry (and the
            # submission_id stays reusable for the corrected retry).
            validate_runtime_env(renv)
            if renv.get("pip"):
                # Jobs run on this host: build/reuse the content-hashed
                # pip env and put it on the entrypoint's PYTHONPATH.
                pip_path = pip_env_dir([str(s) for s in renv["pip"]])
        with self._lock:
            if job_id in self._jobs:
                raise ValueError(f"job {job_id!r} already exists")
            info = JobInfo(
                job_id=job_id,
                entrypoint=entrypoint,
                log_path=os.path.join(self._log_dir, f"{job_id}.log"),
                metadata=dict(metadata or {}),
            )
            self._jobs[job_id] = info
        env = os.environ.copy()
        env.update({k: str(v) for k, v in (renv.get("env_vars") or {}).items()})
        cwd = renv.get("working_dir") or os.getcwd()
        paths = ([pip_path] if pip_path else []) + [
            p for p in (renv.get("py_modules") or [])
        ] + [cwd]
        if env.get("PYTHONPATH"):
            paths.append(env["PYTHONPATH"])
        env["PYTHONPATH"] = os.pathsep.join(paths)
        log_f = open(info.log_path, "wb")
        try:
            proc = subprocess.Popen(
                entrypoint,
                shell=True,
                cwd=cwd,
                env=env,
                stdout=log_f,
                stderr=subprocess.STDOUT,
                start_new_session=True,  # stop_job kills the whole group
            )
        except Exception as e:
            # No ghost PENDING jobs: record the spawn failure durably.
            log_f.write(f"job spawn failed: {e!r}\n".encode())
            log_f.close()
            with self._lock:
                info.status = FAILED
                info.end_time = time.time()
            raise
        log_f.close()
        stop_now = False
        with self._lock:
            if info.status == PENDING:
                info.status = RUNNING
                info.start_time = time.time()
            else:
                stop_now = True  # stop_job() won the race pre-Popen
            self._procs[job_id] = proc
        if stop_now:
            try:
                proc.terminate()
            except OSError:
                pass
        threading.Thread(
            target=self._supervise, args=(job_id, proc), daemon=True
        ).start()
        return job_id

    def _supervise(self, job_id: str, proc: subprocess.Popen) -> None:
        rc = proc.wait()
        with self._lock:
            info = self._jobs[job_id]
            info.end_time = time.time()
            info.return_code = rc
            if info.status != STOPPED:
                info.status = SUCCEEDED if rc == 0 else FAILED

    def get_job_status(self, job_id: str) -> str:
        with self._lock:
            return self._jobs[job_id].status

    def get_job_info(self, job_id: str) -> JobInfo:
        import copy

        with self._lock:
            return copy.copy(self._jobs[job_id])  # snapshot, not live state

    def get_job_logs(self, job_id: str) -> str:
        info = self.get_job_info(job_id)
        try:
            with open(info.log_path, "r", errors="replace") as f:
                return f.read()
        except FileNotFoundError:
            return ""

    def list_jobs(self) -> List[JobInfo]:
        import copy

        with self._lock:
            return [copy.copy(j) for j in self._jobs.values()]

    def stop_job(self, job_id: str) -> bool:
        import signal

        with self._lock:
            info = self._jobs.get(job_id)
            proc = self._procs.get(job_id)
            if info is None or info.status in _TERMINAL:
                return False
            info.status = STOPPED
        if proc is not None and proc.poll() is None:
            try:
                os.killpg(os.getpgid(proc.pid), signal.SIGTERM)
            except ProcessLookupError:
                pass
            try:
                proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                try:
                    os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
                except ProcessLookupError:
                    pass
        return True

    def wait_until_finish(self, job_id: str, timeout: float = 300.0) -> str:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            status = self.get_job_status(job_id)
            if status in _TERMINAL:
                return status
            time.sleep(0.1)
        raise TimeoutError(f"job {job_id} still {self.get_job_status(job_id)}")
