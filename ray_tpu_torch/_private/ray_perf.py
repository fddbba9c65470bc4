"""Core-runtime microbenchmarks (ray: python/ray/_private/ray_perf.py:93).

Same workload shapes as the reference's `ray microbenchmark` so the numbers
in BENCH_core_r*.json are comparable with BASELINE.md's table:

  single_client_tasks_sync      submit f.remote(); get() one at a time
  single_client_tasks_async     submit a window of tasks, get in batches
  multi_client_tasks_async      N driver threads submitting concurrently
  1_1_actor_calls_sync          one handle, call+get sequentially
  1_1_actor_calls_async         one handle, windowed submission
  n_n_actor_calls_async         N handles, N submitting threads
  single_client_put_ops         small ray_tpu_torch.put() throughput
  single_client_put_gigabytes   1GB of 100MB puts + gets (zero-copy path)

Run: `python -m ray_tpu_torch._private.ray_perf [--json out.json]`
"""

from __future__ import annotations

import json
import sys
import time
from typing import Callable, Dict, List

import ray_tpu_torch


def timeit(name: str, fn: Callable[[], int], warmup: int = 1, repeat: int = 3):
    """Run fn (returns ops count) repeat times; report the MEDIAN ops/s as
    the headline (all runs listed).  Best-of-N on a shared host with ±35%
    variance reports the luckiest scheduling window, which both masks and
    fakes real regressions/wins — the median is the honest number.

    Also reports this process's physical control-plane writes per op
    (wire.stats delta over the timed runs): the deterministic coalescing
    metric that doesn't care about host noise.  With the GCS mutation
    journal active (RAY_TPU_PERF_PERSIST=1), journal appends and fsyncs
    per op ride along the same way — the durability-cost twin of
    writes_per_op."""
    import statistics

    from ray_tpu_torch._private import wire as _wire

    def _journal_counts():
        try:
            from ray_tpu_torch._private.runtime import get_runtime

            rt = get_runtime()
            j = getattr(rt, "_journal", None)
            if j is None:
                return None
            # Flush so the physical-write count reflects the timed work
            # (a pending group-commit batch would undercount).
            j.flush()
            return (j.writes, j.fsyncs, j.entries)
        except Exception:
            return None

    for _ in range(warmup):
        fn()
    runs: List[float] = []
    w0 = _wire.stats()
    j0 = _journal_counts()
    total_ops = 0
    for _ in range(repeat):
        t0 = time.perf_counter()
        ops = fn()
        dt = time.perf_counter() - t0
        runs.append(round(ops / dt, 1))
        total_ops += ops
    w1 = _wire.stats()
    j1 = _journal_counts()
    out = {
        "name": name,
        "ops_per_s": round(statistics.median(runs), 1),
        "runs": runs,
    }
    if total_ops:
        out["writes_per_op"] = round(
            (w1["physical_writes"] - w0["physical_writes"]) / total_ops, 3
        )
        out["frames_per_op"] = round(
            (w1["logical_frames"] - w0["logical_frames"]) / total_ops, 3
        )
        # Codec split (this process): pickle bodies per op is the
        # native-codec acceptance counter — deterministic, unlike ops/s.
        out["pickle_codecs_per_op"] = round(
            (
                w1["pickle_encodes"] + w1["pickle_decodes"]
                - w0["pickle_encodes"] - w0["pickle_decodes"]
            ) / total_ops, 3
        )
        if j0 is not None and j1 is not None:
            # journal_appends = PHYSICAL writes (group-committed);
            # journal_entries = logical mutations.  Their ratio is the
            # group-commit factor.
            out["journal_appends_per_op"] = round((j1[0] - j0[0]) / total_ops, 3)
            out["journal_fsyncs_per_op"] = round((j1[1] - j0[1]) / total_ops, 3)
            out["journal_entries_per_op"] = round((j1[2] - j0[2]) / total_ops, 3)
    return out


def host_shape() -> Dict:
    """Self-describing host header for every BENCH json: cpu count, load
    average at the run, and the cgroup cpu quota when one applies — a
    1-vCPU artifact must SAY it is one (BENCH_shard_r1's honesty note,
    promoted into the data)."""
    import os as _os

    shape: Dict = {"nproc": _os.cpu_count()}
    try:
        shape["loadavg_1m"], shape["loadavg_5m"], shape["loadavg_15m"] = (
            round(x, 2) for x in _os.getloadavg()
        )
    except OSError:
        pass
    # cgroup v2 then v1: quota/period -> effective cores; "max" = no cap.
    try:
        with open("/sys/fs/cgroup/cpu.max") as f:
            quota, period = f.read().split()
            if quota != "max":
                shape["cgroup_cpus"] = round(int(quota) / int(period), 2)
            else:
                shape["cgroup_cpus"] = None
    except OSError:
        try:
            with open("/sys/fs/cgroup/cpu/cpu.cfs_quota_us") as f:
                quota = int(f.read())
            with open("/sys/fs/cgroup/cpu/cpu.cfs_period_us") as f:
                period = int(f.read())
            shape["cgroup_cpus"] = (
                round(quota / period, 2) if quota > 0 else None
            )
        except OSError:
            pass
    return shape


def _enable_local_persistence() -> None:
    """RAY_TPU_PERF_PERSIST=1: run the benches with the snapshot loop AND
    the mutation journal active on the local runtime, exactly as a
    standalone head runs them — so journal_appends_per_op /
    journal_fsyncs_per_op measure the real durability tax on the hot
    path (the honesty requirement: BENCH_core medians must stay within
    noise of the journal-less tree)."""
    import os as _os
    import threading as _threading

    from ray_tpu_torch._private import config as _config
    from ray_tpu_torch._private.gcs_storage import (
        make_mutation_journal,
        make_snapshot_storage,
    )
    from ray_tpu_torch._private.runtime import get_runtime

    rt = get_runtime()
    if rt._snapshot_storage is not None:
        return  # already persistent (attached to a real head)
    d = f"/tmp/raytpu-perf-{_os.getpid()}"
    _os.makedirs(d, exist_ok=True)
    path = _os.path.join(d, "gcs_snapshot.pkl")
    rt.snapshot_path = path
    rt._snapshot_storage = make_snapshot_storage(path)
    rt._journal = make_mutation_journal(path, rt.session_name)
    rt._journal_compact_bytes = _config.get("gcs_journal_compact_bytes")
    rt.state.journal_hook = rt._journal_append
    _threading.Thread(
        target=rt._snapshot_loop, daemon=True, name="raytpu-snapshot"
    ).start()


@ray_tpu_torch.remote
def _noop(*args):
    return None


@ray_tpu_torch.remote
class _Actor:
    def noop(self, *args):
        return None


def bench_tasks_sync(n: int = 300) -> Dict:
    def run():
        for _ in range(n):
            ray_tpu_torch.get(_noop.remote(), timeout=60)
        return n

    return timeit("single_client_tasks_sync", run)


def bench_tasks_async(n: int = 2000, window: int = 100) -> Dict:
    def run():
        refs: List = []
        for _ in range(n):
            refs.append(_noop.remote())
            if len(refs) >= window:
                ray_tpu_torch.get(refs, timeout=120)
                refs = []
        if refs:
            ray_tpu_torch.get(refs, timeout=120)
        return n

    return timeit("single_client_tasks_async", run)


def bench_multi_client_tasks_async(n_clients: int = 4, n_per: int = 1000) -> Dict:
    """N worker-process clients each fanning out plain tasks (the
    reference's multi-client shape — its clients are worker-side too, so
    each rides its own transport: here, head-granted leases + direct push
    instead of a per-task head request)."""
    clients = [_Client.remote() for _ in range(n_clients)]
    ray_tpu_torch.get([c.run_tasks.remote(1, 1) for c in clients], timeout=60)

    def run():
        done = ray_tpu_torch.get(
            [c.run_tasks.remote(n_per, 100) for c in clients], timeout=300
        )
        return sum(done)

    out = timeit("multi_client_tasks_async", run)
    for c in clients:
        ray_tpu_torch.kill(c)
    return out


def bench_actor_calls_sync(n: int = 500) -> Dict:
    a = _Actor.remote()
    ray_tpu_torch.get(a.noop.remote(), timeout=60)

    def run():
        for _ in range(n):
            ray_tpu_torch.get(a.noop.remote(), timeout=60)
        return n

    out = timeit("1_1_actor_calls_sync", run)
    ray_tpu_torch.kill(a)
    return out


def bench_actor_calls_async(n: int = 3000, window: int = 200) -> Dict:
    a = _Actor.remote()
    ray_tpu_torch.get(a.noop.remote(), timeout=60)

    def run():
        refs = []
        for _ in range(n):
            refs.append(a.noop.remote())
            if len(refs) >= window:
                ray_tpu_torch.get(refs, timeout=120)
                refs = []
        if refs:
            ray_tpu_torch.get(refs, timeout=120)
        return n

    out = timeit("1_1_actor_calls_async", run)
    ray_tpu_torch.kill(a)
    return out


@ray_tpu_torch.remote(num_cpus=0.05)
class _Client:
    """Driving client hosted in a worker process — the reference's
    multi-client microbenchmarks also fan out from worker-side clients, so
    each client's calls ride its own core-worker transport (here: the
    direct peer path, zero head messages per call).

    Near-zero CPU demand: a client spends its life blocked in get(), and
    full-CPU clients on a small host would hold the very cores their leaf
    tasks need (nested-resource deadlock)."""

    def run_actor_calls(self, handle, n, window):
        refs = []
        for _ in range(n):
            refs.append(handle.noop.remote())
            if len(refs) >= window:
                ray_tpu_torch.get(refs, timeout=120)
                refs = []
        if refs:
            ray_tpu_torch.get(refs, timeout=120)
        return n

    def run_tasks(self, n, window):
        refs = []
        for _ in range(n):
            refs.append(_noop.remote())
            if len(refs) >= window:
                ray_tpu_torch.get(refs, timeout=120)
                refs = []
        if refs:
            ray_tpu_torch.get(refs, timeout=120)
        return n


def bench_n_n_actor_calls_async(n_actors: int = 4, n_per: int = 1000) -> Dict:
    actors = [_Actor.remote() for _ in range(n_actors)]
    clients = [_Client.remote() for _ in range(n_actors)]
    ray_tpu_torch.get([a.noop.remote() for a in actors], timeout=60)
    ray_tpu_torch.get(
        [c.run_actor_calls.remote(a, 1, 1) for c, a in zip(clients, actors)],
        timeout=60,
    )

    def run():
        done = ray_tpu_torch.get(
            [
                c.run_actor_calls.remote(a, n_per, 100)
                for c, a in zip(clients, actors)
            ],
            timeout=300,
        )
        return sum(done)

    out = timeit("n_n_actor_calls_async", run)
    for a in actors + clients:
        ray_tpu_torch.kill(a)
    return out


def bench_put_ops(n: int = 2000) -> Dict:
    def run():
        for i in range(n):
            ray_tpu_torch.put(i)
        return n

    return timeit("single_client_put_ops", run)


def _copy_stats_delta(before: Dict, after: Dict) -> Dict:
    """{path: {copies, bytes, bytes_per_copy}} from two copy-counter
    snapshots (telemetry.copy_counter_snapshot) — the object plane's
    deterministic cost metric, same role writes_per_op plays for the
    control plane."""
    out: Dict = {}
    for path, rec in after.items():
        b = before.get(path, {"copies": 0.0, "bytes": 0.0})
        copies = rec.get("copies", 0.0) - b.get("copies", 0.0)
        nbytes = rec.get("bytes", 0.0) - b.get("bytes", 0.0)
        if copies > 0:
            out[path] = {
                "copies": int(copies),
                "bytes": int(nbytes),
                "bytes_per_copy": round(nbytes / copies, 1),
            }
    return out


def _cluster_copy_stats() -> Dict:
    """Cluster-wide copy counters: every process's pushed object_copies /
    object_copy_bytes series merged by the telemetry sink (workers count
    their own seals and pulls — the head's registry alone undercounts)."""
    from ray_tpu_torch._private.runtime import get_runtime

    rt = get_runtime()
    rt.telemetry.ingest("head", rt.head_telemetry_snapshot())
    agg = rt.telemetry.aggregate()
    out: Dict = {}
    for name, field in (("object_copies", "copies"), ("object_copy_bytes", "bytes")):
        rec = agg.get(name)
        for tk, v in (rec or {}).get("data", {}).items():
            path = dict(tk).get("path", "?")
            out.setdefault(path, {"copies": 0.0, "bytes": 0.0})[field] = float(v)
    return out


def bench_put_gigabytes(total_gb: float = 1.0, chunk_mb: int = 100) -> Dict:
    import numpy as np

    from ray_tpu_torch._private import telemetry as _telemetry

    chunk = np.zeros(chunk_mb * 1024 * 1024, dtype=np.uint8)
    n_chunks = int(total_gb * 1024 / chunk_mb)

    def run():
        refs = [ray_tpu_torch.put(chunk) for _ in range(n_chunks)]
        for r in refs:
            v = ray_tpu_torch.get(r, timeout=120)
            assert v.nbytes == chunk.nbytes
        return 1

    # report GB/s moved (put+get of total_gb counts as total_gb); median
    # of the timed runs, same honesty rule as timeit
    import statistics

    for _ in range(1):
        run()
    runs = []
    c0 = _telemetry.copy_counter_snapshot()
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        dt = time.perf_counter() - t0
        runs.append(round(total_gb / dt, 2))
    return {
        "name": "single_client_put_gigabytes",
        "gb_per_s": round(statistics.median(runs), 2),
        "runs": runs,
        # bytes-per-copy on the put path (this process seals every chunk):
        # one sealed copy per put, packed size each — the one-copy
        # create/seal claim, counted rather than asserted.
        "copy_stats": _copy_stats_delta(
            c0, _telemetry.copy_counter_snapshot()
        ),
    }


ALL = [
    bench_tasks_sync,
    bench_tasks_async,
    bench_multi_client_tasks_async,
    bench_actor_calls_sync,
    bench_actor_calls_async,
    bench_n_n_actor_calls_async,
    bench_put_ops,
    bench_put_gigabytes,
]


# ---------------------------------------------------------------------------
# telemetry A/B: the observability plane's performance acceptance bar


def _multi_client_once(n_clients: int = 4, n_per: int = 1000) -> float:
    """One timed multi_client_tasks_async wave on the CURRENT cluster
    (fresh clients, one warm round): ops/s."""
    clients = [_Client.remote() for _ in range(n_clients)]
    ray_tpu_torch.get([c.run_tasks.remote(1, 1) for c in clients], timeout=60)
    t0 = time.perf_counter()
    done = ray_tpu_torch.get(
        [c.run_tasks.remote(n_per, 100) for c in clients], timeout=300
    )
    dt = time.perf_counter() - t0
    for c in clients:
        ray_tpu_torch.kill(c)
    return round(sum(done) / dt, 1)


def refs_ab(out_path=None, rounds: int = 3, budget_pct: float = 3.0):
    """A/B the object-ledger leg ALONE: both sides run the full telemetry
    plane (push + trace + flight recorder); only RAY_TPU_REFS_PUSH (the
    live-ref table push + head-side ledger ingest) toggles.  This is the
    ISSUE 9 acceptance measurement — the ledger's own increment on
    multi_client_tasks_async must stay under budget.  (The whole-plane
    on/off number lives in telemetry_ab; on a noisy shared host the
    isolated toggle is the honest way to attribute cost to THIS leg.)

        python -m ray_tpu_torch._private.ray_perf --refs-ab \
            [--json BENCH_refs_r1.json]
    """
    import os as _os
    import statistics

    from ray_tpu_torch._private import config as _config
    from ray_tpu_torch.util import tracing

    flight_dir = f"/tmp/raytpu-refsab-flight-{_os.getpid()}"
    saved = {
        k: _os.environ.get(k)
        for k in (
            "RAY_TPU_METRICS_PUSH_MS",
            "RAY_TPU_TRACE",
            "RAY_TPU_FLIGHT_DIR",
            "RAY_TPU_REFS_PUSH",
        )
    }
    runs = {"off": [], "on": []}
    try:
        # Full plane on BOTH sides.
        _os.environ["RAY_TPU_METRICS_PUSH_MS"] = "1000"
        _os.environ["RAY_TPU_TRACE"] = "1"
        _os.environ["RAY_TPU_FLIGHT_DIR"] = flight_dir
        tracing.enable_tracing()
        for _r in range(rounds):
            for mode in ("off", "on"):
                _os.environ["RAY_TPU_REFS_PUSH"] = "0" if mode == "off" else "1"
                _config._reset_for_tests()
                ray_tpu_torch.init(num_cpus=max(_os.cpu_count() or 1, 16))
                try:
                    ops = _multi_client_once()
                finally:
                    ray_tpu_torch.shutdown()
                runs[mode].append(ops)
                print(
                    json.dumps({"mode": mode, "round": _r, "ops_per_s": ops}),
                    flush=True,
                )
    finally:
        for k, v in saved.items():
            if v is None:
                _os.environ.pop(k, None)
            else:
                _os.environ[k] = v
        _config._reset_for_tests()
        tracing.disable_tracing()
    off_m = statistics.median(runs["off"])
    on_m = statistics.median(runs["on"])
    overhead_pct = round((off_m - on_m) / off_m * 100, 2)
    report = {
        "name": "refs_push_ab_multi_client_tasks_async",
        "note": (
            "interleaved rounds, medians compared (median-of-"
            f"{rounds}).  BOTH sides run the full telemetry plane "
            "(RAY_TPU_METRICS_PUSH_MS=1000, RAY_TPU_TRACE=1, flight "
            "recorder armed); only RAY_TPU_REFS_PUSH toggles — the "
            "object-ledger leg (per-process live-ref tables pushed each "
            "tick + head-side ledger joins/gauges) is the only delta"
        ),
        "off_runs": runs["off"],
        "on_runs": runs["on"],
        "off_median_ops_per_s": off_m,
        "on_median_ops_per_s": on_m,
        "overhead_pct": overhead_pct,
        "budget_pct": budget_pct,
        "pass": overhead_pct < budget_pct,
    }
    print(json.dumps(report, indent=1), flush=True)
    if out_path:
        with open(out_path, "w") as f:
            json.dump(report, f, indent=1)
            f.write("\n")
    assert overhead_pct < budget_pct, (
        f"refs-push leg costs {overhead_pct}% on multi_client_tasks_async "
        f"(budget {budget_pct}%): off={runs['off']} on={runs['on']}"
    )
    return report


def prof_ab(out_path=None, rounds: int = 3, budget_pct: float = 5.0):
    """A/B the sampling profiler ALONE on multi_client_tasks_async: both
    sides run the normal plane defaults; only RAY_TPU_PROF_HZ toggles
    between 0 (off — the zero-overhead fast path) and the default rate.
    Interleaved rounds, medians compared — the ISSUE 10 acceptance
    measurement (profiler on at default HZ must cost <5%).

        python -m ray_tpu_torch._private.ray_perf --prof-ab \
            [--json BENCH_prof_r1.json]
    """
    import os as _os
    import statistics

    from ray_tpu_torch._private import config as _config
    from ray_tpu_torch._private import profiler as _profiler

    hz = _profiler.DEFAULT_HZ
    saved = _os.environ.get("RAY_TPU_PROF_HZ")
    runs = {"off": [], "on": []}
    try:
        for _r in range(rounds):
            for mode in ("off", "on"):
                _os.environ["RAY_TPU_PROF_HZ"] = (
                    "0" if mode == "off" else str(hz)
                )
                _config._reset_for_tests()
                _profiler._reset_for_tests()  # stop any prior sampler
                ray_tpu_torch.init(num_cpus=max(_os.cpu_count() or 1, 16))
                try:
                    ops = _multi_client_once()
                finally:
                    ray_tpu_torch.shutdown()
                    _profiler._reset_for_tests()
                runs[mode].append(ops)
                print(
                    json.dumps({"mode": mode, "round": _r, "ops_per_s": ops}),
                    flush=True,
                )
    finally:
        if saved is None:
            _os.environ.pop("RAY_TPU_PROF_HZ", None)
        else:
            _os.environ["RAY_TPU_PROF_HZ"] = saved
        _config._reset_for_tests()
        _profiler._reset_for_tests()
    off_m = statistics.median(runs["off"])
    on_m = statistics.median(runs["on"])
    overhead_pct = round((off_m - on_m) / off_m * 100, 2)
    report = {
        "name": "prof_ab_multi_client_tasks_async",
        "hz": hz,
        "note": (
            "interleaved OFF/ON rounds, medians compared (median-of-"
            f"{rounds}).  OFF = RAY_TPU_PROF_HZ unset (the ENABLED "
            "module-bool fast path: no thread, no per-op check beyond "
            "the ticker's one bool); ON = every process samples "
            f"sys._current_frames() at {hz}Hz and pushes collapsed-stack "
            "tables each telemetry tick"
        ),
        "off_runs": runs["off"],
        "on_runs": runs["on"],
        "off_median_ops_per_s": off_m,
        "on_median_ops_per_s": on_m,
        "overhead_pct": overhead_pct,
        "budget_pct": budget_pct,
        "pass": overhead_pct < budget_pct,
    }
    print(json.dumps(report, indent=1), flush=True)
    if out_path:
        with open(out_path, "w") as f:
            json.dump(report, f, indent=1)
            f.write("\n")
    assert overhead_pct < budget_pct, (
        f"profiler at {hz}Hz costs {overhead_pct}% on "
        f"multi_client_tasks_async (budget {budget_pct}%): "
        f"off={runs['off']} on={runs['on']}"
    )
    return report


def telemetry_ab(out_path=None, rounds: int = 3, budget_pct: float = 3.0):
    """A/B the FULL telemetry plane (metric push + trace spans + flight
    recorder) against telemetry-off on the multi_client_tasks_async
    shape.  Runs interleave OFF/ON per round (drift on a shared host
    cancels instead of biasing one side) and the medians-of-N compare —
    the same honesty rule as the headline benches.  Asserts the overhead
    budget (<3% by the ISSUE 6 acceptance bar) and writes the artifact.

        python -m ray_tpu_torch._private.ray_perf --telemetry-ab \
            [--json BENCH_telemetry_r1.json]
    """
    import os as _os
    import statistics

    from ray_tpu_torch._private import config as _config
    from ray_tpu_torch.util import tracing

    flight_dir = f"/tmp/raytpu-ab-flight-{_os.getpid()}"
    saved = {
        k: _os.environ.get(k)
        for k in (
            "RAY_TPU_METRICS_PUSH_MS",
            "RAY_TPU_TRACE",
            "RAY_TPU_FLIGHT_DIR",
            "RAY_TPU_REFS_PUSH",
        )
    }
    runs = {"off": [], "on": []}
    try:
        for _r in range(rounds):
            for mode in ("off", "on"):
                if mode == "off":
                    _os.environ["RAY_TPU_METRICS_PUSH_MS"] = "0"
                    _os.environ["RAY_TPU_REFS_PUSH"] = "0"
                    _os.environ.pop("RAY_TPU_TRACE", None)
                    _os.environ.pop("RAY_TPU_FLIGHT_DIR", None)
                    tracing.disable_tracing()
                else:
                    # The default push period, tracing on, flight dumps
                    # armed, refs-push feeding the object ledger — the
                    # whole plane, not a softened subset.
                    _os.environ["RAY_TPU_METRICS_PUSH_MS"] = "1000"
                    _os.environ["RAY_TPU_REFS_PUSH"] = "1"
                    _os.environ["RAY_TPU_TRACE"] = "1"
                    _os.environ["RAY_TPU_FLIGHT_DIR"] = flight_dir
                    tracing.enable_tracing()
                _config._reset_for_tests()
                ray_tpu_torch.init(num_cpus=max(_os.cpu_count() or 1, 16))
                try:
                    ops = _multi_client_once()
                finally:
                    ray_tpu_torch.shutdown()
                runs[mode].append(ops)
                print(
                    json.dumps({"mode": mode, "round": _r, "ops_per_s": ops}),
                    flush=True,
                )
    finally:
        for k, v in saved.items():
            if v is None:
                _os.environ.pop(k, None)
            else:
                _os.environ[k] = v
        _config._reset_for_tests()
        tracing.disable_tracing()
    off_m = statistics.median(runs["off"])
    on_m = statistics.median(runs["on"])
    overhead_pct = round((off_m - on_m) / off_m * 100, 2)
    report = {
        "name": "telemetry_ab_multi_client_tasks_async",
        "note": (
            "interleaved OFF/ON rounds; medians compared (median-of-"
            f"{rounds}).  ON = RAY_TPU_METRICS_PUSH_MS=1000 + "
            "RAY_TPU_REFS_PUSH=1 (object-ledger ref tables) + "
            "RAY_TPU_TRACE=1 + flight recorder armed; OFF = push "
            "disabled, no refs push, no tracing, no flight dir"
        ),
        "off_runs": runs["off"],
        "on_runs": runs["on"],
        "off_median_ops_per_s": off_m,
        "on_median_ops_per_s": on_m,
        "overhead_pct": overhead_pct,
        "budget_pct": budget_pct,
        "pass": overhead_pct < budget_pct,
    }
    print(json.dumps(report, indent=1), flush=True)
    if out_path:
        with open(out_path, "w") as f:
            json.dump(report, f, indent=1)
            f.write("\n")
    assert overhead_pct < budget_pct, (
        f"telemetry plane costs {overhead_pct}% on multi_client_tasks_async "
        f"(budget {budget_pct}%): off={runs['off']} on={runs['on']}"
    )
    return report


# ---------------------------------------------------------------------------
# io-shard sweep: the head-fabric scaling acceptance artifact


def shard_sweep(out_path=None, shard_counts=(0, 1, 2, 4), rounds: int = 3):
    """multi_client_tasks_async across RAY_TPU_HEAD_IO_SHARDS values:
    fresh cluster per point, median-of-N (the honesty rule), per-shard
    wire counters captured from the telemetry sink — the deterministic
    proof that decode work actually runs on shard pids.

        python -m ray_tpu_torch._private.ray_perf --shard-sweep \
            [--json BENCH_shard_r1.json]

    Honesty note baked into the artifact: on a 1-vCPU host every shard
    process shares one core with the head, so throughput gains are
    bounded by core count — the sweep's job THERE is to show sharding
    costs ~nothing and moves the decode work out; scaling shows up on
    multi-core hosts (the reference envelope is 64 cores)."""
    import os as _os
    import statistics

    from ray_tpu_torch._private import config as _config

    saved = _os.environ.get("RAY_TPU_HEAD_IO_SHARDS")
    sweep = []
    try:
        for n in shard_counts:
            _os.environ["RAY_TPU_HEAD_IO_SHARDS"] = str(n)
            _config._reset_for_tests()
            ray_tpu_torch.init(num_cpus=max(_os.cpu_count() or 1, 16))
            runs = []
            shard_stats = {}
            try:
                for _ in range(rounds):
                    runs.append(_multi_client_once())
                from ray_tpu_torch._private.runtime import get_runtime

                rt = get_runtime()
                time.sleep(1.3)  # let a final metrics push land
                for key, snap in sorted(rt.telemetry.processes.items()):
                    if not key.startswith("io_shard"):
                        continue
                    w = snap.get("wire") or {}
                    shard_stats[key] = {
                        "pid": snap.get("pid"),
                        "logical_frames": w.get("logical_frames", 0),
                        "physical_writes": w.get("physical_writes", 0),
                        "bytes_written": w.get("bytes_written", 0),
                        "conns": int(
                            (snap.get("internal") or {}).get("io_shard_conns", 0)
                        ),
                    }
            finally:
                ray_tpu_torch.shutdown()
            rec = {
                "io_shards": n,
                "ops_per_s": round(statistics.median(runs), 1),
                "runs": runs,
                "shard_wire_stats": shard_stats,
            }
            sweep.append(rec)
            print(json.dumps(rec), flush=True)
    finally:
        if saved is None:
            _os.environ.pop("RAY_TPU_HEAD_IO_SHARDS", None)
        else:
            _os.environ["RAY_TPU_HEAD_IO_SHARDS"] = saved
        _config._reset_for_tests()
    report = {
        "name": "multi_client_tasks_async_shard_sweep",
        "host": host_shape(),
        "host_nproc": _os.cpu_count(),
        "note": (
            "median-of-%d per point, fresh cluster per point.  HONESTY: "
            "on a %s-vCPU host every io shard shares cores with the head "
            "process, so ops/s gains are bounded by core count — the "
            "meaningful claims here are (a) sharding at 0 extra cores "
            "costs within host noise and (b) shard_wire_stats proves the "
            "per-conn decode work (logical_frames/physical_writes) runs "
            "on shard pids, off the head's loop.  Throughput SCALING with "
            "shard count is a multi-core-host claim (reference envelope: "
            "32k tasks/s on 64 cores, SURVEY.md §6)."
            % (rounds, _os.cpu_count())
        ),
        "sweep": sweep,
    }
    print(json.dumps(report, indent=1), flush=True)
    if out_path:
        with open(out_path, "w") as f:
            json.dump(report, f, indent=1)
            f.write("\n")
    return report


def host_copy_ceiling() -> Dict:
    """The host's raw copy envelope, measured: memcpy GB/s, single-stream
    loopback socket GB/s, and the relay integrity checksum's GB/s.  A
    broadcast's effective GB/s is bounded by these — on a 1-vCPU box
    whose memcpy runs ~1 GB/s, no transfer topology can land 300MB in
    under ~0.2s, and a checksummed relay hop costs about one extra
    memcpy of the object.  Stamped into BENCH artifacts so a number that
    looks far from the reference envelope carries its own explanation."""
    import os as _os
    import socket
    import threading
    import zlib

    mb = 100
    buf = _os.urandom(mb * 1024 * 1024)
    dst = bytearray(len(buf))
    t0 = time.perf_counter()
    dst[:] = buf
    memcpy = mb / 1024 / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    zlib.adler32(buf)
    adler = mb / 1024 / (time.perf_counter() - t0)
    a, b = socket.socketpair()
    view = memoryview(buf)

    def sender():
        off = 0
        while off < len(view):
            off += a.send(view[off : off + (1 << 20)])
        a.close()

    th = threading.Thread(target=sender, daemon=True)
    recv = memoryview(dst)
    t0 = time.perf_counter()
    th.start()
    got = 0
    while got < len(buf):
        n = b.recv_into(recv[got:], len(buf) - got)
        if n == 0:
            break
        got += n
    loopback = mb / 1024 / (time.perf_counter() - t0)
    b.close()
    th.join(5)
    return {
        "name": "host_copy_ceiling",
        "memcpy_gb_per_s": round(memcpy, 2),
        "adler32_gb_per_s": round(adler, 2),
        "loopback_stream_gb_per_s": round(loopback, 2),
    }


def _cold_broadcast_once(rt, nids, payload, land, expect) -> float:
    """One COLD broadcast round: fresh put (new object id), land on every
    target node, free.  Returns the wall seconds of the landing wave."""
    from ray_tpu_torch.util.scheduling_strategies import NodeAffinitySchedulingStrategy

    ref = ray_tpu_torch.put(payload)
    t0 = time.perf_counter()
    outs = ray_tpu_torch.get(
        [
            land.options(
                scheduling_strategy=NodeAffinitySchedulingStrategy(nid)
            ).remote(ref)
            for nid in nids
        ],
        timeout=300,
    )
    dt = time.perf_counter() - t0
    assert all(o == expect for o in outs)
    del ref  # free the copies before the next cold round
    return dt


def _set_relay(enabled: bool) -> None:
    import os as _os

    from ray_tpu_torch._private import config as _config

    _os.environ["RAY_TPU_RELAY_PIPELINE"] = "1" if enabled else "0"
    _config._reset_for_tests()


def broadcast_relay_ab(rt, nids, mb: int = 100, rounds: int = 3) -> Dict:
    """INTERLEAVED relay on/off A/B of the cold broadcast (same cluster,
    same payload size, alternating rounds): the acceptance measurement
    for the pipelined transfer plan.  The OFF side is the classic
    staggered admission (BENCH_objmem_r1's regime); the ON side hands
    out chain/tree plans with mid-flight relays.  Counter leg: the ON
    rounds must land EXACTLY one sealed copy (pull|relay) per receiving
    node per round — pipelining must not multiply copies or re-read the
    source."""
    import numpy as np
    import statistics

    payload = np.random.default_rng(1).integers(
        0, 255, size=mb * 1024 * 1024, dtype=np.uint8
    )
    expect = int(payload[::1024].sum())

    @ray_tpu_torch.remote
    def land(x):
        return int(x[::1024].sum())

    total_gb = mb * len(nids) / 1024
    times = {"on": [], "off": []}
    try:
        _set_relay(True)  # warm both regimes once (worker spawn etc.)
        _cold_broadcast_once(rt, nids, payload, land, expect)
        time.sleep(1.0)
        c0 = _cluster_copy_stats()
        on_rounds = 0
        for _ in range(rounds):
            for side in ("on", "off"):
                _set_relay(side == "on")
                times[side].append(
                    round(_cold_broadcast_once(rt, nids, payload, land, expect), 3)
                )
                if side == "on":
                    on_rounds += 1
                time.sleep(0.3)  # let frees land before the next cold round
        _set_relay(True)
        time.sleep(1.5)  # final worker copy-counter pushes land
        c1 = _cluster_copy_stats()
    finally:
        _set_relay(True)
    stats = _copy_stats_delta(c0, c1)
    landed = sum(
        stats.get(p, {}).get("copies", 0) for p in ("pull", "relay")
    )
    on = statistics.median(times["on"])
    off = statistics.median(times["off"])
    return {
        "name": f"broadcast_relay_ab_{mb}mb_to_{len(nids)}_nodes",
        "note": (
            "single-host A/B: all 'nodes' share one CPU, so both regimes "
            "are bound by the host_copy_ceiling (every relay hop adds one "
            "adler32 pass ~= a memcpy of the object) and the pipeline's "
            "structural win — replacing log2(N) serial whole-object "
            "rounds with one concurrent chain — cannot show in wall "
            "clock; the relay counters + plan shape are the claim this "
            "artifact proves, the multi-host wall-clock claim needs "
            "multi-host hardware (same residual class as BENCH_shard_r2)"
        ),
        "rounds": rounds,
        "relay_on_s": times["on"],
        "relay_off_s": times["off"],
        "on_median_s": on,
        "off_median_s": off,
        "on_gb_per_s": round(total_gb / on, 2),
        "off_gb_per_s": round(total_gb / off, 2),
        "speedup": round(off / on, 2),
        # one sealed copy per receiving node per timed round (warm round
        # + A/B off-rounds included in the window: every cold round of
        # EITHER regime lands exactly n_nodes copies)
        "copies_per_round": round(landed / max(2 * rounds + 1, 1), 2),
        "nodes": len(nids),
        "copy_stats": stats,
    }


def broadcast_sweep(rt, sizes_mb=(8, 100), fanouts=(2, 4),
                    chunks_mb=(1, 8), rounds: int = 3) -> Dict:
    """Cold-broadcast grid: object size x fan-out (receiving nodes) x
    transfer chunk size, median-of-N cold rounds per cell, relay plans
    on.  The effective GB/s figure is (size * fanout) / wall — bytes
    landed per second of broadcast wall clock.  Daemons resolve the
    chunk knob at spawn, so each chunk size gets a FRESH node set (env
    inherited at daemon launch)."""
    import os as _os
    import statistics

    import numpy as np

    from ray_tpu_torch._private import config as _config
    from ray_tpu_torch.util.scheduling_strategies import NodeAffinitySchedulingStrategy

    @ray_tpu_torch.remote
    def land(x):
        return int(x[::1024].sum())

    @ray_tpu_torch.remote
    def warm():
        return 1

    cells = []
    saved = _os.environ.get("RAY_TPU_OBJECT_TRANSFER_CHUNK_BYTES")
    try:
        for chunk_mb in chunks_mb:
            _os.environ["RAY_TPU_OBJECT_TRANSFER_CHUNK_BYTES"] = str(
                chunk_mb * 1024 * 1024
            )
            _config._reset_for_tests()
            nids = [rt.add_daemon_node(num_cpus=1) for _ in range(max(fanouts))]
            ray_tpu_torch.get(
                [
                    warm.options(
                        scheduling_strategy=NodeAffinitySchedulingStrategy(nid)
                    ).remote()
                    for nid in nids
                ],
                timeout=120,
            )
            for mb in sizes_mb:
                payload = np.random.default_rng(mb).integers(
                    0, 255, size=mb * 1024 * 1024, dtype=np.uint8
                )
                expect = int(payload[::1024].sum())
                for fanout in fanouts:
                    runs = [
                        round(
                            _cold_broadcast_once(
                                rt, nids[:fanout], payload, land, expect
                            ),
                            3,
                        )
                        for _ in range(rounds)
                    ]
                    med = statistics.median(runs)
                    cells.append(
                        {
                            "mb": mb,
                            "fanout": fanout,
                            "chunk_mb": chunk_mb,
                            "cold_s": runs,
                            "median_s": med,
                            "gb_per_s": round(mb * fanout / 1024 / med, 2),
                        }
                    )
                    time.sleep(0.3)
            for nid in nids:
                rt.remove_node(nid)
    finally:
        if saved is None:
            _os.environ.pop("RAY_TPU_OBJECT_TRANSFER_CHUNK_BYTES", None)
        else:
            _os.environ["RAY_TPU_OBJECT_TRANSFER_CHUNK_BYTES"] = saved
        _config._reset_for_tests()
    return {
        "name": "broadcast_sweep",
        "note": "relay plans ON; gb_per_s = size*fanout/wall (median-of-%d); "
        "fresh daemons per chunk size (the knob binds at spawn)" % rounds,
        "cells": cells,
    }


def arena_put_get_ab(rounds: int = 3, chunk_mb: int = 100, n_chunks: int = 5) -> Dict:
    """Arena vs file-per-object A/B for the hot put/get path: fresh
    cluster per side per round (the store backend is fixed at init),
    interleaved.  Counter leg: BOTH backends must show exactly one
    sealed copy per put (create->seal is one copy); the arena side must
    additionally show one zero-byte arena_map per get — reads MAP the
    sealed buffer, they don't copy it out of the store."""
    import os as _os
    import statistics

    import numpy as np

    from ray_tpu_torch._private import config as _config
    from ray_tpu_torch._private import telemetry as _telemetry

    chunk = np.zeros(chunk_mb * 1024 * 1024, dtype=np.uint8)
    gb = chunk_mb * n_chunks / 1024
    out = {"arena": {"runs": []}, "file": {"runs": []}}
    saved = _os.environ.get("RAY_TPU_NATIVE_STORE")
    try:
        for _ in range(rounds):
            for side in ("arena", "file"):
                _os.environ["RAY_TPU_NATIVE_STORE"] = (
                    "1" if side == "arena" else "0"
                )
                _config._reset_for_tests()
                ray_tpu_torch.init(num_cpus=8, ignore_reinit_error=True)
                try:
                    refs = [ray_tpu_torch.put(chunk) for _ in range(1)]  # warm
                    ray_tpu_torch.get(refs)
                    del refs
                    c0 = _telemetry.copy_counter_snapshot()
                    t0 = time.perf_counter()
                    refs = [ray_tpu_torch.put(chunk) for _ in range(n_chunks)]
                    for r in refs:
                        v = ray_tpu_torch.get(r, timeout=120)
                        assert v.nbytes == chunk.nbytes
                    dt = time.perf_counter() - t0
                    del refs, v
                    stats = _copy_stats_delta(
                        c0, _telemetry.copy_counter_snapshot()
                    )
                    out[side]["runs"].append(round(gb / dt, 2))
                    out[side]["copy_stats"] = stats
                finally:
                    ray_tpu_torch.shutdown()
    finally:
        if saved is None:
            _os.environ.pop("RAY_TPU_NATIVE_STORE", None)
        else:
            _os.environ["RAY_TPU_NATIVE_STORE"] = saved
        _config._reset_for_tests()
    for side in ("arena", "file"):
        out[side]["gb_per_s"] = statistics.median(out[side]["runs"])
    return {
        "name": "arena_put_get_ab",
        "note": (
            "interleaved fresh-cluster A/B; gb_per_s is put+get of "
            f"{gb:.2f}GB counted once, median-of-{rounds}.  copy_stats "
            "(last round) prove 1 put-copy per put on both sides and "
            "zero-byte arena_map reads on the arena side"
        ),
        **out,
        "arena_over_file": round(
            out["arena"]["gb_per_s"] / max(out["file"]["gb_per_s"], 1e-9), 3
        ),
    }


def object_plane_bench(out_path=None):
    """The object-plane fast-path benchmark (ISSUE 12): put throughput,
    the arena put/get A/B, the relay on/off broadcast A/B (acceptance:
    cold 100MB x 3-node >= 3x the staggered baseline), and the broadcast
    sweep (size x fan-out x chunk), all with bytes-per-copy counter
    deltas.

        python -m ray_tpu_torch._private.ray_perf --object-plane \
            [--json BENCH_objmem_r2.json]
    """
    import os as _os

    results = [{"name": "host_note", **host_shape()}, host_copy_ceiling()]
    print(json.dumps(results[-1]), flush=True)
    # Arena A/B boots its own clusters: run it FIRST (clean slate).
    r = arena_put_get_ab()
    results.append(r)
    print(json.dumps(r), flush=True)
    ray_tpu_torch.init(num_cpus=max(_os.cpu_count() or 1, 8), ignore_reinit_error=True)
    from ray_tpu_torch._private.runtime import get_runtime

    rt = get_runtime()
    results.append(bench_put_gigabytes())
    print(json.dumps(results[-1]), flush=True)
    nids = [rt.add_daemon_node(num_cpus=1) for _ in range(4)]

    @ray_tpu_torch.remote
    def warm():
        return 1

    from ray_tpu_torch.util.scheduling_strategies import NodeAffinitySchedulingStrategy

    ray_tpu_torch.get(
        [
            warm.options(
                scheduling_strategy=NodeAffinitySchedulingStrategy(nid)
            ).remote()
            for nid in nids
        ],
        timeout=120,
    )
    r = broadcast_relay_ab(rt, nids[:3])
    results.append(r)
    print(json.dumps(r), flush=True)
    for nid in nids:
        rt.remove_node(nid)
    r = broadcast_sweep(rt)
    results.append(r)
    print(json.dumps(r), flush=True)
    ray_tpu_torch.shutdown()
    report = {
        "name": "object_plane_fastpath",
        "note": (
            "relay A/B is interleaved on/off on one cluster (off = the "
            "classic staggered rounds, BENCH_objmem_r1's regime); "
            "broadcast gb_per_s = size*fanout/wall; copy_stats are "
            "object_copies/object_copy_bytes counter deltas (cluster "
            "aggregate for broadcasts, this process for puts)"
        ),
        "benches": results,
    }
    if out_path:
        with open(out_path, "w") as f:
            json.dump(report, f, indent=1)
            f.write("\n")
    return report


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    out_path = None
    if "--json" in argv:
        out_path = argv[argv.index("--json") + 1]
    if "--telemetry-ab" in argv:
        return telemetry_ab(out_path)
    if "--refs-ab" in argv:
        return refs_ab(out_path)
    if "--prof-ab" in argv:
        return prof_ab(out_path)
    if "--shard-sweep" in argv:
        return shard_sweep(out_path)
    if "--object-plane" in argv:
        return object_plane_bench(out_path)
    if "--io-shards" in argv:
        # Whole-suite override: run every bench with a sharded head
        # fabric (the env form reaches the Runtime this process boots).
        import os as _os2

        _os2.environ["RAY_TPU_HEAD_IO_SHARDS"] = argv[
            argv.index("--io-shards") + 1
        ]
        from ray_tpu_torch._private import config as _config2

        _config2._reset_for_tests()
    import os as _os

    # Logical-CPU headroom: the benches measure control-plane throughput,
    # not core count; without it a small host can't place the n:n actor
    # pairs at all (the reference runs these on 64-core machines).
    ray_tpu_torch.init(num_cpus=max(_os.cpu_count() or 1, 16), ignore_reinit_error=True)
    if _os.environ.get("RAY_TPU_PERF_PERSIST") == "1":
        _enable_local_persistence()
    results = [
        {
            "name": "host_note",
            **host_shape(),
            "note": (
                "ops_per_s is the MEDIAN of the 3 runs ('runs' lists all); "
                "writes_per_op / frames_per_op are this process's wire-"
                "counter deltas (physical writes vs logical control frames "
                "per op — the frame-coalescing factor); with "
                "RAY_TPU_PERF_PERSIST=1 journal_appends_per_op / "
                "journal_fsyncs_per_op report the GCS mutation journal's "
                "per-op durability cost the same way"
            ),
        }
    ]
    # --profile: the whole suite runs with the cluster profiler hot; the
    # output gains a merged flamegraph (top stacks) + the stage-attributed
    # task summary, so any bench shape ships with "where the time went"
    # evidence instead of a bare ops/s number (ISSUE 10).
    profiling = "--profile" in argv
    if profiling:
        from ray_tpu_torch.util import state as _state_api

        _state_api.profile_start()
    for bench in ALL:
        r = bench()
        results.append(r)
        print(json.dumps(r), flush=True)
    if profiling:
        import time as _t

        from ray_tpu_torch.util import state as _state_api

        _state_api.profile_stop()
        _t.sleep(1.2)  # final worker prof_push beats land
        rep = _state_api.profile_report()
        top = sorted(
            (rep.get("samples") or {}).items(), key=lambda kv: -kv[1]
        )[:25]
        prof_result = {
            "name": "profile_attachment",
            "pids": rep.get("pids"),
            "total_samples": rep.get("total_samples"),
            "top_stacks": [{"stack": s, "samples": n} for s, n in top],
            "task_summary": {
                k: v
                for k, v in _state_api.task_summary(slow=5).items()
                if k in (
                    "tasks", "states", "stages", "accounted_fraction",
                    "slow",
                )
            },
        }
        results.append(prof_result)
        print(json.dumps(prof_result), flush=True)
    ray_tpu_torch.shutdown()
    if out_path:
        with open(out_path, "w") as f:
            json.dump(results, f, indent=1)
    return results




def bench_broadcast_cross_node(n_nodes: int = 3, mb: int = 100) -> Dict:
    """Broadcast one large object to N ISOLATED-store daemon nodes over the
    transfer plane (BASELINE.md: '1 GiB broadcast to 50 nodes' scalability
    row; here sized for CI).  Each node pulls chunked from the owner and
    seals a local copy — no shared filesystem path involved."""
    import numpy as np

    from ray_tpu_torch._private.runtime import get_runtime
    from ray_tpu_torch.util.scheduling_strategies import NodeAffinitySchedulingStrategy

    rt = get_runtime()
    nids = [rt.add_daemon_node(num_cpus=1) for _ in range(n_nodes)]
    payload = np.random.default_rng(0).integers(
        0, 255, size=mb * 1024 * 1024, dtype=np.uint8
    )
    ref = ray_tpu_torch.put(payload)

    @ray_tpu_torch.remote
    def land(x):
        return int(x[::1024].sum())

    @ray_tpu_torch.remote
    def warm_up():
        return 1

    # Spawn each node's worker BEFORE the timed run: the cold number must
    # measure the transfer plane, not process boot.
    ray_tpu_torch.get(
        [
            warm_up.options(
                scheduling_strategy=NodeAffinitySchedulingStrategy(nid)
            ).remote()
            for nid in nids
        ],
        timeout=120,
    )

    expect = int(payload[::1024].sum())

    def run():
        t0 = time.perf_counter()
        outs = ray_tpu_torch.get(
            [
                land.options(
                    scheduling_strategy=NodeAffinitySchedulingStrategy(nid)
                ).remote(ref)
                for nid in nids
            ],
            timeout=300,
        )
        assert all(o == expect for o in outs)
        return time.perf_counter() - t0

    # Copy counters are cluster-wide (each node's worker counts its own
    # pull): snapshot the pushed aggregate around the cold round, with a
    # settle sleep so the final worker ticks land.
    time.sleep(1.5)
    c0 = _cluster_copy_stats()
    cold = run()  # every node pulls over the wire
    time.sleep(1.5)
    c1 = _cluster_copy_stats()
    warm = run()  # all copies local: pure read path
    for nid in nids:
        rt.remove_node(nid)
    total_gb = mb * n_nodes / 1024
    return {
        "name": f"broadcast_{mb}mb_to_{n_nodes}_nodes",
        "cold_s": round(cold, 3),
        "cold_gb_per_s": round(total_gb / cold, 2),
        "warm_s": round(warm, 3),
        # the bytes-per-copy ledger of the cold broadcast: n_nodes pull
        # copies of the packed payload, and nothing else should move
        "copy_stats": _copy_stats_delta(c0, c1),
    }


if __name__ == "__main__":
    main()
