"""CLI: `python -m ray_tpu_torch.scripts.cli <command>`.

ray: python/ray/scripts/scripts.py (`ray status/list/microbenchmark/
timeline/job submit`).  Commands that need a live cluster boot a local one
unless attaching is implemented by the deployment (the daemons connect to
a driver, so `status` etc. act on the CURRENT process's runtime — these
commands are most useful embedded in driver scripts or via the dashboard).
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def cmd_microbenchmark(args) -> int:
    from ray_tpu_torch._private import ray_perf

    ray_perf.main(["--json", args.json] if args.json else [])
    return 0


def _init_maybe_attached(args):
    """init() against --address (head.json path / ray:// URL) when given,
    else the local/current runtime.  Returns the attached WorkerRuntime or
    None (head-local)."""
    import ray_tpu_torch
    from ray_tpu_torch._private.worker_proc import get_worker_runtime

    ray_tpu_torch.init(
        ignore_reinit_error=True,
        address=args.address if getattr(args, "address", None) else None,
    )
    return get_worker_runtime()


def _io_shard_rows(procs) -> dict:
    """Head io-shard fabric as `status` rows: one entry per shard process
    with its pushed conn-count gauge (io_shard.py metrics push)."""
    rows = {}
    for key, rec in (procs or {}).items():
        if not str(rec.get("proc", "")).startswith("io_shard"):
            continue
        internal = rec.get("internal") or {}
        rows[key] = {
            "pid": rec.get("pid"),
            "conns": int(internal.get("io_shard_conns", 0)),
            "pending_handoff_sends": int(
                internal.get("io_shard_pending_handoff_sends", 0)
            ),
            "age_s": rec.get("age_s"),
        }
    return rows


def cmd_status(args) -> int:
    import ray_tpu_torch
    from ray_tpu_torch.util import state as state_api

    wr = _init_maybe_attached(args)
    # Per-node elastic-capacity rows: lifecycle state (ACTIVE/DRAINING/...),
    # lease count and remote-store bytes — the drain protocol's progress is
    # readable straight off `ray_tpu_torch status` (attached or head-local; both
    # ride the state_list "nodes" verb).
    nodes = state_api.list_nodes()
    node_rows = [
        {
            "node_id": n["node_id"],
            "state": n.get("state"),
            "is_head": n["is_head"],
            "leases": n.get("lease_count", 0),
            "store_bytes": n.get("store_bytes", 0),
            "available": n.get("available", {}),
        }
        for n in nodes
    ]
    if wr is not None:
        tele = wr.request("telemetry", None)
        out = {
            "nodes": node_rows,
            "resources": ray_tpu_torch.cluster_resources(),
            "available": ray_tpu_torch.available_resources(),
            "demand": state_api.demand_summary(),
            "telemetry_processes": tele.get("processes", {}),
            "telemetry": tele.get("internal", {}),
            "io_shards": _io_shard_rows(tele.get("processes")),
        }
    else:
        tele = state_api.telemetry_summary()
        out = {
            "nodes": nodes,
            "node_states": node_rows,
            "resources": ray_tpu_torch.cluster_resources(),
            "available": ray_tpu_torch.available_resources(),
            "demand": state_api.demand_summary(),
            "metrics": state_api.cluster_metrics(),
            "telemetry_processes": tele.get("processes", {}),
            "io_shards": _io_shard_rows(tele.get("processes")),
        }
    print(json.dumps(out, indent=1, default=str))
    return 0


def cmd_metrics(args) -> int:
    """`ray_tpu_torch metrics`: the pushed-metrics plane — cluster aggregate +
    per-process snapshot ages; --series <name> dumps that aggregate's
    ring time series (the bounded GCS-side storage)."""
    from ray_tpu_torch.util import state as state_api

    wr = _init_maybe_attached(args)
    if args.series:
        if wr is not None:
            out = wr.request("telemetry_series", args.series)
        else:
            out = state_api.telemetry_series(args.series)
    elif wr is not None:
        out = wr.request("telemetry", None)
    else:
        out = state_api.telemetry_summary()
    print(json.dumps(out, indent=1, default=str))
    return 0


def cmd_memory(args) -> int:
    """`ray_tpu_torch memory`: the cluster object ledger — per-node bytes, top
    objects with holder attribution, leak suspects (`--leaks`), group-by
    node|owner|callsite (ray: `ray memory`).  Attachable: --address gets
    the head's join over the request plane."""
    from ray_tpu_torch.util import state as state_api

    _init_maybe_attached(args)
    out = state_api.memory_summary(
        group_by=args.group_by, top=args.top, include_events=args.events
    )
    if args.leaks:
        out = {
            "leak_suspects": out["leak_suspects"],
            "leak_suspect_bytes": out["leak_suspect_bytes"],
            "leaks": [
                {
                    "object_id": r["object_id"],
                    "size_bytes": r["size_bytes"],
                    "location": r["location"],
                    "reason": r["leak"],
                    "holders": [
                        {
                            "holder": h["holder"],
                            "node": h["node"],
                            "pid": h["pid"],
                            "count": h["count"],
                            "dead": h["dead"],
                        }
                        for h in r["holders"]
                    ],
                    "age_s": r["age_s"],
                }
                for r in out["leaks"]
            ],
        }
    print(json.dumps(out, indent=1, default=str))
    return 0


def cmd_timeline(args) -> int:
    from ray_tpu_torch.dashboard import timeline

    wr = _init_maybe_attached(args)
    out = args.output or "timeline.json"
    window = {"last": args.last, "since": args.since}
    if wr is not None:
        events = wr.request("timeline", window)
    else:
        events = timeline(**window)
    with open(out, "w") as f:
        json.dump(events, f)
    pids = {e.get("pid") for e in events}
    bound = (
        f" (window: --since {args.since})" if args.since
        else f" (window: last {args.last}s)" if args.last
        else ""
    )
    print(
        f"wrote {out}: {len(events)} events across {len(pids)} processes"
        f"{bound} (open in chrome://tracing or Perfetto)"
    )
    return 0


def cmd_profile(args) -> int:
    """`ray_tpu_torch profile`: cluster-wide sampling flamegraph — broadcast
    start, sample for --seconds, broadcast stop, merge every process's
    pushed collapsed-stack table (+ the head's own), write --flame
    out.txt (collapsed) or out.svg (self-contained flamegraph)."""
    import time as _time

    from ray_tpu_torch._private import profiler as _profiler
    from ray_tpu_torch.util import state as state_api

    _init_maybe_attached(args)
    started = state_api.profile_start(hz=args.hz)
    _time.sleep(max(args.seconds, 0.1))
    state_api.profile_stop()
    # One ticker beat so the workers' final prof_push oneways land.
    _time.sleep(0.7)
    report = state_api.profile_report(node=args.node, pid=args.pid)
    samples = report.get("samples") or {}
    if args.flame:
        if args.flame.endswith(".svg"):
            body = _profiler.flamegraph_svg(
                samples, title=f"ray_tpu_torch profile ({args.seconds}s "
                f"@ {started.get('hz')}Hz)"
            )
        else:
            body = _profiler.folded_text(samples)
        with open(args.flame, "w") as f:
            f.write(body)
        print(f"wrote {args.flame}: {len(samples)} stacks")
    top = sorted(samples.items(), key=lambda kv: -kv[1])[: args.top]
    print(
        json.dumps(
            {
                "hz": started.get("hz"),
                "seconds": args.seconds,
                "total_samples": report.get("total_samples"),
                "pids": report.get("pids"),
                "processes": report.get("processes"),
                "top_stacks": [{"stack": s, "samples": n} for s, n in top],
            },
            indent=1,
            default=str,
        )
    )
    return 0


def cmd_tasks(args) -> int:
    """`ray_tpu_torch tasks`: per-task lifecycle attribution — stage-duration
    percentiles, accounted fraction, the --slow N slowest tasks with
    their per-stage breakdown + critical stage, and live tasks with the
    stage each is stuck in."""
    from ray_tpu_torch.util import state as state_api

    _init_maybe_attached(args)
    out = state_api.task_summary(slow=args.slow)
    if args.summary:
        out = {
            k: out[k]
            for k in (
                "tasks", "states", "stages", "wall_s_total",
                "accounted_s_total", "accounted_fraction",
            )
            if k in out
        }
    print(json.dumps(out, indent=1, default=str))
    return 0


def cmd_job_submit(args) -> int:
    from ray_tpu_torch.job_submission import JobSubmissionClient

    client = JobSubmissionClient()
    job_id = client.submit_job(entrypoint=" ".join(args.entrypoint))
    status = client.wait_until_finish(job_id, timeout=args.timeout)
    sys.stdout.write(client.get_job_logs(job_id))
    print(f"\njob {job_id}: {status}")
    return 0 if status == "SUCCEEDED" else 1


def cmd_logs(args) -> int:
    """Dump a worker's captured stdout/stderr lines (ray: `ray logs`).
    With --actor, resolve the named actor's current worker first; with
    --all, aggregate the tail across EVERY worker with node/pid line
    prefixes (attachable — reuses the head request plane)."""
    import ray_tpu_torch
    from ray_tpu_torch._private.worker_proc import get_worker_runtime

    ray_tpu_torch.init(
        ignore_reinit_error=True,
        address=args.address if getattr(args, "address", None) else None,
    )
    if args.all:
        wr = get_worker_runtime()
        if wr is not None:  # attached driver: ask the head
            per_worker = wr.request("get_logs_all", args.tail or None)
        else:
            from ray_tpu_torch._private.runtime import get_runtime

            per_worker = get_runtime().get_logs_all(args.tail or None)
        for wid in sorted(per_worker):
            rec = per_worker[wid]
            prefix = f"[{rec.get('node') or '?'}/{rec.get('pid') or wid}]"
            for line in rec["lines"]:
                sys.stdout.write(f"{prefix} {line}\n")
        return 0
    wid = args.worker
    if args.actor:
        from ray_tpu_torch._private.runtime import get_runtime

        wr = get_worker_runtime()
        if wr is not None:
            raise SystemExit("--actor lookup requires a head-local driver")
        rt = get_runtime()
        info = rt.state.get_named_actor(args.actor, rt.namespace)
        if info is None or not info.worker_id:
            raise SystemExit(f"no live worker for actor {args.actor!r}")
        wid = info.worker_id
    wr = get_worker_runtime()
    if wr is not None:  # attached driver: ask the head
        lines = wr.request("get_logs", (wid, args.tail))
    else:
        from ray_tpu_torch._private.runtime import get_runtime

        lines = get_runtime().get_logs(wid, args.tail)
    sys.stdout.write("\n".join(lines) + ("\n" if lines else ""))
    return 0


def _live_head_pid(session_dir: str):
    """pid from head.pid if it plausibly IS a live head.  Returns
    (pid, known): known=False when liveness can't be verified (no /proc,
    e.g. macOS) — callers must then treat the pid as possibly-live rather
    than stale."""
    try:
        with open(os.path.join(session_dir, "head.pid")) as f:
            pid = int(f.read().strip())
    except (OSError, ValueError):
        return None, True
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return None, True
    except PermissionError:
        pass  # alive, owned by someone else
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            is_head = b"ray_tpu_torch._private.head" in f.read()
        return (pid if is_head else None), True
    except OSError:
        # /proc unavailable: the pid is alive but unverifiable.
        return pid, False


def cmd_start(args) -> int:
    """`ray_tpu_torch start --head`: boot a standalone head process (ray: `ray
    start --head`).  Prints the head.json path + the ray:// address a
    remote driver passes to init()."""
    from ray_tpu_torch._private.head import launch_head_subprocess

    if not args.head:
        print(
            "only --head is supported here; on worker hosts launch "
            "`python -m ray_tpu_torch._private.node_daemon` pointed at the head "
            "(env RAY_TPU_DRIVER_HOST/PORT/AUTHKEY, RAY_TPU_NODE_CONFIG)",
            file=sys.stderr,
        )
        return 2
    session_dir = args.session_dir or os.path.join(
        "/tmp", f"raytpu-session-{os.getpid()}"
    )
    os.makedirs(session_dir, exist_ok=True)
    pid, _known = _live_head_pid(session_dir)
    if pid is not None:
        # Matching `ray start`'s already-running refusal: a second head
        # would overwrite head.pid/head.json and orphan the first.
        print(
            f"a head (pid {pid}) is already running for {session_dir}; "
            "run `ray_tpu_torch stop` first or pick another --session-dir",
            file=sys.stderr,
        )
        return 1
    proc, head_json = launch_head_subprocess(
        session_dir, num_cpus=args.num_cpus, session=args.session, detach=True
    )
    with open(head_json) as f:
        info = json.load(f)
    # Record the head pid so `ray_tpu_torch stop` can find it.
    with open(os.path.join(session_dir, "head.pid"), "w") as f:
        f.write(str(proc.pid))
    print(f"head started (pid {proc.pid})")
    print(f"  head.json: {head_json}")
    print(f"  attach:    ray_tpu_torch.init(address={head_json!r})")
    print(
        f"  remote:    ray_tpu_torch.init(address='ray://{info['host']}:"
        f"{info['port']}', _authkey={info['authkey']!r})"
    )
    return 0


def cmd_stop(args) -> int:
    """`ray_tpu_torch stop`: terminate the head started by `ray_tpu_torch start`."""
    import signal as _signal

    pid_file = os.path.join(args.session_dir, "head.pid")
    if not os.path.exists(pid_file):
        print(f"no head.pid under {args.session_dir}", file=sys.stderr)
        return 1
    # Stale-pid guard: after a crash/reboot the OS may have reused the pid
    # for an unrelated process — only SIGTERM on a POSITIVE head match;
    # when liveness can't be verified (no /proc) err toward killing the
    # recorded pid rather than stranding a live head.
    pid, known = _live_head_pid(args.session_dir)
    if pid is None:
        try:
            os.unlink(pid_file)
        except OSError:
            pass
        print("head already gone (stale head.pid removed)")
        return 0
    if not known:
        print(f"cannot verify pid {pid} is a head (no /proc); stopping it anyway")
    try:
        os.kill(pid, _signal.SIGTERM)
    except ProcessLookupError:
        pass
    try:
        os.unlink(pid_file)
    except OSError:
        pass
    print(f"sent SIGTERM to head pid {pid}")
    return 0


def cmd_bench(args) -> int:
    """The train benchmark on the card: chip_smoke.py's training phase
    (bench.py's head configuration through LMTrainContext, the kernels
    built first), which prints its `training` line."""
    import os
    import subprocess

    import ray_tpu_torch

    smoke = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(ray_tpu_torch.__file__))),
        "chip_smoke.py",
    )
    return subprocess.call([sys.executable, smoke, "--training"])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ray_tpu_torch", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    mb = sub.add_parser("microbenchmark", help="core runtime microbenchmarks")
    mb.add_argument("--json", help="write results to this file")
    mb.set_defaults(fn=cmd_microbenchmark)

    st = sub.add_parser("status", help="cluster nodes/resources/metrics")
    st.add_argument("--address", help="head.json path or ray:// URL (attached mode)")
    st.set_defaults(fn=cmd_status)

    me = sub.add_parser(
        "metrics", help="pushed-metrics plane: aggregate + per-process ages"
    )
    me.add_argument("--series", help="dump one aggregate's ring time series")
    me.add_argument("--address", help="head.json path or ray:// URL (attached mode)")
    me.set_defaults(fn=cmd_metrics)

    mm = sub.add_parser(
        "memory", help="cluster object ledger: bytes, holders, leak suspects"
    )
    mm.add_argument(
        "--group-by", choices=("node", "owner", "callsite"), default=None
    )
    mm.add_argument(
        "--leaks", action="store_true",
        help="only leak suspects, with holder node/pid attribution",
    )
    mm.add_argument("--top", type=int, default=20, help="top-N objects by size")
    mm.add_argument(
        "--events", action="store_true",
        help="include the recent object lifecycle event ring",
    )
    mm.add_argument("--address", help="head.json path or ray:// URL (attached mode)")
    mm.set_defaults(fn=cmd_memory)

    tl = sub.add_parser(
        "timeline", help="export the merged chrome-trace cluster timeline"
    )
    tl.add_argument("--output", "-o")
    tl.add_argument(
        "--last", type=float, default=None, metavar="SECONDS",
        help="only events from the trailing window (bounded export)",
    )
    tl.add_argument(
        "--since", type=float, default=None, metavar="TS",
        help="only events ending at/after this epoch timestamp",
    )
    tl.add_argument("--address", help="head.json path or ray:// URL (attached mode)")
    tl.set_defaults(fn=cmd_timeline)

    pf = sub.add_parser(
        "profile", help="cluster-wide sampling flamegraph (profiler.py)"
    )
    pf.add_argument(
        "--seconds", type=float, default=5.0, help="sampling window"
    )
    pf.add_argument(
        "--hz", type=float, default=None,
        help="sampling rate (default: profiler.DEFAULT_HZ)",
    )
    pf.add_argument("--node", help="filter the merge to one node id")
    pf.add_argument("--pid", type=int, help="filter the merge to one pid")
    pf.add_argument(
        "--flame", metavar="OUT",
        help="write the merged flamegraph: *.txt = collapsed stacks, "
        "*.svg = self-contained flamegraph",
    )
    pf.add_argument("--top", type=int, default=15, help="top stacks printed")
    pf.add_argument("--address", help="head.json path or ray:// URL (attached mode)")
    pf.set_defaults(fn=cmd_profile)

    tk = sub.add_parser(
        "tasks", help="per-task lifecycle attribution (stage durations)"
    )
    tk.add_argument(
        "--slow", type=int, default=10, help="N slowest tasks listed"
    )
    tk.add_argument(
        "--summary", action="store_true",
        help="aggregate stage stats only (no per-task rows)",
    )
    tk.add_argument("--address", help="head.json path or ray:// URL (attached mode)")
    tk.set_defaults(fn=cmd_tasks)

    js = sub.add_parser("job", help="submit a job and stream its logs")
    js.add_argument("entrypoint", nargs="+")
    js.add_argument("--timeout", type=float, default=3600.0)
    js.set_defaults(fn=cmd_job_submit)

    lg = sub.add_parser("logs", help="dump a worker's captured output")
    lg.add_argument("worker", nargs="?", help="worker id")
    lg.add_argument("--actor", help="named actor: dump its worker's logs")
    lg.add_argument(
        "--all", action="store_true",
        help="aggregate tail across every worker, node/pid-prefixed",
    )
    lg.add_argument("--tail", type=int, default=0, help="last N lines only")
    lg.add_argument("--address", help="head.json path (attached mode)")
    lg.set_defaults(fn=cmd_logs)

    be = sub.add_parser("bench", help="run the train benchmark (bench.py)")
    be.set_defaults(fn=cmd_bench)

    sta = sub.add_parser("start", help="start a standalone head process")
    sta.add_argument("--head", action="store_true")
    sta.add_argument("--num-cpus", type=int, default=4)
    sta.add_argument("--session-dir")
    sta.add_argument("--session")
    sta.set_defaults(fn=cmd_start)

    sto = sub.add_parser("stop", help="stop the head started by `start`")
    sto.add_argument("--session-dir", required=True)
    sto.set_defaults(fn=cmd_stop)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
