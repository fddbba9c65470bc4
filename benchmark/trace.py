"""The device trace of a window: torch.profiler (CUPTI) over the window,
exported as a Chrome trace and reduced here to what the per-layer readers
and the result's `breakdown` read.

- busy: the union of the intervals in which a kernel, copy or memset ran,
  so kernels that overlap are counted once; idle is the rest of the window.
- device_ops: device seconds by kernel name.
- idle_gaps: the gaps between busy intervals, summed by what the host was
  doing: the innermost host op that launched the kernel ending the gap.
- marked: each launch of a kernel whose name holds one of `markers`, with
  its device seconds and the innermost enclosing host op whose name starts
  with one of `scopes` (the batch that ran it, the autograd node).
- scoped_s: device seconds of all kernels launched inside a host op whose
  name starts with each of `scopes`.
- by_span, given the program's spans of the window: per span name, host,
  device and idle seconds on the trace's clock (`spans.SpanTrace.by_span`).
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation")
TOP = 10


class Capture:
    """torch.profiler over [start(), stop()]: CPU ops of every thread (where
    this torch can) and, on the card, the device's activity."""

    def __init__(self, markers: Sequence[str] = (), scopes: Sequence[str] = (),
                 on_card: bool = True):
        self.markers, self.scopes, self.on_card = tuple(markers), tuple(scopes), on_card
        self.prof = None

    def _sync(self) -> None:
        import torch

        if self.on_card:
            torch.cuda.synchronize()

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        kw = {}
        try:
            from torch._C._profiler import _ExperimentalConfig

            kw["experimental_config"] = _ExperimentalConfig(profile_all_threads=True)
        except (ImportError, TypeError):
            pass  # a torch without it records the starting thread's host ops only
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.on_card else [])
        self._sync()
        self.prof = profile(activities=acts, **kw)
        self.prof.start()
        self.t0 = time.perf_counter()

    def finish(self) -> Tuple[List[dict], float, float]:
        """Stop: the Chrome trace's events, its clock base in microseconds
        (`baseTimeNanoseconds` / 1e3: an event's `ts` plus the base is the
        epoch time that `time.time()` gives) and the window's seconds."""
        self._sync()
        window_s = time.perf_counter() - self.t0
        self.prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)
        finally:
            os.unlink(path)
        self.prof = None
        return trace["traceEvents"], trace["baseTimeNanoseconds"] / 1e3, window_s

    def stop(self, spans: Optional[List[dict]] = None) -> Dict:
        """Stop and reduce (`summarize`), with the program's `spans` of the
        window where given."""
        events, base_us, window_s = self.finish()
        return summarize(events, window_s, self.markers, self.scopes, spans, base_us)


def _union(intervals: List[tuple]) -> List[list]:
    merged: List[list] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


class _HostOps:
    """One thread's host ops, sorted by start, for "which op holds time t"."""

    def __init__(self, ops: List[tuple]):
        self.ops = sorted(ops)
        self.starts = [o[0] for o in self.ops]

    def innermost(self, t: float, prefixes: Optional[Sequence[str]] = None,
                  reach: int = 400) -> Optional[str]:
        i = bisect.bisect_right(self.starts, t) - 1
        best = None
        for j in range(i, max(i - reach, -1), -1):
            a, b, name = self.ops[j]
            if b >= t and (prefixes is None or name.startswith(tuple(prefixes))):
                if best is None or a > best[0]:
                    best = (a, name)
                if prefixes is None:
                    break  # the latest-starting op that holds t is the innermost
        return None if best is None else best[1]


def summarize(events: List[dict], window_s: float, markers: Sequence[str] = (),
              scopes: Sequence[str] = (), spans: Optional[List[dict]] = None,
              base_us: float = 0.0) -> Dict:
    device, launches, host = [], {}, defaultdict(list)
    for e in events:
        cat = e.get("cat")
        if e.get("ph") != "X" or "dur" not in e:
            continue
        if cat in DEVICE_CATS:
            device.append((float(e["ts"]), float(e["dur"]), e.get("name", ""),
                           (e.get("args") or {}).get("correlation")))
        elif cat in LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = (e.get("tid"), float(e["ts"]))
        elif cat in HOST_CATS:
            host[e.get("tid")].append((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                                       e.get("name", "")))
    threads = {tid: _HostOps(ops) for tid, ops in host.items()}

    def host_op(corr, prefixes=None):
        where = launches.get(corr)
        if where is None or where[0] not in threads:
            return None
        return threads[where[0]].innermost(where[1], prefixes)

    busy = _union([(ts, ts + dur) for ts, dur, _, _ in device])
    busy_us = sum(b - a for a, b in busy)
    by_name: Dict[str, float] = defaultdict(float)
    for _, dur, name, _ in device:
        by_name[name] += dur
    starts = sorted((ts, corr) for ts, _, _, corr in device)
    start_ts = [s[0] for s in starts]
    gaps: Dict[str, float] = defaultdict(float)
    for (_, end), (nxt, _) in zip(busy, busy[1:]):
        i = bisect.bisect_left(start_ts, nxt)
        label = host_op(starts[i][1]) if i < len(starts) else None
        gaps[label or "no host op recorded"] += nxt - end
    marked, scoped = [], defaultdict(float)
    for ts, dur, name, corr in device:
        scope = host_op(corr, scopes) if scopes else None
        if scope is not None:
            scoped[next(p for p in scopes if scope.startswith(p))] += dur / 1e6
        for mk in markers:
            if mk in name:
                marked.append({"marker": mk, "s": dur / 1e6, "scope": scope})
    top = lambda d: [[k[:160], v / 1e6] for k, v in  # noqa: E731
                     sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    out = {
        "window_s": window_s,
        "busy_s": busy_us / 1e6,
        "kernels": len(device),
        "device_ops": top(by_name),
        "idle_gaps": top(gaps),
        "marked": marked,
        "scoped_s": dict(scoped),
    }
    if spans is not None:
        from benchmark.spans import SpanTrace

        out["by_span"] = SpanTrace(events, spans, base_us).by_span()
    return out
