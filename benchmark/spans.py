"""The program's spans on the device trace's clock, and the per-layer
metrics read from them: a training cell's traced steps run while the spans
of `ray_tpu_torch.util.tracing` are on (`kinds/train.py`), and each kernel,
copy and memset is credited to the innermost span that was open when the
host launched it.

The clock: the Chrome trace that torch.profiler exports carries
`baseTimeNanoseconds`; an event's `ts` plus that base, in microseconds, is
the epoch time that `time.time()` gives, which the spans record.

A run's `context` holds what is read here: the traced steps' `by_span`
(`trace.summarize`), the set-up's spans, the kernel loader's records
(`ops/cuda/_build.loads`) and the traced steps' `counters`
(`counter_deltas` of `ray_tpu_torch.util.metrics.collect()`).
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional

from benchmark import counts
from benchmark.trace import DEVICE_CATS, HOST_CATS, LAUNCH_CATS, _HostOps, _union

OUTSIDE = "(no span)"
STEP = "lm::train_step"


class SpanTrace:
    """A Chrome trace's events with the spans of the process that made it
    (`spans` as `tracing.drain_spans()` gives them, on one thread's
    nesting), on the trace's clock (`base_us`, `baseTimeNanoseconds` / 1e3)."""

    def __init__(self, events: List[dict], spans: List[dict], base_us: float):
        self.device, self.launches, host = [], {}, defaultdict(list)
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat, corr = e.get("cat"), (e.get("args") or {}).get("correlation")
            if cat in DEVICE_CATS:
                self.device.append((float(e["ts"]), float(e["dur"]), e.get("name", ""), corr))
            elif cat in LAUNCH_CATS and corr is not None:
                self.launches[corr] = (e.get("tid"), float(e["ts"]))
            elif cat in HOST_CATS:
                host[e.get("tid")].append((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                                           e.get("name", "")))
        self.device.sort()
        self.threads = {tid: _HostOps(ops) for tid, ops in host.items()}
        self.spans = sorted((s["start"] * 1e6 - base_us, s["end"] * 1e6 - base_us, s["name"])
                            for s in spans)
        self.starts = [s[0] for s in self.spans]
        self.records = spans

    def span_at(self, t: float) -> Optional[str]:
        """The innermost span open at trace time `t`: of those that hold
        it, the one that started last."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0:
            if self.spans[i][1] >= t:
                return self.spans[i][2]
            i -= 1
        return None

    def launched_in(self, corr) -> str:
        where = self.launches.get(corr)
        return (self.span_at(where[1]) if where else None) or OUTSIDE

    def by_span(self) -> Dict[str, Dict[str, float]]:
        """Per span name: how many, host seconds in all and without child
        spans, device seconds launched in it, idle seconds before a kernel
        it launched (gaps between busy intervals, as `trace.summarize`
        labels them by host op)."""
        out: Dict[str, Dict[str, float]] = defaultdict(
            lambda: {"n": 0, "host_s": 0.0, "host_self_s": 0.0, "device_s": 0.0, "idle_s": 0.0})
        children: Dict[str, float] = defaultdict(float)
        for s in self.records:
            children[s.get("parent_span_id")] += s["end"] - s["start"]
        for s in self.records:
            row = out[s["name"]]
            row["n"] += 1
            row["host_s"] += s["end"] - s["start"]
            row["host_self_s"] += s["end"] - s["start"] - children.get(s["span_id"], 0.0)
        for _, dur, _, corr in self.device:
            out[self.launched_in(corr)]["device_s"] += dur / 1e6
        busy = _union([(ts, ts + dur) for ts, dur, _, _ in self.device])
        starts = [d[0] for d in self.device]
        for (_, end), (nxt, _) in zip(busy, busy[1:]):
            i = bisect.bisect_left(starts, nxt)
            out[self.launched_in(self.device[i][3])]["idle_s"] += (nxt - end) / 1e6
        return {k: dict(v) for k, v in out.items()}


def first_step(spans: List[dict], loads: Dict[str, dict]) -> Optional[Dict]:
    """The first `lm::train_step` in `spans`: its host seconds (`host_s`),
    the nvcc seconds (`loads`, by library) of the `cuda::load_library`
    spans inside it (`nvcc_s`), the first less the second (`s`), and the
    host seconds of each of its phases (`phases`, nvcc included)."""
    steps = [s for s in spans if s["name"] == STEP]
    if not steps:
        return None
    first = min(steps, key=lambda s: s["start"])
    nvcc = sum(loads[s["attrs"]["name"]]["compile_s"] for s in spans
               if s["name"] == "cuda::load_library" and s["attrs"].get("name") in loads
               and first["start"] <= s["start"] and s["end"] <= first["end"])
    host = first["end"] - first["start"]
    return {"s": host - nvcc, "host_s": host, "nvcc_s": nvcc,
            "phases": {s["name"]: s["end"] - s["start"] for s in spans
                       if s.get("parent_span_id") == first["span_id"]}}


def step_metrics(per_step: Dict[str, Dict[str, float]], n_params: int,
                 peak_bytes: Optional[float], first_s: Optional[float]) -> Dict[str, float]:
    """The four numbers from a step's device seconds by span (`per_step`),
    the trained parameter count, the card's peak bytes/s (None: no
    roofline) and the first step's seconds less its compiles."""
    dev = lambda name: per_step.get(name, {}).get("device_s", 0.0)  # noqa: E731
    out = {}
    if STEP in per_step:
        out["forward_ms"] = 1e3 * (dev("lm::forward") + dev("lm::loss"))
        out["backward_ms"] = 1e3 * dev("lm::backward")
        opt_s = dev("lm::grad_norm") + dev("lm::optimizer")
        if peak_bytes and opt_s:
            least_s = counts.adamw_least_bytes(n_params) / peak_bytes
            out["optimizer_roofline"] = 100.0 * least_s / opt_s
    if first_s is not None:
        out["setup_first_step_s"] = first_s
    return out


def per_step(ctx: dict) -> Dict[str, Dict[str, float]]:
    """The traced steps' `by_span`, each sum over the steps taken a step."""
    by = (ctx.get("trace") or {}).get("by_span") or {}
    n = ctx["traced_steps"]
    return {k: {f: (v if f == "n" else v / n) for f, v in row.items()} for k, row in by.items()}


def context_metrics(ctx: dict) -> Dict[str, float]:
    """`step_metrics` of a training run's context: what it finds. The
    device numbers only from a trace that holds device activity."""
    if ctx.get("kind") != "train":
        return {}
    first = first_step(ctx["spans"]["setup"], ctx["loads"])
    on_device = bool((ctx.get("trace") or {}).get("kernels"))
    peak_bytes = counts.peak(ctx["device"])["bytes"] if on_device else None
    return step_metrics(per_step(ctx) if on_device else {}, ctx["n_params"], peak_bytes,
                        first and first["s"])


def counter_deltas(before: Dict[str, Dict], after: Dict[str, Dict]) -> Dict[str, object]:
    """What the program's metrics did between two `collect()` snapshots, by
    series (`name`, or `name{tag=value,...}`): a counter's increase, a
    histogram's count and sum increases, a gauge's new value. A series that
    did not change is left out."""
    out: Dict[str, object] = {}
    for name, rec in after.items():
        old = before.get(name, {}).get("data", {})
        for tags, value in rec["data"].items():
            key = name + ("{" + ",".join(f"{k}={v}" for k, v in tags) + "}" if tags else "")
            if rec["type"] == "Histogram":
                was = old.get(tags, {"count": 0, "sum": 0.0})
                if value["count"] != was["count"]:
                    out[key] = {"count": value["count"] - was["count"],
                                "sum": value["sum"] - was["sum"]}
            elif rec["type"] == "Gauge":
                if old.get(tags) != value:
                    out[key] = value
            elif value != old.get(tags, 0.0):
                out[key] = value - old.get(tags, 0.0)
    return out
