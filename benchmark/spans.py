"""The program's spans on the device trace's clock: a training cell's steps
traced by torch.profiler while the spans of `ray_tpu_torch.util.tracing` are
on, each kernel, copy and memset credited to the innermost span that was
open when the host launched it.

    python3 -m benchmark.spans --workload <cell> --seed <n>

builds the cell as its kind does (`kinds/train.py`: the seed's weights, the
checked steps), runs WARM more steps, traces STEPS, and prints one JSON
line:

- `per_step`: for each span name, a step's host seconds (`host_s`, and
  `host_self_s` without its child spans), device seconds (`device_s`:
  kernels launched while it was the innermost open span, on any thread, so
  autograd's device thread counts for `lm::backward`) and idle seconds
  (`idle_s`: the gaps whose ending kernel it launched); `(no span)` holds
  what was launched outside every span, by kernel name too;
- `stacked_grad_kernels`: device seconds a step by kernel name of what the
  autograd nodes `SelectBackward0` (a layer's slice `v[i]` of a stacked
  leaf) launched inside `lm::backward`;
- `loads`: each CUDA library's load record (`ops/cuda/_build.py`);
- `metrics`: forward_ms, backward_ms, stacked_grad_ms (device ms a step),
  optimizer_roofline (%, `adamw_least_bytes` at the card's peak bandwidth
  over the device time of `lm::grad_norm` and `lm::optimizer`) and
  setup_first_step_s (the process's first `lm::train_step`, less the nvcc
  seconds of the libraries it loaded; `first_step` splits it by phase,
  and `setup_steps_s` gives each checked step's host seconds).

The clock: the Chrome trace that torch.profiler exports carries
`baseTimeNanoseconds`; an event's `ts` plus that base, in microseconds, is
the epoch time that `time.time()` gives, which the spans record.
"""

from __future__ import annotations

import bisect
import gc
import json
import os
import sys
import tempfile
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from benchmark import counts
from benchmark.trace import DEVICE_CATS, HOST_CATS, LAUNCH_CATS, TOP, _HostOps, _union

OUTSIDE = "(no span)"
STEP = "lm::train_step"
# Steps run after set-up's checked ones, then steps traced: a pair, as the
# benchmark's `--trace 1` runs trace.
WARM, STEPS = 3, 2
# The autograd node of a layer's slice `v[i]` of a stacked [L, ...] leaf: its
# backward writes a full-size zero gradient with the slice in it, which the
# engine adds into the leaf's gradient.
SELECT_SCOPE = "autograd::engine::evaluate_function: SelectBackward0"


def adamw_least_bytes(n_params: int) -> int:
    """Least bytes that the step moves after the backward on f32 parameters,
    gradients and moments: the global norm reads g once; clip and AdamW read
    g, p, mu and nu and write p, mu and nu. 8 x 4 bytes a parameter."""
    return 32 * n_params


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

    def kernels(self, span: str, scope: Optional[str] = None) -> Dict[str, float]:
        """Device seconds by kernel name of what was launched in `span`
        (OUTSIDE: in none), and, given `scope`, from inside a host op whose
        name starts with it on the launching thread."""
        out: Dict[str, float] = defaultdict(float)
        for _, dur, name, corr in self.device:
            if self.launched_in(corr) != span:
                continue
            if scope is not None:
                tid, t = self.launches.get(corr, (None, 0.0))
                if tid not in self.threads or self.threads[tid].innermost(t, (scope,)) is None:
                    continue
            out[name] += dur / 1e6
        return dict(out)


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


def step_metrics(per_step: Dict[str, Dict[str, float]], stacked_s: float, n_params: int,
                 peak_bytes: Optional[float], first_s: Optional[float]) -> Dict[str, float]:
    """The five numbers from a step's device seconds by span (`per_step`),
    the SelectBackward0 kernels' seconds a step, the parameter count, the
    card's peak bytes/s (None: no roofline) and the first step's seconds."""
    dev = lambda name: per_step.get(name, {}).get("device_s", 0.0)  # noqa: E731
    out = {}
    if STEP in per_step:
        out["forward_ms"] = 1e3 * (dev("lm::forward") + dev("lm::loss"))
        out["backward_ms"] = 1e3 * dev("lm::backward")
        out["stacked_grad_ms"] = 1e3 * stacked_s
        opt_s = dev("lm::grad_norm") + dev("lm::optimizer")
        if peak_bytes and opt_s:
            out["optimizer_roofline"] = 100.0 * adamw_least_bytes(n_params) / peak_bytes / opt_s
    if first_s is not None:
        out["setup_first_step_s"] = first_s
    return out


def profile(run: Callable[[], None], on_card: bool) -> Tuple[List[dict], float, float]:
    """`run()` under torch.profiler (host ops of every thread, as
    `trace.Capture` records them, and the card's activity): the Chrome
    trace's events, its clock base in microseconds and the window's
    seconds, `run()` ending in a synchronise."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    kw = {}
    try:
        from torch._C._profiler import _ExperimentalConfig

        kw["experimental_config"] = _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        pass
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    sync()
    with torch_profile(activities=acts, **kw) as prof:
        t0 = time.perf_counter()
        run()
        sync()
        window_s = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.unlink(path)
    return trace["traceEvents"], trace["baseTimeNanoseconds"] / 1e3, window_s


def measure(cell: dict, m: dict, seed: int, steps: int = STEPS, warm: int = WARM,
            device: str = "cuda") -> dict:
    """Build the cell with the spans on, run `warm` steps, trace `steps`."""
    import torch

    from benchmark import inputs, manifest
    from benchmark.trace import summarize
    from ray_tpu_torch.ops.cuda import _build
    from ray_tpu_torch.parallel.sharding import tree_leaves
    from ray_tpu_torch.util import tracing

    kind = manifest.kind(cell["kind"])
    on_card = device == "cuda"
    b, s = cell["traffic"]["batch"], cell["traffic"]["seq"]
    tracing.drain_spans()
    tracing.enable_tracing()
    try:
        ctx, state, _ = kind.build(cell, m, seed, device)
        setup = tracing.drain_spans()
        first = first_step(setup, _build.loads)
        setup_steps_s = [r["end"] - r["start"] for r in sorted(setup, key=lambda r: r["start"])
                         if r["name"] == STEP]
        step = cell["check"]["steps"]

        def advance(n):
            nonlocal state, step
            for _ in range(n):
                state, _ = ctx.train_step(state, inputs.train_batch(m, seed, step, b, s, device))
                step += 1

        advance(warm)
        if on_card:
            torch.cuda.synchronize()
        gc.collect()
        tracing.drain_spans()
        events, base_us, window_s = profile(lambda: advance(steps), on_card)
        spans = tracing.drain_spans()
    finally:
        tracing.disable_tracing()
    n_params = sum(p.numel() for p in tree_leaves(state["params"]))
    name = torch.cuda.get_device_name() if on_card else "cpu"
    del state, ctx
    st = SpanTrace(events, spans, base_us)
    per_step = {k: {f: (v / steps if f != "n" else v) for f, v in row.items()}
                for k, row in st.by_span().items()}
    stacked = {k: v / steps for k, v in st.kernels("lm::backward", SELECT_SCOPE).items()}
    outside = sorted(st.kernels(OUTSIDE).items(), key=lambda kv: -kv[1])[:TOP]
    summary = summarize(events, window_s)
    lm = sum(row["device_s"] for k, row in per_step.items() if k.startswith("lm::"))
    return {
        "device": name, "steps": steps, "window_s": window_s, "busy_s": summary["busy_s"],
        "idle_share": 1.0 - summary["busy_s"] / window_s if summary["kernels"] else None,
        "covered_share": lm * steps / summary["busy_s"] if summary["busy_s"] else None,
        "per_step": per_step, "outside_kernels": [[k[:160], v / steps] for k, v in outside],
        "stacked_grad_kernels": stacked, "loads": dict(_build.loads),
        "nvcc_builds": sum(1 for r in _build.loads.values() if r["built"]),
        "metrics": step_metrics(per_step, sum(stacked.values()), n_params,
                                counts.peak(name)["bytes"] if on_card else None,
                                first and first["s"]),
        "first_step": first, "setup_steps_s": setup_steps_s,
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    from benchmark import manifest, run

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    run.hygiene()
    bench = manifest.manifest()
    cell = manifest.workload(args.workload, bench)
    import torch

    if not torch.cuda.is_available():
        print("spans.py: needs a CUDA card", file=sys.stderr)
        return 3
    out = measure(cell, manifest.config(cell["config"]), args.seed)
    print(json.dumps({"workload": args.workload, "seed": args.seed, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
