"""The program's spans on the device trace's clock (`benchmark/spans.py`)
and the traced pair's plumbing, on the CPU: a kernel is credited to the
span open at its launch, from any thread; idle gaps are labelled by span;
`trace.summarize` and `trace.Capture.stop` add `by_span` on the trace's
clock when given spans; the four numbers come from a hand-made step; the
program's counters are read as deltas; and a tiny cell's traced run puts
each aten op in its phase's span and its readers find their numbers."""

import json
import time

import pytest
import torch

from benchmark import manifest, run, tiny
from benchmark import spans as bspans
from benchmark import trace as btrace
from ray_tpu_torch.models import LMTrainContext, TransformerConfig
from ray_tpu_torch.util import tracing

PHASES = ["lm::forward", "lm::loss", "lm::backward", "lm::grad_norm", "lm::optimizer"]
CELL = "internlm2-1.8b.train-4k"
READERS = ["forward_ms.train", "backward_ms.train", "optimizer_roofline.train",
           "setup_first_step_s.train"]


def test_the_capture_puts_each_op_in_its_phase():
    ctx = LMTrainContext(TransformerConfig.tiny(), device="cpu")
    state = ctx.init_state(0)
    tokens = torch.randint(0, 256, (2, 17), generator=torch.Generator().manual_seed(0))
    batch = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}
    state, _ = ctx.train_step(state, batch)  # warm
    tracing.drain_spans()
    cap = btrace.Capture(on_card=False)
    tracing.enable_tracing()
    try:
        cap.start()
        ctx.train_step(state, batch)
        events, base_us, _ = cap.finish()
        recs = tracing.drain_spans()
    finally:
        tracing.disable_tracing()
    st = bspans.SpanTrace(events, recs, base_us)
    where = {"aten::log_softmax": "lm::loss", "aten::_foreach_norm": "lm::grad_norm",
             "aten::_foreach_addcmul_": "lm::optimizer", "aten::index": "lm::forward",
             "aten::select_backward": "lm::backward"}
    for name, phase in where.items():
        found = [st.span_at(e["ts"] + e["dur"] / 2) for e in events
                 if e.get("ph") == "X" and e.get("name") == name]
        assert found and set(found) == {phase}, (name, found)
    by = st.by_span()
    assert {k: v["n"] for k, v in by.items()} == {"lm::train_step": 1, **dict.fromkeys(PHASES, 1)}


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


BASE_US = 1.7e15  # the trace's clock base: spans hold epoch seconds


def _span(name, start_us, end_us, sid, parent=None):
    return {"name": name, "start": (BASE_US + start_us) / 1e6, "end": (BASE_US + end_us) / 1e6,
            "span_id": sid, "parent_span_id": parent, "attrs": {}}


SPANS = [_span("lm::train_step", 0, 200, "r"), _span("lm::forward", 10, 50, "f", "r"),
         _span("lm::backward", 60, 150, "b", "r"), _span("lm::optimizer", 160, 190, "o", "r")]
EVENTS = [
    _x("cuda_runtime", "cudaLaunchKernel", 20, 2, corr=1),  # in lm::forward
    _x("cpu_op", "autograd::engine::evaluate_function: SelectBackward0", 70, 20, tid=2),
    _x("cuda_runtime", "cudaLaunchKernel", 75, 2, tid=2, corr=2),  # autograd's thread
    _x("cuda_runtime", "cudaLaunchKernel", 100, 2, tid=2, corr=3),
    _x("cuda_runtime", "cudaLaunchKernel", 170, 2, corr=4),  # in lm::optimizer
    _x("cuda_runtime", "cudaLaunchKernel", 210, 2, corr=5),  # after the step
    _x("kernel", "gemm", 30, 40, tid=7, corr=1),
    _x("kernel", "fill", 80, 10, tid=7, corr=2),  # after 10 us idle
    _x("kernel", "add", 110, 20, tid=7, corr=3),
    _x("kernel", "adam", 175, 10, tid=7, corr=4),
    _x("kernel", "randint", 215, 5, tid=7, corr=5),
]


def test_a_kernel_is_credited_to_the_span_open_at_its_launch():
    st = bspans.SpanTrace(EVENTS, SPANS, BASE_US)
    by = st.by_span()
    assert by["lm::forward"]["device_s"] == pytest.approx(40e-6)
    assert by["lm::backward"]["device_s"] == pytest.approx(30e-6)  # launched on thread 2
    assert by["lm::optimizer"]["device_s"] == pytest.approx(10e-6)
    assert by[bspans.OUTSIDE]["device_s"] == pytest.approx(5e-6)
    # Gaps [70, 80] and [90, 110] end in backward's kernels, [130, 175] in
    # the optimizer's, [185, 215] in the batch draw outside every span.
    assert by["lm::backward"]["idle_s"] == pytest.approx(30e-6)
    assert by["lm::optimizer"]["idle_s"] == pytest.approx(45e-6)
    assert by[bspans.OUTSIDE]["idle_s"] == pytest.approx(30e-6)
    # Host seconds come from epoch times: to a microsecond.
    assert by["lm::train_step"] == {"n": 1, "host_s": pytest.approx(200e-6, abs=1e-6),
                                    "host_self_s": pytest.approx(40e-6, abs=1e-6),
                                    "device_s": 0.0, "idle_s": 0.0}


def test_the_four_numbers_of_a_hand_made_step():
    per_step = {"lm::train_step": {"device_s": 0.0}, "lm::forward": {"device_s": 0.15},
                "lm::loss": {"device_s": 0.03}, "lm::backward": {"device_s": 0.6},
                "lm::grad_norm": {"device_s": 0.01}, "lm::optimizer": {"device_s": 0.05}}
    n = 1_889_110_016
    got = bspans.step_metrics(per_step, n, 3.35e12, 4.5)
    assert got == pytest.approx({
        "forward_ms": 180.0, "backward_ms": 600.0,
        "optimizer_roofline": 100 * 32 * n / 3.35e12 / 0.06, "setup_first_step_s": 4.5})
    assert bspans.step_metrics({}, n, 3.35e12, None) == {}
    assert "optimizer_roofline" not in bspans.step_metrics(per_step, n, None, None)


def test_the_first_step_less_its_compiles():
    recs = [_span("lm::train_step", 0, 9e6, "a"), _span("lm::forward", 0.5e6, 5.5e6, "f", "a"),
            {**_span("cuda::load_library", 1e6, 5e6, "l", "f"), "attrs": {"name": "fwd"}},
            {**_span("cuda::load_library", 6e6, 7e6, "m", "a"), "attrs": {"name": "bwd"}},
            _span("lm::train_step", 10e6, 11e6, "b")]
    loads = {"fwd": {"compile_s": 3.5}, "bwd": {"compile_s": 0.0}}
    first = bspans.first_step(recs, loads)
    phases = first.pop("phases")
    assert first == pytest.approx({"s": 9.0 - 3.5, "host_s": 9.0, "nvcc_s": 3.5})
    assert phases == pytest.approx({"lm::forward": 5.0, "cuda::load_library": 1.0})
    assert bspans.first_step([], loads) is None


def test_summarize_adds_by_span_only_given_spans():
    plain = btrace.summarize(EVENTS, 220e-6)
    assert set(plain) == {"window_s", "busy_s", "kernels", "device_ops", "idle_gaps", "marked",
                          "scoped_s"}
    with_spans = btrace.summarize(EVENTS, 220e-6, spans=SPANS, base_us=BASE_US)
    assert {k: v for k, v in with_spans.items() if k != "by_span"} == plain
    assert with_spans["by_span"] == bspans.SpanTrace(EVENTS, SPANS, BASE_US).by_span()
    assert with_spans["by_span"]["lm::forward"]["device_s"] == pytest.approx(40e-6)


class _StandInProfiler:
    """What `Capture` uses of torch.profiler: stop and a Chrome trace."""

    def stop(self):
        pass

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": EVENTS, "baseTimeNanoseconds": int(BASE_US * 1e3)}, f)


def test_capture_keeps_the_trace_s_clock():
    cap = btrace.Capture(on_card=False)
    cap.prof, cap.t0 = _StandInProfiler(), time.perf_counter()
    out = cap.stop(SPANS)
    assert out["by_span"]["lm::backward"]["device_s"] == pytest.approx(30e-6)
    assert out["by_span"]["lm::optimizer"]["idle_s"] == pytest.approx(45e-6)
    cap.prof, cap.t0 = _StandInProfiler(), time.perf_counter()
    assert "by_span" not in cap.stop()


def test_counter_deltas():
    before = {"steps": {"type": "Counter", "data": {(): 2.0, (("kind", "a"),): 1.0}},
              "lat": {"type": "Histogram", "data": {(): {"buckets": [1], "sum": 0.5, "count": 1}}},
              "depth": {"type": "Gauge", "data": {(): 3.0}},
              "idle": {"type": "Counter", "data": {(): 7.0}}}
    after = {"steps": {"type": "Counter", "data": {(): 4.0, (("kind", "a"),): 1.5}},
             "lat": {"type": "Histogram", "data": {(): {"buckets": [3], "sum": 1.25, "count": 3}}},
             "depth": {"type": "Gauge", "data": {(): 5.0}},
             "idle": {"type": "Counter", "data": {(): 7.0}},
             "new": {"type": "Counter", "data": {(): 1.0}}}
    assert bspans.counter_deltas(before, after) == {
        "steps": 2.0, "steps{kind=a}": 0.5, "lat": {"count": 2, "sum": 0.75}, "depth": 5.0,
        "new": 1.0}


def test_readers_on_a_hand_made_context():
    step = {"n": 2, "host_s": 0.0, "host_self_s": 0.0, "idle_s": 0.0}
    by = {"lm::train_step": dict(step, device_s=0.0), "lm::forward": dict(step, device_s=0.3),
          "lm::loss": dict(step, device_s=0.04), "lm::backward": dict(step, device_s=0.9),
          "lm::grad_norm": dict(step, device_s=0.02), "lm::optimizer": dict(step, device_s=0.14)}
    setup = [_span("lm::train_step", 0, 9e6, "a"),
             {**_span("cuda::load_library", 1e6, 5e6, "l", "a"), "attrs": {"name": "fwd"}}]
    ctx = {"kind": "train", "device": "NVIDIA H100 80GB HBM3", "n_params": 10**9,
           "traced_steps": 2, "trace": {"kernels": 5, "by_span": by},
           "spans": {"setup": setup, "traced": []},
           "loads": {"fwd": {"compile_s": 3.0, "built": True}}, "counters": {}}
    got = {name: manifest.reader(name).read(ctx) for name in READERS}
    assert got == pytest.approx({
        "forward_ms.train": 170.0, "backward_ms.train": 450.0,
        "optimizer_roofline.train": 100 * 32e9 / 3.35e12 / 0.08,
        "setup_first_step_s.train": 6.0})
    # A trace with no device activity (the CPU's) gives no device numbers.
    cpu = dict(ctx, device="cpu", trace={"kernels": 0, "by_span": by})
    assert {name: manifest.reader(name).read(cpu) for name in READERS} == {
        "forward_ms.train": None, "backward_ms.train": None, "optimizer_roofline.train": None,
        "setup_first_step_s.train": pytest.approx(6.0)}
    assert manifest.reader("forward_ms.train").read({"kind": "serve"}) is None


def test_a_traced_run_reads_the_spans_on_the_cpu():
    """kinds/train.run with `trace`: set-up's and the traced pair's spans
    reach `context` and `readings`; tracing is off again afterwards."""
    cell = tiny.cell(CELL)
    out = manifest.kind("train").run(cell, tiny.model(), 2**31 + 7, 0.2, True,
                                     time.perf_counter(), device="cpu")
    readings, ctx = out["readings"], out["context"]
    assert not tracing.is_enabled()
    assert readings["loads"] == {} and readings["nvcc_builds"] == 0
    per_step = readings["spans_a_traced_step"]
    assert set(per_step) == {"lm::train_step", *PHASES}
    assert all(row["n"] == 2 for row in per_step.values())
    first = readings["first_step"]
    assert list(first["phases"]) == PHASES and first["s"] == first["host_s"] > 0.0
    assert bspans.context_metrics(ctx) == {"setup_first_step_s": first["s"]}
    steps = [r for r in ctx["spans"]["setup"] if r["name"] == bspans.STEP]
    assert len(steps) == cell["check"]["steps"]
    assert sum(r["name"] == bspans.STEP for r in ctx["spans"]["traced"]) == 2
    assert json.loads(json.dumps(run._plain(readings))) == run._plain(readings)
