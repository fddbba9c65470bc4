"""The tool that lays the program's spans on the device trace's clock
(`benchmark/spans.py`), on the CPU: a kernel is credited to the span open
at its launch, from any thread; idle gaps are labelled by span; the five
numbers come from a hand-made step; and the tool measures a tiny cell,
its own profile putting each aten op in its phase's span."""

import json

import pytest
import torch

from benchmark import spans as bspans
from benchmark import tiny
from ray_tpu_torch.models import LMTrainContext, TransformerConfig
from ray_tpu_torch.util import tracing

PHASES = ["lm::forward", "lm::loss", "lm::backward", "lm::grad_norm", "lm::optimizer"]


def test_the_tool_s_profile_puts_each_op_in_its_phase():
    ctx = LMTrainContext(TransformerConfig.tiny(), device="cpu")
    state = ctx.init_state(0)
    tokens = torch.randint(0, 256, (2, 17), generator=torch.Generator().manual_seed(0))
    batch = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}
    state, _ = ctx.train_step(state, batch)  # warm
    tracing.drain_spans()
    tracing.enable_tracing()
    try:
        events, base_us, _ = bspans.profile(lambda: ctx.train_step(state, batch), on_card=False)
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
    assert st.kernels("lm::backward", bspans.SELECT_SCOPE) == {"fill": pytest.approx(10e-6)}
    assert st.kernels(bspans.OUTSIDE) == {"randint": pytest.approx(5e-6)}


def test_the_five_numbers_of_a_hand_made_step():
    per_step = {"lm::train_step": {"device_s": 0.0}, "lm::forward": {"device_s": 0.15},
                "lm::loss": {"device_s": 0.03}, "lm::backward": {"device_s": 0.6},
                "lm::grad_norm": {"device_s": 0.01}, "lm::optimizer": {"device_s": 0.05}}
    n = 1_889_110_016
    got = bspans.step_metrics(per_step, 0.2, n, 3.35e12, 4.5)
    assert got == pytest.approx({
        "forward_ms": 180.0, "backward_ms": 600.0, "stacked_grad_ms": 200.0,
        "optimizer_roofline": 100 * 32 * n / 3.35e12 / 0.06, "setup_first_step_s": 4.5})
    assert bspans.step_metrics({}, 0.0, n, 3.35e12, None) == {}
    assert "optimizer_roofline" not in bspans.step_metrics(per_step, 0.2, n, None, None)


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


def test_adamw_least_bytes_by_hand():
    # |g| once for the norm; g, p, mu, nu read and p, mu, nu written: 8 f32.
    assert bspans.adamw_least_bytes(1) == 8 * 4
    assert bspans.adamw_least_bytes(1_889_110_016) / 3.35e12 == pytest.approx(18.05e-3, rel=1e-3)


def test_the_tool_measures_a_tiny_cell_on_the_cpu():
    cell = tiny.cell("internlm2-1.8b.train-4k")
    out = bspans.measure(cell, tiny.model(), 2**31 + 7, steps=2, warm=1, device="cpu")
    assert out["device"] == "cpu" and out["loads"] == {} and out["nvcc_builds"] == 0
    assert set(out["per_step"]) == {"lm::train_step", *PHASES}
    assert all(row["n"] == 2 for row in out["per_step"].values())
    assert out["metrics"]["setup_first_step_s"] == out["first_step"]["s"] > 0.0
    assert list(out["first_step"]["phases"]) == PHASES
    assert not tracing.is_enabled()
    assert json.loads(json.dumps(out)) == out
