"""The trace reduction on a hand-made Chrome trace: overlapping kernels are
busy once, gaps are labelled by the host op that launched the next kernel,
and kernels are found inside the host op that launched them."""

import pytest

from benchmark.trace import summarize


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


EVENTS = [
    _x("user_annotation", "bench.batch b=2 s=256", 0, 100),
    _x("cpu_op", "aten::mm", 5, 10),
    _x("cuda_runtime", "cudaLaunchKernel", 6, 2, corr=1),
    _x("cpu_op", "flash", 20, 5),
    _x("cuda_runtime", "cudaLaunchKernel", 21, 2, corr=2),
    _x("cpu_op", "aten::add", 60, 5),
    _x("cuda_runtime", "cudaLaunchKernel", 61, 2, corr=3),
    _x("kernel", "sm90_gemm", 10, 20, tid=7, corr=1),
    _x("kernel", "fwd_wgmma_kernel<128>", 25, 10, tid=8, corr=2),  # overlaps the gemm
    _x("kernel", "elementwise", 70, 10, tid=7, corr=3),
    _x("cpu_op", "aten::launch_outside", 200, 5, tid=2),
]


def test_busy_is_the_union_and_gaps_name_the_launching_op():
    s = summarize(EVENTS, window_s=100e-6, markers=("fwd_wgmma_kernel",),
                  scopes=("bench.batch",))
    assert s["busy_s"] == pytest.approx(35e-6)  # [10, 35] and [70, 80]
    assert s["kernels"] == 3
    assert s["idle_gaps"] == [["aten::add", pytest.approx(35e-6)]]
    assert s["device_ops"][0] == ["sm90_gemm", pytest.approx(20e-6)]
    assert s["marked"] == [{"marker": "fwd_wgmma_kernel", "s": pytest.approx(10e-6),
                            "scope": "bench.batch b=2 s=256"}]
    assert s["scoped_s"] == {"bench.batch": pytest.approx(40e-6)}


def test_a_kernel_whose_launch_is_unknown_has_no_scope():
    s = summarize([_x("kernel", "fwd_wgmma_kernel", 0, 5, corr=9)], 1e-5,
                  ("fwd_wgmma_kernel",), ("bench.batch",))
    assert s["marked"][0]["scope"] is None and s["scoped_s"] == {}
