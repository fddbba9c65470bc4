"""The training step's spans (`models/lm.py`) on the CPU.

With tracing on, a step is one `lm::train_step` span with its five phases
as children, in order, one trace a step, under a mesh as on one device;
with tracing off nothing is recorded and the step's numbers are bitwise the
same. Under torch.profiler each aten op of the step falls in its phase's
span once the trace's `baseTimeNanoseconds` is added: the spans' epoch
seconds and the trace share one clock."""

import bisect
import json
import os

import torch
from torch.profiler import ProfilerActivity, profile

from ray_tpu_torch.models import LMTrainContext, TransformerConfig
from ray_tpu_torch.parallel import MeshSpec, build_mesh
from ray_tpu_torch.parallel.sharding import tree_leaves
from ray_tpu_torch.util import tracing
from torch_ranks import run_local_ranks

PHASES = ["lm::forward", "lm::loss", "lm::backward", "lm::grad_norm", "lm::optimizer"]
B, S = 2, 16


def _batch(step: int) -> dict:
    g = torch.Generator().manual_seed(step)
    tokens = torch.randint(0, 256, (B, S + 1), generator=g)
    return {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}


def _run(steps: int, traced: bool, ctx=None, state=None, as_lists=False):
    """`steps` steps of the tiny model from seed 0, each batch a dict of
    tensors or, `as_lists`, of nested lists; the spans recorded."""
    ctx = ctx or LMTrainContext(TransformerConfig.tiny(), device="cpu")
    state = state or ctx.init_state(0)
    tracing.drain_spans()
    if traced:
        tracing.enable_tracing()
    try:
        metrics = []
        for i in range(steps):
            batch = _batch(i)
            if as_lists:
                batch = {k: v.tolist() for k, v in batch.items()}
            state, m = ctx.train_step(state, batch)
            metrics.append(m)
        return state, metrics, tracing.drain_spans()
    finally:
        tracing.disable_tracing()


def _check_steps(recs, steps, tokens, strategy):
    roots = [r for r in recs if r["name"] == "lm::train_step"]
    assert [r["attrs"] for r in roots] == [
        {"step": i, "tokens": tokens, "strategy": strategy} for i in range(steps)]
    assert len({r["trace_id"] for r in roots}) == steps
    for root in roots:
        assert root["parent_span_id"] is None
        kids = sorted((r for r in recs if r["parent_span_id"] == root["span_id"]),
                      key=lambda r: r["start"])
        assert [k["name"] for k in kids] == PHASES
        assert all(k["trace_id"] == root["trace_id"] for k in kids)
        assert root["start"] <= kids[0]["start"] and kids[-1]["end"] <= root["end"]
        assert all(a["end"] <= b["start"] for a, b in zip(kids, kids[1:]))
    assert len(recs) == steps * (1 + len(PHASES))


def test_a_step_is_one_span_with_its_five_phases_in_order():
    _, _, recs = _run(2, traced=True)
    _check_steps(recs, 2, B * S, "fsdp")


def test_tracing_off_records_nothing_and_changes_nothing():
    on_state, on_metrics, on = _run(2, traced=True)
    off_state, off_metrics, off = _run(2, traced=False)
    assert on and off == []
    for a, b in zip(on_metrics, off_metrics):
        assert torch.equal(a["loss"], b["loss"]) and torch.equal(a["grad_norm"], b["grad_norm"])
    for a, b in zip(tree_leaves(on_state["params"]), tree_leaves(off_state["params"])):
        assert torch.equal(a, b)


def test_a_batch_of_lists_is_stepped_and_counted_as_before():
    """`train_step` takes what `make_batch` takes, nested lists too, traced
    or not; the span counts the lists' tokens."""
    _, want, _ = _run(2, traced=False)
    for traced in (False, True):
        _, got, recs = _run(2, traced=traced, as_lists=True)
        for a, b in zip(got, want):
            assert torch.equal(a["loss"], b["loss"])
        if traced:
            _check_steps(recs, 2, B * S, "fsdp")


def test_aten_ops_lie_inside_their_phase_on_the_trace_clock(tmp_path):
    """Each aten op of a step that torch.profiler traced falls, within 1 ms,
    inside the step's span, and the ops that only one phase runs fall in
    that phase's span, an event's epoch time being its `ts` plus the
    trace's `baseTimeNanoseconds`."""
    ctx = LMTrainContext(TransformerConfig.tiny(), device="cpu")
    state, _, _ = _run(1, traced=False, ctx=ctx)  # warm
    batch = _batch(1)
    tracing.enable_tracing()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            ctx.train_step(state, batch)
        recs = tracing.drain_spans()
    finally:
        tracing.disable_tracing()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    trace = json.loads((tmp_path / "trace.json").read_text())
    events, base_us = trace["traceEvents"], trace["baseTimeNanoseconds"] / 1e3
    spans = sorted((r["start"] * 1e6 - base_us, r["end"] * 1e6 - base_us, r["name"])
                   for r in recs)
    starts = [s[0] for s in spans]

    def span_at(t):
        """The innermost span open at trace time `t`: of those that hold
        it, the one that started last."""
        for start, end, name in reversed(spans[:bisect.bisect_right(starts, t)]):
            if end >= t:
                return name
        return None

    (root,) = [s for s in spans if s[2] == "lm::train_step"]
    ops = [e for e in events if e.get("ph") == "X" and e.get("cat") == "cpu_op"
           and e["name"].startswith("aten::")]
    assert ops
    for e in ops:
        assert root[0] - 1e3 <= e["ts"] and e["ts"] + e["dur"] <= root[1] + 1e3, e["name"]
    where = {"aten::log_softmax": "lm::loss", "aten::_foreach_norm": "lm::grad_norm",
             "aten::_foreach_addcmul_": "lm::optimizer", "aten::index": "lm::forward",
             "aten::select_backward": "lm::backward"}
    for name, phase in where.items():
        found = [span_at(e["ts"] + e["dur"] / 2) for e in ops if e["name"] == name]
        assert found and set(found) == {phase}, (name, found)
    backward = [span_at(e["ts"]) for e in events if e.get("ph") == "X"
                and e.get("name", "").startswith("autograd::engine::evaluate_function")]
    assert backward and set(backward) == {"lm::backward"}


def _mesh_rank(rank, out_dir):
    mesh = build_mesh(MeshSpec(data=1, fsdp=2), device_type="cpu")
    ctx = LMTrainContext(TransformerConfig.tiny(), mesh, "fsdp")
    state = ctx.init_state(0)
    _, _, recs = _run(2, traced=True, ctx=ctx, state=state)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(recs, f)


def test_a_sharded_step_has_the_same_spans(tmp_path):
    run_local_ranks(_mesh_rank, 2, (str(tmp_path),), init_file=str(tmp_path / "rdzv"))
    for rank in range(2):
        _check_steps(json.loads((tmp_path / f"rank{rank}.json").read_text()), 2, B * S, "fsdp")
