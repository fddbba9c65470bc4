"""Training cells: `LMTrainContext.train_step` of the port on batches of
random token ids from the seed. What is particular to the model comes from
its family (`benchmark/families/<family>.py`, `manifest.family`): the
program's config, the trained leaves, the reference's forward, the
operations a token and the attention kernels' shape.

Set-up builds one context and one state from the seed's weights and drives
them through the cell's checked steps by the window's own call and feed;
the window then runs further steps on that same state, each a new batch,
until `seconds` have passed, synchronising after each step as a loop that
logs its loss does. After the window (and a traced extra pair of steps with
`trace`), the state is freed and the plain reference (`reference.train`)
repeats the checked steps from the same weights and batches.

The program's spans (`ray_tpu_torch.util.tracing`) are on in set-up and in
the traced steps, off in the window. The run's `context` holds them, the
kernel loader's records (`ops/cuda/_build.loads`) and what the program's
metrics (`util.metrics.collect()`) did over the traced steps (`counters`),
for the per-layer readers (`benchmark/spans.py`); `readings` prints each
span's seconds a traced step, the first step, the load records and the nvcc
builds.

Python's cyclic collector runs a full (gen-2) collection of the heap, a few
tenths of a second in this process, about every 40 steps, at a point that
moves with every allocation before it. Set-up ends with a full collection, so the window starts from
the same collector state whatever set-up allocated, and so do the traced
steps, so that one left pending by the window does not set the idle share
of two steps. Each window step's host-clock time and the collections in the
window and in the traced steps are in `readings`, on standard error.

Read, and compared against a limit where the cell's file sets one:
- loss_gap: the largest |loss - reference loss| over the checked steps
  (printed only: neither the control nor a planted fault moves it far from
  sound runs, PERF.md);
- grad_gap: over the leaves, the largest gap between the norm of the first
  step's clipped gradient (read from the optimizer's first moment, mu =
  (1 - b1) g) and the reference's, over the larger of the reference leaf's
  norm and the median leaf's;
- update_gap: the same for the norm of each leaf's change over the checked
  steps, over the leaves whose reference gradient is at least 1e-3 of the
  median leaf's (the others move under Adam by round-off alone).
"""

from __future__ import annotations

import functools
import gc
import math
import statistics
import time

import torch

from benchmark import inputs, manifest, reference, spans
from benchmark.trace import Capture

# Kernel names of B1, B2 and B3 in the trace, and the autograd node that
# runs the attention backward (B2, B3 and the delta pre-pass).
MARKERS = ("fwd_wgmma_kernel", "dq_wgmma_kernel", "dkv_wgmma_kernel")
BWD_SCOPE = "autograd::engine::evaluate_function: _FlashAttentionBackward"
MOVED = 1e-3  # a leaf whose reference gradient is below this share of the median's


class GcPauses:
    """Python's cyclic collections while entered: the count and seconds by
    generation, and the longest."""

    def __init__(self):
        self.pauses, self._t = [], None

    def _note(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.pauses.append((info["generation"], time.perf_counter() - self._t))
            self._t = None

    def __enter__(self):
        gc.callbacks.append(self._note)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._note)

    def summary(self) -> dict:
        out = {f"gen{g}": {"n": 0, "s": 0.0} for g in range(3)}
        for g, s in self.pauses:
            out[f"gen{g}"]["n"] += 1
            out[f"gen{g}"]["s"] += s
        out["longest_s"] = max((s for _, s in self.pauses), default=0.0)
        return out


def _gap(ours: dict, ref: dict, paths) -> float:
    floor = statistics.median(ref[p] for p in paths)
    return max(abs(ours[p] - ref[p]) / max(ref[p], floor) for p in paths)


def fixed(family, m: dict, seed: int, device) -> dict:
    """The family's tensors that are not trained (none where it has none)."""
    return family.fixed(m, seed, device) if hasattr(family, "fixed") else {}


def build(cell: dict, m: dict, seed: int, device: str = "cuda"):
    """The context and state from the seed's weights, driven through the
    cell's checked steps by the window's own call and feed. Returns the
    context, the state, and its readings: each step's loss, each leaf's
    first clipped gradient norm (from the first moment), each leaf's change
    after the checked steps (the initial weights drawn again from the seed,
    a leaf at a time)."""
    from ray_tpu_torch.models.lm import LMTrainContext, default_optimizer
    from ray_tpu_torch.parallel.sharding import tree_leaves

    family = manifest.family(m)
    tr, opt = cell["traffic"], m["train"]["optimizer"]
    b, s = tr["batch"], tr["seq"]
    ctx = LMTrainContext(family.program_config(m, cell, fixed(family, m, seed, device)),
                         strategy=cell["program"]["strategy"],
                         optimizer=default_optimizer(opt["learning_rate"], opt["weight_decay"]),
                         device=device)
    dtype = getattr(torch, m["train"]["param_dtype"])
    params = inputs.make_params(family, m, seed, dtype, device)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    state = {"params": params, "opt_state": ctx.optimizer.init(leaves), "step": 0}
    slot = {id(t): i for i, t in enumerate(leaves)}
    paths = [path for path, _, _ in family.leaves(m)]

    def leaf(path):
        return inputs.get_leaf(params, path)

    losses, first_grad = [], {}
    for step in range(cell["check"]["steps"]):
        state, metrics = ctx.train_step(state, inputs.train_batch(m, seed, step, b, s, device))
        losses.append(float(metrics["loss"]))
        if step == 0:
            mu = state["opt_state"]["mu"]
            first_grad = {p: float(torch.linalg.vector_norm(mu[slot[id(leaf(p))]]))
                          / (1 - opt["b1"]) for p in paths}
    t = time.perf_counter()
    with torch.no_grad():
        change = {p: float(torch.linalg.vector_norm(leaf(p).detach().float() - p0.float()))
                  for p, p0 in inputs.iter_params(family, m, seed, dtype, device)}
    return ctx, state, {"losses": losses, "first_grad": first_grad, "change": change,
                        "check_s": time.perf_counter() - t}


def reference_readings(cell: dict, m: dict, seed: int, device: str = "cuda", **kw) -> dict:
    """The plain reference's readings of the checked steps from the same
    weights and batches (`kw`: quant, rows)."""
    tr, family = cell["traffic"], manifest.family(m)
    reference.exact_float32()
    p0 = inputs.make_params(family, m, seed, torch.float32, device)
    batches = [inputs.train_batch(m, seed, i, tr["batch"], tr["seq"], device)
               for i in range(cell["check"]["steps"])]
    forward = functools.partial(family.forward, fixed=fixed(family, m, seed, device))
    return reference.train(p0, batches, m, m["train"]["optimizer"], forward, **kw)


def gaps(ours: dict, ref: dict) -> dict:
    """The three compared numbers (the module's docstring), over the
    trained leaves."""
    paths = list(ref["first_grad"])
    floor = MOVED * statistics.median(ref["first_grad"][p] for p in paths)
    moved = [p for p in paths if ref["first_grad"][p] >= floor]
    return {
        "loss_gap": max(abs(a - r) for a, r in zip(ours["losses"], ref["losses"])),
        "grad_gap": _gap(ours["first_grad"], ref["first_grad"], paths),
        "update_gap": _gap(ours["change"], ref["change"], moved),
    }


def run(cell: dict, m: dict, seed: int, seconds: float, trace: bool, t0: float,
        device: str = "cuda") -> dict:
    from ray_tpu_torch.ops.cuda import _build
    from ray_tpu_torch.util import metrics as program_metrics
    from ray_tpu_torch.util import tracing

    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    family = manifest.family(m)
    b, s = cell["traffic"]["batch"], cell["traffic"]["seq"]
    tracing.drain_spans()
    tracing.enable_tracing()
    try:
        ctx, state, ours = build(cell, m, seed, device)
    finally:
        tracing.disable_tracing()
    setup_spans = tracing.drain_spans()
    sync()
    gc.collect()
    # The change's reading (a second draw of the weights) is the check's,
    # not set-up.
    setup_s = time.perf_counter() - t0 - ours["check_s"]
    if on_card:
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    step, done, window_losses = cell["check"]["steps"], 0, []
    ends = []
    with GcPauses() as window_gc:
        start = time.perf_counter()
        while True:
            state, metrics = ctx.train_step(state, inputs.train_batch(m, seed, step, b, s, device))
            sync()
            step, done = step + 1, done + 1
            window_losses.append(metrics["loss"])
            ends.append(time.perf_counter())
            if ends[-1] - start >= seconds:
                break
        window_s = ends[-1] - start
    steps_s = [e - s0 for s0, e in zip([start] + ends, ends)]
    window_peak = torch.cuda.max_memory_allocated() if on_card else 0
    summary, traced_spans, counters, traced_gc = None, [], {}, GcPauses()
    if trace:
        gc.collect()
        cap = Capture(MARKERS, (BWD_SCOPE,), on_card)
        before = program_metrics.collect()
        tracing.enable_tracing()
        try:
            with traced_gc:
                cap.start()
                for _ in range(cell["trace"]["steps"]):
                    state, _ = ctx.train_step(state,
                                              inputs.train_batch(m, seed, step, b, s, device))
                    step += 1
                sync()
        finally:
            tracing.disable_tracing()
        traced_spans = tracing.drain_spans()
        summary = cap.stop(traced_spans)
        counters = spans.counter_deltas(before, program_metrics.collect())
    finite = bool(torch.isfinite(torch.stack(window_losses)).all())
    name = torch.cuda.get_device_name() if on_card else "cpu"
    memory_peak = max(setup_peak, window_peak, torch.cuda.max_memory_allocated()) if on_card else 0
    del state, metrics, ctx, window_losses
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref = reference_readings(cell, m, seed, device)
    reference_s = time.perf_counter() - t_ref
    limits = cell["check"]["limits"]
    found = gaps(ours, ref)
    checks = {k: (v, limits[k]) for k, v in found.items() if k in limits}
    checks["window_loss_not_finite"] = (0 if finite else 1, 0)
    tokens = done * b * s
    loads = {k: dict(v) for k, v in _build.loads.items()}
    context = {
        "kind": "train", "device": name, "window_s": window_s,
        "flops": family.train_flops_per_token(m, s) * tokens,
        "window_peak_bytes": window_peak, "trace": summary,
        "shape": family.attention_shape(m, cell["traffic"]),
        "n_params": sum(math.prod(shape) for _, shape, _ in family.leaves(m)),
        "traced_steps": cell["trace"]["steps"],
        "spans": {"setup": setup_spans, "traced": traced_spans},
        "loads": loads, "counters": counters,
    }
    return {
        "correct": True,  # the checks decide
        "attempted": done,
        "failed": 0 if finite else done,
        "metrics": {"train_tokens_per_s": tokens / window_s, "setup_s": setup_s},
        "checks": checks,
        "device": {"platform": "gpu" if on_card else "cpu", "kind": name, "count": 1,
                   "memory_peak_bytes": memory_peak},
        "trace": summary,
        "context": context,
        "readings": {"gaps": found, "ours": ours, "reference": ref,
                     "reference_s": reference_s, "window_steps": done,
                     "step_s": {"min": min(steps_s), "median": statistics.median(steps_s),
                                "max": max(steps_s)},
                     "gc": {"window": window_gc.summary(), "traced": traced_gc.summary()},
                     "spans_a_traced_step": spans.per_step(context) if summary else None,
                     "first_step": spans.first_step(setup_spans, loads),
                     "loads": loads, "nvcc_builds": sum(1 for r in loads.values() if r["built"]),
                     "counters": counters},
    }
