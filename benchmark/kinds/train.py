"""Training cells: `LMTrainContext.train_step` of the port on batches of
random token ids from the seed.

Set-up builds one context and one state from the seed's weights and drives
them through the cell's checked steps by the window's own call and feed;
the window then runs further steps on that same state, each a new batch,
until `seconds` have passed, synchronising after each step as a loop that
logs its loss does. After the window (and a traced extra pair of steps with
`trace`), the state is freed and the plain reference (`reference.train`)
repeats the checked steps from the same weights and batches.

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

import gc
import statistics
import time

import torch

from benchmark import counts, inputs, reference
from benchmark.trace import Capture

# Kernel names of B1, B2 and B3 in the trace, and the autograd node that
# runs the attention backward (B2, B3 and the delta pre-pass).
MARKERS = ("fwd_wgmma_kernel", "dq_wgmma_kernel", "dkv_wgmma_kernel")
BWD_SCOPE = "autograd::engine::evaluate_function: _FlashAttentionBackward"
MOVED = 1e-3  # a leaf whose reference gradient is below this share of the median's


def model_config(m: dict, cell: dict):
    from ray_tpu_torch.models.transformer import TransformerConfig

    spec, prog = m["train"], cell["program"]
    return TransformerConfig(
        vocab_size=m["vocab_size"], d_model=m["hidden_size"], n_layers=m["num_hidden_layers"],
        n_heads=m["num_attention_heads"], n_kv_heads=m["num_key_value_heads"],
        d_ff=m["intermediate_size"], max_seq_len=cell["traffic"]["seq"],
        rope_theta=float(m["rope_theta"]), norm_eps=m["rms_norm_eps"],
        dtype=getattr(torch, spec["dtype"]), param_dtype=getattr(torch, spec["param_dtype"]),
        tie_embeddings=m["tie_word_embeddings"], remat=prog["remat_policy"] != "off",
        remat_policy=None if prog["remat_policy"] in ("full", "off") else prog["remat_policy"],
    )


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


def build(cell: dict, m: dict, seed: int, device: str = "cuda"):
    """The context and state from the seed's weights, driven through the
    cell's checked steps by the window's own call and feed. Returns the
    context, the state, and its readings: each step's loss, each leaf's
    first clipped gradient norm (from the first moment), each leaf's change
    after the checked steps (the initial weights drawn again from the seed,
    a leaf at a time)."""
    from ray_tpu_torch.models.lm import LMTrainContext, default_optimizer
    from ray_tpu_torch.parallel.sharding import tree_leaves

    tr, opt = cell["traffic"], m["train"]["optimizer"]
    b, s = tr["batch"], tr["seq"]
    ctx = LMTrainContext(model_config(m, cell), strategy=cell["program"]["strategy"],
                         optimizer=default_optimizer(opt["learning_rate"], opt["weight_decay"]),
                         device=device)
    dtype = getattr(torch, m["train"]["param_dtype"])
    params = inputs.make_params(m, seed, dtype, device)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    state = {"params": params, "opt_state": ctx.optimizer.init(leaves), "step": 0}
    slot = {id(t): i for i, t in enumerate(leaves)}
    paths = inputs.leaf_paths(m)

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
                  for p, p0 in inputs.iter_params(m, seed, dtype, device)}
    return ctx, state, {"losses": losses, "first_grad": first_grad, "change": change,
                        "check_s": time.perf_counter() - t}


def reference_readings(cell: dict, m: dict, seed: int, device: str = "cuda", **kw) -> dict:
    """The plain reference's readings of the checked steps from the same
    weights and batches (`kw`: quant, rows)."""
    tr = cell["traffic"]
    reference.exact_float32()
    p0 = inputs.make_params(m, seed, torch.float32, device)
    batches = [inputs.train_batch(m, seed, i, tr["batch"], tr["seq"], device)
               for i in range(cell["check"]["steps"])]
    return reference.train(p0, batches, m, m["train"]["optimizer"], **kw)


def gaps(ours: dict, ref: dict, m: dict) -> dict:
    """The three compared numbers (the module's docstring)."""
    paths = inputs.leaf_paths(m)
    floor = MOVED * statistics.median(ref["first_grad"][p] for p in paths)
    moved = [p for p in paths if ref["first_grad"][p] >= floor]
    return {
        "loss_gap": max(abs(a - r) for a, r in zip(ours["losses"], ref["losses"])),
        "grad_gap": _gap(ours["first_grad"], ref["first_grad"], paths),
        "update_gap": _gap(ours["change"], ref["change"], moved),
    }


def run(cell: dict, m: dict, seed: int, seconds: float, trace: bool, t0: float,
        device: str = "cuda") -> dict:
    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    b, s = cell["traffic"]["batch"], cell["traffic"]["seq"]
    ctx, state, ours = build(cell, m, seed, device)
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
    summary, traced_gc = None, GcPauses()
    if trace and on_card:
        gc.collect()
        cap = Capture(MARKERS, (BWD_SCOPE,))
        with traced_gc:
            cap.start()
            for _ in range(cell["trace"]["steps"]):
                state, _ = ctx.train_step(state, inputs.train_batch(m, seed, step, b, s, device))
                step += 1
            sync()
        summary = cap.stop()
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
    found = gaps(ours, ref, m)
    checks = {k: (v, limits[k]) for k, v in found.items() if k in limits}
    checks["window_loss_not_finite"] = (0 if finite else 1, 0)
    tokens = done * b * s
    return {
        "correct": True,  # the checks decide
        "attempted": done,
        "failed": 0 if finite else done,
        "metrics": {"train_tokens_per_s": tokens / window_s, "setup_s": setup_s},
        "checks": checks,
        "device": {"platform": "gpu" if on_card else "cpu", "kind": name, "count": 1,
                   "memory_peak_bytes": memory_peak},
        "trace": summary,
        "readings": {"gaps": found, "ours": ours, "reference": ref,
                     "reference_s": reference_s, "window_steps": done,
                     "step_s": {"min": min(steps_s), "median": statistics.median(steps_s),
                                "max": max(steps_s)},
                     "gc": {"window": window_gc.summary(), "traced": traced_gc.summary()}},
        "context": {
            "kind": "train", "device": name, "window_s": window_s,
            "flops": counts.train_flops_per_token(m, s) * tokens,
            "window_peak_bytes": window_peak, "trace": summary,
            "shape": {"b": b, "s": s, "h": m["num_attention_heads"],
                      "hkv": m["num_key_value_heads"], "d": m["head_dim"],
                      "layers": m["num_hidden_layers"]},
        },
    }
