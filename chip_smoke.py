#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`ray_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --forward-times   # only B1's times (main_forward_times)
    python3 chip_smoke.py --backward-times  # only B2's and B3's (main_backward_times)

Phases, in order; any failure raises and the script exits nonzero without
printing the final line:

1. device and build: needs a CUDA card; prints the card's name and power
   limit (nvidia-smi) and builds the flash-attention forward and backward
   kernels from ray_tpu_torch/csrc with nvcc, one nvcc per source, started
   together; prints each kernel's registers, shared memory and spills
   (ptxas) and, where the toolkit has cuobjdump, its HGMMA (wgmma) and HMMA
   (mma.sync) instruction counts, and fails if a bf16 kernel (all three
   run on wgmma) spills or holds an mma.sync;
2. the forward kernels against their plain PyTorch version on the card
   (FWD_CASES: head_dim 128 and 64, S = 1, 64, 200, 1000 and 1024, GQA,
   causal and not, bf16 and f32), with times at the serving shape of the
   kernel, the plain version and one PyTorch library call computing the
   same function (a yardstick the port never calls): CUDA events around
   eager calls, as a caller waits, and CUDA-graph replays, the card alone,
   with the host's time to issue a call (forward_times);
3. the serving path at the full width of TransformerConfig.llama_1b (random
   weights from a seeded generator): 16 requests of 1024 tokens from 16
   threads through `@serve.batch(max_batch_size=8)`, the kernel's launch
   count read around that run, and one batch recomputed with the plain
   reference attention; then one batch alone, host-timed, and a
   torch.profiler breakdown of one batch's device time by kernel;
4. the backward kernels (dq, dk/dv) after the forward kernel against the
   plain forward and backward in f32 from the same inputs (BWD_CASES: the
   training shape causal and full and with a permuted dO, head_dim 128 and
   64, S = 1, 64, 200, 1000 and 1024, GQA, causal and not, bf16 and f32),
   with times of each kernel at the training shape (CUDA events around
   eager calls and CUDA-graph replays), of the wrapper's delta pre-pass,
   the plain backward and the library's backward;
5. training at bench.py's head configuration (d2048 L16 H16/16 ff5504
   V32000, bf16 params, remat qkv_attn, batch 16 x 1024, strategy dp) through
   `LMTrainContext` with random weights from a seeded generator: 2 warm-up
   and 5 timed steps with exact kernel launch counts per step, one step with
   remat_policy=None, a profile of one step, and the first step recomputed
   from a copy of the initial state with the plain reference attention;
6. the parallel slice on the one card (no multi-GPU number): the ring
   attention's chunk schedule for a ring of 4, run in one process through
   the ring's own step and merge functions at bench.py's head attention
   shape [16, 1024, 16, 128] and GQA 16/4 at batch 4 (10 launches of each
   kernel), against whole-sequence B1, B2 and B3 and the plain f32
   versions, with its times beside theirs; then `LMTrainContext` under
   dp, fsdp, tp, fsdp_tp, sp and ep on a one-rank NCCL mesh at bench.py's
   head configuration, 2 steps each with exact launch counts, the first
   loss against the single-device step's, step times and peak memory.

Prints JSON lines of the serving and training numbers, the profiles and the
kernels, and last {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from ray_tpu_torch import serve
from ray_tpu_torch.models import LMTrainContext, TransformerConfig, forward, init_params
from ray_tpu_torch.ops.cuda import _build
from ray_tpu_torch.ops.cuda import flash_attention as flash
from ray_tpu_torch.ops.ring_attention import ring_schedule
from ray_tpu_torch.parallel import MeshSpec, build_mesh

# H100 SXM published dense peaks (NVIDIA data sheet), at a 700 W limit.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# Kernel against its plain version computed in f32 from the same inputs.
# bf16: the kernel rounds p to bf16 for the PV product and stores o in bf16
# (half an ulp is 2^-9 relative, ~8e-3 at |o| ~ 4), so o is held to 2e-2;
# its lse comes from f32 scores and unrounded p, so 1e-3. f32: another
# summation order only, 1e-4 for both.
TOL = {torch.bfloat16: (2e-2, 1e-3), torch.float32: (1e-4, 1e-4)}
# Serving logits (|logit| < 8) of the kernel path against the plain
# reference attention, both bf16 through 16 layers: 0.25 is 8 bf16 ulps at
# that magnitude.
LOGIT_TOL = 0.25

# Backward kernels against the plain backward in f32 from the same inputs,
# as a share of the largest |gradient|: bf16 kernels round P and dS to bf16
# (2^-9 relative) for their products and store bf16 (another 2^-9), summed
# over up to 1024 terms of both signs, so 2e-2; f32 kernels differ by the
# summation order only, so 1e-4.
BWD_REL_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# A gradient that is zero in exact arithmetic (dq and dk when every row sees
# one key, as at S = 1: dS = P (dP - delta) with P = 1 and dP = delta) holds
# only rounding noise, so its error is taken as a share of the case's
# largest gradient instead; this floor is far below every other case's own
# largest |gradient|.
ZERO_GRAD_FLOOR = 1e-3
# The first training step with the kernels against the same step with the
# plain reference attention (autograd through it), both bf16 from one state.
# The loss is a mean over 16,384 tokens of terms whose logits differ by up to
# ~0.25 (LOGIT_TOL) with both signs: 1e-2 absolute on a loss of ~10.4. The
# gradient norm sums squares over 0.94e9 bf16 gradients whose attention parts
# take other rounding paths: 3e-2 relative.
TRAIN_LOSS_TOL = 1e-2
TRAIN_GRAD_NORM_RTOL = 3e-2

N_REQUESTS = 16
PROMPT_LEN = 1024
MAX_BATCH = 8
SEED = 0
TRAIN_BATCH = 16
TRAIN_SEQ = 1024
WARMUP_STEPS = 2
TIMED_STEPS = 5


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls: int = 20, replays: int = 5, stream=None) -> float:
    """Device time of one call of `fn`: `calls` calls captured in a CUDA
    graph, the replays timed with CUDA events, so that the host's time to
    issue a call drops out. `fn` launches on the current stream, or on
    `stream`, which is then the one captured."""
    warm = stream if stream is not None else torch.cuda.Stream()
    warm.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(warm):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(warm)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(calls):
            fn()
    ms = time_ms(graph.replay, iters=replays) / calls
    del graph
    return ms


def host_us(fn, iters: int = 50) -> float:
    """Host time to issue one call of `fn` (the card runs behind)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / iters * 1e6


def attention_bound(q, k, causal: bool):
    """Least time for the card: bytes of q, k, v, o and lse each moved once,
    and the two products' operations over the visible (q, k) pairs."""
    b, sq, h, d = q.shape
    flops = 4 * d * visible_pairs(sq, k.shape[1], causal) * b * h
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size() + b * h * sq * 4
    return bound(flops, nbytes, q.dtype)


def visible_pairs(sq: int, sk: int, causal: bool) -> int:
    return sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk


def bound(flops: float, nbytes: float, dtype):
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes")


def backward_bounds(q, k, causal: bool) -> dict:
    """Least times for the card of dq (three products over the visible
    pairs: q k^T, dO v^T, dS k) and of dk/dv (four: q k^T, dO v^T, P^T dO,
    dS^T q), each reading q, k, v, dO, lse and delta once and writing its
    outputs once."""
    b, sq, h, d = q.shape
    product = 2 * d * visible_pairs(sq, k.shape[1], causal) * b * h
    e = q.element_size()
    reads = (2 * q.numel() + 2 * k.numel()) * e + 2 * b * h * sq * 4
    return {
        "dq": bound(3 * product, reads + q.numel() * e, q.dtype),
        "dkv": bound(4 * product, reads + 2 * k.numel() * e, q.dtype),
    }


def rand_qkv(g, b, s, h, hkv, d, dtype):
    q = torch.randn((b, s, h, d), generator=g, device="cuda").to(dtype)
    k = torch.randn((b, s, hkv, d), generator=g, device="cuda").to(dtype)
    v = torch.randn((b, s, hkv, d), generator=g, device="cuda").to(dtype)
    return q, k, v


# (name, B, S, H, Hkv, head_dim, dtype, causal): every instantiation and edge
# of the forward kernels, against the plain version.
FWD_CASES = [
    ("serving_causal", 8, 1024, 16, 16, 128, torch.bfloat16, True),
    ("serving_full", 8, 1024, 16, 16, 128, torch.bfloat16, False),
    ("gqa_16_4", 8, 1024, 16, 4, 128, torch.bfloat16, True),
    ("gqa_16_4_full", 2, 1024, 16, 4, 128, torch.bfloat16, False),
    ("ragged_1000", 2, 1000, 16, 16, 128, torch.bfloat16, True),
    ("ragged_1000_full", 2, 1000, 16, 16, 128, torch.bfloat16, False),
    ("s1", 2, 1, 16, 4, 128, torch.bfloat16, True),
    ("s64", 2, 64, 16, 4, 128, torch.bfloat16, True),
    ("s200_full", 2, 200, 16, 4, 128, torch.bfloat16, False),
    ("d64_gqa", 2, 1024, 16, 4, 64, torch.bfloat16, True),
    ("d64_ragged_1000_full", 2, 1000, 16, 16, 64, torch.bfloat16, False),
    ("d64_s200", 2, 200, 16, 4, 64, torch.bfloat16, True),
    ("f32_ragged_300", 2, 300, 16, 4, 128, torch.float32, True),
    ("f32_d64_200_full", 2, 200, 16, 4, 64, torch.float32, False),
]


def forward_times(q, k, v) -> dict:
    """B1 (causal) at these inputs beside the library forward: each one's
    time by CUDA events around eager calls (`ms`, `library_ms`: what a
    caller waits, so the host's time to issue a call where that is longer
    than the card's), by CUDA-graph replays (`graph_ms`, `library_graph_ms`:
    the card's time alone) and the host's time to issue a call (`host_us`,
    `library_host_us`); the plain version's time; the bound."""
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    kernel = lambda: flash.flash_attention_fwd(q, k, v, causal=True)  # noqa: E731
    library = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=True)
    bound_ms, bound_by = attention_bound(q, k, causal=True)
    return dict(
        ms=time_ms(kernel, iters=20), graph_ms=graph_ms(kernel), host_us=host_us(kernel),
        plain_ms=time_ms(lambda: flash.flash_attention_fwd_plain(q, k, v, causal=True), iters=3),
        library_ms=time_ms(library, iters=20), library_graph_ms=graph_ms(library),
        library_host_us=host_us(library), bound_ms=bound_ms, bound_by=bound_by,
    )


def main_forward_times() -> int:
    """`python3 chip_smoke.py --forward-times`: forward_times at the serving
    and the training shape, and nothing else, for the `ray_tpu_torch` beside
    this script. A copy of the script in another checkout times that
    checkout's wrapper and kernel by the same method, so that two trees can
    be set side by side in one run on one card."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    print(f"card: {card_line()}", flush=True)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    times = {}
    for shape, b in (("serving", MAX_BATCH), ("training", TRAIN_BATCH)):
        times[shape] = forward_times(*rand_qkv(g, b, PROMPT_LEN, 16, 16, 128, torch.bfloat16))
    print(json.dumps({"forward_times": times}), flush=True)
    return 0


def backward_times(q, k, v, o, lse, do) -> dict:
    """B2 and B3 (causal) on one prepared launch at these inputs: CUDA
    events around eager calls (`ms`) and CUDA-graph replays (`graph_ms`,
    the card alone). The launch is prepared on a stream of its own, which
    it binds, and the graphs are captured on that stream."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        call = flash._BwdLaunch(q, k, v, o, lse, do, True, q.shape[-1] ** -0.5)
        times = {name: dict(ms=time_ms(fn, iters=20), graph_ms=graph_ms(fn, stream=stream))
                 for name, fn in (("flash_attn_bwd_dq", call.dq),
                                  ("flash_attn_bwd_dkv", call.dkv))}
    torch.cuda.current_stream().wait_stream(stream)
    return times


def training_shape_inputs(g) -> tuple:
    """q, k, v, dO at the training shape and the forward's o and lse."""
    q, k, v = rand_qkv(g, TRAIN_BATCH, TRAIN_SEQ, 16, 16, 128, torch.bfloat16)
    do = torch.randn(q.shape, generator=g, device="cuda").to(torch.bfloat16)
    return (q, k, v, *flash.flash_attention_fwd(q, k, v, causal=True), do)


def main_backward_times() -> int:
    """`python3 chip_smoke.py --backward-times`: backward_times at the
    training shape, and nothing else, for the `ray_tpu_torch` beside this
    script (a copy of the script in another checkout times that checkout's
    kernels by the same method)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    print(f"card: {card_line()}", flush=True)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    print(json.dumps({"backward_times": backward_times(*training_shape_inputs(g))}), flush=True)
    return 0


def phase_kernels(g) -> dict:
    """B1 against its plain version; returns the serving-shape numbers."""
    serving = None
    for name, b, s, h, hkv, d, dtype, causal in FWD_CASES:
        q, k, v = rand_qkv(g, b, s, h, hkv, d, dtype)
        o, lse = flash.flash_attention_fwd(q, k, v, causal=causal)
        torch.cuda.synchronize()
        o_p, lse_p = flash.flash_attention_fwd_plain(
            q.float(), k.float(), v.float(), causal=causal
        )
        err_o = (o.float() - o_p).abs().max().item()
        err_lse = (lse - lse_p).abs().max().item()
        tol_o, tol_lse = TOL[dtype]
        ok = err_o <= tol_o and err_lse <= tol_lse and torch.isfinite(o).all().item()
        print(f"kernel {name}: {b}x{s}x{h}/{hkv}x{d} {str(dtype)[6:]} causal={causal} "
              f"max|o-plain|={err_o:.3e} (tol {tol_o}) max|lse-plain|={err_lse:.3e} "
              f"(tol {tol_lse}) {'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"flash_attn_fwd disagrees with its plain version in case {name}")
        if name == "serving_causal":
            serving = dict(max_abs_err=err_o, **forward_times(q, k, v))
            print(f"kernel timing at serving shape: {json.dumps(serving)}", flush=True)
        del q, k, v, o, lse, o_p, lse_p
    return serving


class LMServer:
    """A replica holding the decoder: next-token prediction for a batch of
    equal-length prompts in one forward, as in
    tests/test_serve.py::test_batched_jax_inference."""

    def __init__(self, cfg: TransformerConfig, params):
        self.cfg = cfg
        # Weights are cast to the compute dtype once at load: forward casts
        # each weight to it at use, so the rounding is the same.
        self.params = _tree_map(lambda t: t.to(cfg.dtype), params)
        self.batches = []  # (size, seconds, tokens, last-position logits)

    @serve.batch(max_batch_size=MAX_BATCH, batch_wait_timeout_s=2.0)
    def predict_batch(self, token_lists):
        t0 = time.perf_counter()
        toks = torch.tensor(token_lists, dtype=torch.long, device="cuda")
        logits = _forward(self, toks)
        last = logits[:, -1, :]
        check(tuple(logits.shape) == (len(token_lists), PROMPT_LEN, self.cfg.vocab_size),
              f"logits shape {tuple(logits.shape)}")
        check(bool(torch.isfinite(last).all()), "non-finite logits")
        out = last.argmax(dim=-1).tolist()  # waits for the card
        self.batches.append((len(token_lists), time.perf_counter() - t0, toks, last))
        return out

    def __call__(self, tokens):
        return self.predict_batch(list(tokens))


def _tree_map(fn, tree):
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def phase_serving(card: str) -> tuple:
    cfg = TransformerConfig.llama_1b()
    g = torch.Generator(device="cuda").manual_seed(SEED)
    server = LMServer(cfg, init_params(cfg, g, device="cuda"))
    torch.cuda.empty_cache()
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (N_REQUESTS, PROMPT_LEN)
    ).tolist()
    # Warm-up batch (cuBLAS handles and heuristics), outside the counted run.
    server.predict_batch.__wrapped__(server, prompts[:MAX_BATCH])
    server.batches.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    outs = [None] * N_REQUESTS
    errors = []

    def call(i):
        try:
            outs[i] = server(prompts[i])
        except Exception as e:  # noqa: BLE001 - reported and failed below
            errors.append(e)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(N_REQUESTS)]
    flash.flash_attention_fwd.launches = 0
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    launches = flash.flash_attention_fwd.launches
    check(not errors, f"request failed: {errors[:1]!r}")
    check(not any(t.is_alive() for t in threads), "a request did not finish")
    check(all(isinstance(o, int) and 0 <= o < cfg.vocab_size for o in outs), "bad answers")

    n_batches = len(server.batches)
    check(sum(b[0] for b in server.batches) == N_REQUESTS, "requests lost in batching")
    check(launches == cfg.n_layers * n_batches,
          f"flash kernel launched {launches} times for {n_batches} batches "
          f"of {cfg.n_layers} layers")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # One batch again with the plain reference attention.
    size, _, toks, last = server.batches[0]
    ref_cfg = dataclasses.replace(cfg, attention_impl="reference")
    with torch.no_grad():
        ref = forward(server.params, toks, ref_cfg)[:, -1, :]
    diff = (last - ref).abs().max().item()
    top2 = ref.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > LOGIT_TOL
    agree = last.argmax(-1) == ref.argmax(-1)
    print(f"serving check: max|logits - reference| = {diff:.4f} (tol {LOGIT_TOL}); "
          f"argmax agrees on {int((agree & clear).sum())}/{int(clear.sum())} requests "
          f"with a top-2 gap over the tolerance", flush=True)
    check(diff <= LOGIT_TOL, "serving logits disagree with the reference attention")
    check(bool(agree[clear].all()), "next token disagrees with the reference attention")

    lat = [b[1] for b in server.batches]
    solo, solo_issue = solo_batch_seconds(server, toks)
    serving = {
        "card": card,
        "config": "llama_1b (d2048 L16 H16/16 Dh128 ff5504 V32000, bf16 compute)",
        "requests": N_REQUESTS, "prompt_len": PROMPT_LEN,
        "batches": n_batches, "batch_sizes": [b[0] for b in server.batches],
        "batch_latency_s": lat,
        "prefill_tokens_per_s_per_batch": [
            b[0] * PROMPT_LEN / b[1] for b in server.batches
        ],
        "wall_s": wall, "prefill_tokens_per_s": N_REQUESTS * PROMPT_LEN / wall,
        "solo_batch_latency_s": solo, "solo_batch_host_issue_s": solo_issue,
        "peak_mem_gb": peak_gb, "flash_launches": launches,
        "max_logit_diff_vs_reference": diff,
    }
    print(json.dumps({"profile": profile_device(lambda: _forward(server, toks))}), flush=True)
    return serving, launches


def _forward(server, toks):
    with torch.no_grad():
        return forward(server.params, toks, server.cfg)


def solo_batch_seconds(server, toks, reps: int = 3) -> tuple:
    """One batch's forward alone on the card, host clock to synchronize,
    and the host's time to issue it (to the forward's return, the card
    running behind): where the two are close, the host sets the latency."""
    latency, issue = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _forward(server, toks)
        issue.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        latency.append(time.perf_counter() - t0)
    return latency, issue


# The bf16 kernel of each of the port's kernels on the path, by the name in
# its symbol (as the profiler, ptxas and cuobjdump show it).
KERNEL_MARKERS = {"flash_attn_fwd": "fwd_wgmma_kernel", "flash_attn_bwd_dq": "dq_wgmma_kernel",
                  "flash_attn_bwd_dkv": "dkv_wgmma_kernel"}


def profile_device(fn, top: int = 12) -> dict:
    """Device time of one call of `fn` by kernel (torch.profiler), the card's
    busy share of the profiled window, and each port kernel's share of the
    device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if dev_us > 0 and getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA:
            rows.append((dev_us, e.count, e.key))
    rows.sort(reverse=True)
    total_us = sum(r[0] for r in rows)
    kernel_us = {name: sum(r[0] for r in rows if marker in r[2])
                 for name, marker in KERNEL_MARKERS.items()}
    shares = {name: us / total_us if total_us else None for name, us in kernel_us.items()}
    return {
        "window_ms": window_us / 1e3,
        "device_ms": total_us / 1e3,
        "device_busy_share": total_us / window_us if window_us else None,
        "flash_share_of_device": shares["flash_attn_fwd"],
        "kernel_shares_of_device": shares,
        "kernel_ms": {name: us / 1e3 for name, us in kernel_us.items()},
        "top_kernels": [
            {"name": k[:90], "calls": n, "ms": us / 1e3} for us, n, k in rows[:top]
        ],
    }


# (name, B, S, H, Hkv, head_dim, dtype, causal, dO permuted): every
# instantiation and edge of the backward kernels, against the plain version.
BWD_CASES = [
    ("train_causal", TRAIN_BATCH, TRAIN_SEQ, 16, 16, 128, torch.bfloat16, True, False),
    ("train_full", TRAIN_BATCH, TRAIN_SEQ, 16, 16, 128, torch.bfloat16, False, False),
    ("train_strided_do", TRAIN_BATCH, TRAIN_SEQ, 16, 16, 128, torch.bfloat16, True, True),
    ("gqa_16_4", TRAIN_BATCH, TRAIN_SEQ, 16, 4, 128, torch.bfloat16, True, False),
    ("gqa_16_4_full", 4, TRAIN_SEQ, 16, 4, 128, torch.bfloat16, False, False),
    ("ragged_1000", 2, 1000, 16, 16, 128, torch.bfloat16, True, False),
    ("s1", 2, 1, 16, 4, 128, torch.bfloat16, True, False),
    ("s64", 2, 64, 16, 4, 128, torch.bfloat16, True, False),
    ("s200_full", 2, 200, 16, 4, 128, torch.bfloat16, False, False),
    ("d64_gqa", 2, 1024, 16, 4, 64, torch.bfloat16, True, False),
    ("d64_ragged_1000_full", 2, 1000, 16, 16, 64, torch.bfloat16, False, False),
    ("f32_ragged_300", 2, 300, 16, 4, 128, torch.float32, True, False),
    ("f32_d64_200_full", 2, 200, 16, 4, 64, torch.float32, False, False),
]


def grad_errors(grads, plain) -> dict:
    """Largest |kernel - plain| of dq, dk and dv, and that as a share of the
    gradient's largest |value| (floored at ZERO_GRAD_FLOOR of the case's
    largest gradient)."""
    big = max(ref.abs().max().item() for ref in plain)
    errs = {}
    for gname, ours, ref in zip(("dq", "dk", "dv"), grads, plain):
        check(bool(torch.isfinite(ours).all()), f"non-finite {gname}")
        diff = (ours.float() - ref).abs().max().item()
        errs[gname] = (diff, diff / max(ref.abs().max().item(), ZERO_GRAD_FLOOR * big))
    return errs


def phase_backward(g) -> dict:
    """B1 then B2/B3 against the plain forward and backward in f32 from the
    same inputs; returns each kernel's numbers at the training shape."""
    out = None
    for name, b, s, h, hkv, d, dtype, causal, permuted in BWD_CASES:
        q, k, v = rand_qkv(g, b, s, h, hkv, d, dtype)
        do = torch.randn((b, s, h, d), generator=g, device="cuda").to(dtype)
        if permuted:  # [B, H, S, D] in memory, as autograd may hand it over
            do = do.transpose(1, 2).contiguous().transpose(1, 2)
        o, lse = flash.flash_attention_fwd(q, k, v, causal=causal)
        grads = flash.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        torch.cuda.synchronize()
        f32 = [t.float() for t in (q, k, v, do)]
        o_p, lse_p = flash.flash_attention_fwd_plain(*f32[:3], causal=causal)
        plain = flash.flash_attention_bwd_plain(*f32[:3], o_p, lse_p, f32[3], causal=causal)
        errs = grad_errors(grads, plain)
        tol = BWD_REL_TOL[dtype]
        ok = all(rel <= tol for _, rel in errs.values())
        print(f"kernel bwd {name}: {b}x{s}x{h}/{hkv}x{d} {str(dtype)[6:]} causal={causal} "
              f"dO permuted={permuted} "
              + " ".join(f"max|{n}-plain|={a:.3e} ({r:.2e} of max, tol {tol})"
                         for n, (a, r) in errs.items())
              + f" {'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"flash_attn_bwd disagrees with its plain version in case {name}")
        if name == "train_causal":
            out = time_training_shape(q, k, v, do, o, lse, o_p, errs)
        del q, k, v, do, o, lse, grads, f32, o_p, lse_p, plain
        torch.cuda.empty_cache()
    return out


def time_training_shape(q, k, v, do, o, lse, o_plain, errs) -> dict:
    """Times of B1 (forward_times), of B2 and B3 (backward_times) at the
    training shape, of the wrapper's delta pre-pass, of their plain version,
    and of the library's attention forward and backward
    (scaled_dot_product_attention, a yardstick the port never calls)."""
    bwd = backward_times(q, k, v, o, lse, do)
    delta = lambda: flash._delta(do, o)  # noqa: E731
    delta_times = dict(ms=time_ms(delta, iters=20), graph_ms=graph_ms(delta))
    bwd_plain_ms = time_ms(
        lambda: flash.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True), iters=3
    )
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    qt, kt, vt = (x.detach().requires_grad_(True) for x in (qt, kt, vt))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_fwd_ms = time_ms(lambda: sdpa(qt.detach(), kt.detach(), vt.detach(), is_causal=True),
                         iters=20)
    lib_fwd_bwd_ms = time_ms(
        lambda: torch.autograd.grad(sdpa(qt, kt, vt, is_causal=True), (qt, kt, vt), dot),
        iters=20,
    )
    bwd_bound = backward_bounds(q, k, causal=True)
    fwd_err = (o.float() - o_plain).abs().max().item()
    # The plain backward and the library's backward compute dq, dk and dv
    # together: each is the time of the pair.
    pair = dict(plain_ms=bwd_plain_ms, library_ms=lib_fwd_bwd_ms - lib_fwd_ms)
    timing = {
        "flash_attn_fwd": dict(max_abs_err=fwd_err, **forward_times(q, k, v)),
        "flash_attn_bwd_dq": dict(max_abs_err=errs["dq"][0], **bwd["flash_attn_bwd_dq"],
                                  **pair, bound_ms=bwd_bound["dq"][0],
                                  bound_by=bwd_bound["dq"][1], delta_prepass=delta_times),
        "flash_attn_bwd_dkv": dict(max_abs_err=max(errs["dk"][0], errs["dv"][0]),
                                   **bwd["flash_attn_bwd_dkv"], **pair,
                                   bound_ms=bwd_bound["dkv"][0], bound_by=bwd_bound["dkv"][1]),
    }
    print(f"kernel timing at training shape: {json.dumps(timing)}", flush=True)
    return timing


def bench_config() -> TransformerConfig:
    """bench.py's head configuration (bench.py:105-123 at seq 1024)."""
    return TransformerConfig(
        vocab_size=32000, d_model=2048, n_layers=16, n_heads=16, n_kv_heads=16, d_ff=5504,
        max_seq_len=TRAIN_SEQ, param_dtype=torch.bfloat16, remat=True,
        remat_policy="qkv_attn",
    )


def launch_counts() -> tuple:
    return (flash.flash_attention_fwd.launches, flash.flash_attention_bwd.launches_dq,
            flash.flash_attention_bwd.launches_dkv)


def zero_launch_counts() -> None:
    flash.flash_attention_fwd.launches = 0
    flash.flash_attention_bwd.launches_dq = 0
    flash.flash_attention_bwd.launches_dkv = 0


def counted_step(ctx, state, batch, expect: tuple, what: str):
    """One train step with the kernels' launch counts set to 0 just before
    it and checked just after."""
    zero_launch_counts()
    state, metrics = ctx.train_step(state, batch)
    got = launch_counts()
    check(got == expect, f"{what}: launches (fwd, dq, dkv) = {got}, expected {expect}")
    return state, metrics


def clone_state(state) -> dict:
    params = _tree_map(lambda t: t.detach().clone().requires_grad_(True), state["params"])
    opt = state["opt_state"]
    return {"params": params, "step": state["step"],
            "opt_state": {"count": opt["count"], "mu": [t.clone() for t in opt["mu"]],
                          "nu": [t.clone() for t in opt["nu"]]}}


def profile_summary(fn) -> dict:
    """One call of `fn` under the profiler, split into the port's kernels'
    device time, the rest of the device time, and the window's idle time
    (the host's, profiler included)."""
    p = profile_device(fn, top=6)
    kernels_ms = sum(p["kernel_ms"].values())
    return {"window_ms": p["window_ms"], "device_ms": p["device_ms"],
            "kernels_ms": kernels_ms, "other_device_ms": p["device_ms"] - kernels_ms,
            "idle_ms": p["window_ms"] - p["device_ms"], "kernel_ms": p["kernel_ms"],
            "top_kernels": p["top_kernels"]}


def train_batch(cfg) -> dict:
    """The training cell's global batch, on the card: one seeded draw of
    TRAIN_BATCH x (TRAIN_SEQ + 1) tokens, shifted into tokens and targets."""
    toks = torch.as_tensor(np.random.default_rng(SEED + 1).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1)), device="cuda")
    return {"tokens": toks[:, :-1].contiguous(), "targets": toks[:, 1:].contiguous()}


def phase_training(card: str) -> tuple:
    cfg = bench_config()
    ctx = LMTrainContext(cfg)
    state = ctx.init_state(SEED)  # a seeded torch.Generator on the card
    ref_state = clone_state(state)  # the optimizer updates in place
    batch = train_batch(cfg)
    per_step = (cfg.n_layers,) * 3  # qkv_attn: B1, B2 and B3 once per layer
    # remat_policy=None recomputes each layer, attention's forward included.
    none_step = (2 * cfg.n_layers, cfg.n_layers, cfg.n_layers)
    metrics = []
    for i in range(WARMUP_STEPS):
        state, m = counted_step(ctx, state, batch, per_step, f"warm-up step {i}")
        metrics.append(m)
    float(metrics[-1]["loss"])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for i in range(TIMED_STEPS):
        state, m = counted_step(ctx, state, batch, per_step, f"timed step {i}")
        metrics.append(m)
    # Each step updates the state the next reads, so reading the last loss
    # means every step has run (as bench.py syncs).
    float(metrics[-1]["loss"])
    dt = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(m["loss"]) for m in metrics]
    grad_norms = [float(m["grad_norm"]) for m in metrics]
    check(all(np.isfinite(losses + grad_norms)), f"non-finite loss or grad norm: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall over {len(losses)} steps: {losses}")

    none_ctx = LMTrainContext(dataclasses.replace(cfg, remat_policy=None))
    state, m = counted_step(none_ctx, state, batch, none_step, "remat_policy=None step")
    check(bool(torch.isfinite(m["loss"])), "non-finite loss with remat_policy=None")
    profile = profile_device(lambda: ctx.train_step(state, batch))
    del state
    torch.cuda.empty_cache()

    # The first step again from the initial state, with autograd through the
    # plain reference attention (no remat needed for the math; None keeps
    # one layer's [S, S] scores at a time).
    ref_ctx = LMTrainContext(dataclasses.replace(cfg, attention_impl="reference",
                                                 remat_policy=None))
    _, ref = counted_step(ref_ctx, ref_state, batch, (0, 0, 0), "reference-attention step")
    ref_loss, ref_gn = float(ref["loss"]), float(ref["grad_norm"])
    loss_diff = abs(losses[0] - ref_loss)
    gn_rel = abs(grad_norms[0] - ref_gn) / ref_gn
    print(f"training check: first-step loss {losses[0]:.5f} vs reference attention "
          f"{ref_loss:.5f} (|diff| {loss_diff:.2e}, tol {TRAIN_LOSS_TOL}); grad norm "
          f"{grad_norms[0]:.5f} vs {ref_gn:.5f} (rel {gn_rel:.2e}, tol {TRAIN_GRAD_NORM_RTOL})",
          flush=True)
    check(loss_diff <= TRAIN_LOSS_TOL, "first-step loss disagrees with reference attention")
    check(gn_rel <= TRAIN_GRAD_NORM_RTOL, "first-step grad norm disagrees with reference")

    tokens_per_s = TIMED_STEPS * TRAIN_BATCH * TRAIN_SEQ / dt
    n_params = cfg.num_params()
    # bench.py's accounting: 6N flops per token, plus 12*L*d*seq for the
    # score and value products (fwd and bwd) in mfu_attn_incl.
    param_flops = 6 * n_params
    attn_flops = 12 * cfg.n_layers * cfg.d_model * TRAIN_SEQ
    training = {
        "card": card,
        "config": "bench.py head: d2048 L16 H16/16 Dh128 ff5504 V32000, bf16 params and "
                  "compute, remat qkv_attn, batch 16 x seq 1024, dp on one card",
        "n_params": n_params, "warmup_steps": WARMUP_STEPS, "timed_steps": TIMED_STEPS,
        "timed_s": dt, "step_s": dt / TIMED_STEPS,
        "train_tokens_per_s": tokens_per_s,
        "mfu": param_flops * tokens_per_s / PEAK_BF16_FLOPS,
        "mfu_attn_incl": (param_flops + attn_flops) * tokens_per_s / PEAK_BF16_FLOPS,
        "peak_mem_gb": peak_gb, "losses": losses, "grad_norms": grad_norms,
        "launches_per_step": dict(zip(("fwd", "dq", "dkv"), per_step)),
        "launches_remat_none_step": dict(zip(("fwd", "dq", "dkv"), none_step)),
        "reference_first_step": {"loss": ref_loss, "grad_norm": ref_gn},
        "profile": {k: profile[k] for k in ("window_ms", "device_ms", "device_busy_share")},
    }
    print(json.dumps({"training_profile": profile}), flush=True)
    return training, per_step


# The ring's chunk schedule at bench.py's head attention shape, split as a
# ring of RING_N would split it: (name, B, H, Hkv).
RING_N = 4
RING_CASES = [("mha_16_16", TRAIN_BATCH, 16, 16), ("gqa_16_4", 4, 16, 4)]
# The ring's output against whole-sequence B1, both bf16: each row merges
# up to 4 partials, each rounded to bf16 before the f32 merge, where B1
# rounds once; 2e-2 is B1's own bound against the plain version (TOL), and
# the ring is held to it against the plain f32 version too. Its lse comes
# from the f32 partials' lse (TOL's 1e-3). Gradients sum 4 bf16 partials a
# chunk in f32 and round the sum to bf16, where the whole-sequence kernels
# round once: the two differ by up to one bf16 ulp of the largest
# |gradient| (2^-7 of it at worst; 0.51% measured at the first run, where a
# first bound of 0.5% was set too tight), so 1e-2 of the largest
# |gradient| of the whole-sequence kernels; and within BWD_REL_TOL of the
# plain backward, as B2 and B3 are held.
RING_GRAD_REL_TOL = 1e-2
# The sharded step at world size 1 against the single-device step on the
# same weights and batch: the same kernels and products, the loss in
# another form (a sum over the token count, not a mean).
SHARDED_LOSS_RTOL = 1e-3
# Its first gradient norm and its second loss against the single-device
# step's: the gradients are the same products (1/count is the mean's
# 1/numel), the norm only sums the same squares in another order (f32, a
# few ulps), and the update that the second loss reads differs from the
# single device's where that clips a bf16 rounding: 1e-5 of either.
SHARDED_STEP_RTOL = 1e-5
STRATEGIES = ("dp", "fsdp", "tp", "fsdp_tp", "sp", "ep")


def ring_schedule_check(name, b, h, hkv, g) -> tuple:
    """The ring's chunk schedule (one process, RING_N virtual ranks)
    against whole-sequence B1, B2 and B3 and the plain f32 versions, with
    its launch counts and times beside the whole-sequence kernels'."""
    q, k, v = rand_qkv(g, b, TRAIN_SEQ, h, hkv, 128, torch.bfloat16)
    do = torch.randn(q.shape, generator=g, device="cuda").to(torch.bfloat16)
    o, lse = flash.flash_attention_fwd(q, k, v, causal=True)
    whole = flash.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    zero_launch_counts()
    ring_o, ring_lse, *ring_grads = ring_schedule(q, k, v, do, n=RING_N, causal=True)
    torch.cuda.synchronize()
    launches = launch_counts()
    f32 = [t.float() for t in (q, k, v, do)]
    o_p, lse_p = flash.flash_attention_fwd_plain(*f32[:3], causal=True)
    plain = flash.flash_attention_bwd_plain(*f32[:3], o_p, lse_p, f32[3], causal=True)
    errs = {
        "o_vs_whole": (ring_o.float() - o.float()).abs().max().item(),
        "o_vs_plain": (ring_o.float() - o_p).abs().max().item(),
        "whole_o_vs_plain": (o.float() - o_p).abs().max().item(),
        "lse_vs_whole": (ring_lse - lse).abs().max().item(),
        "lse_vs_plain": (ring_lse - lse_p).abs().max().item(),
    }
    for gname, ours, ref, ref_p in zip(("dq", "dk", "dv"), ring_grads, whole, plain):
        check(bool(torch.isfinite(ours).all()), f"ring {name}: non-finite {gname}")
        errs[f"{gname}_vs_whole"] = ((ours.float() - ref.float()).abs().max()
                                     / ref.float().abs().max()).item()
        errs[f"{gname}_vs_plain"] = ((ours.float() - ref_p).abs().max()
                                     / ref_p.abs().max()).item()
    ok = (launches == (10, 10, 10) and errs["o_vs_whole"] <= TOL[torch.bfloat16][0]
          and errs["o_vs_plain"] <= TOL[torch.bfloat16][0]
          and max(errs["lse_vs_whole"], errs["lse_vs_plain"]) <= TOL[torch.bfloat16][1]
          and all(errs[f"{n}_vs_whole"] <= RING_GRAD_REL_TOL for n in ("dq", "dk", "dv"))
          and all(errs[f"{n}_vs_plain"] <= BWD_REL_TOL[torch.bfloat16] for n in ("dq", "dk", "dv")))
    print(f"ring schedule {name}: {b}x{TRAIN_SEQ}x{h}/{hkv}x128 bf16 causal, {RING_N} chunks: "
          f"launches (fwd, dq, dkv) {launches} (expected (10, 10, 10)) {json.dumps(errs)} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    check(ok, f"ring schedule {name} disagrees with the whole-sequence kernels")
    del f32, o_p, lse_p, plain, ring_o, ring_lse, ring_grads
    torch.cuda.empty_cache()
    def whole_fwd_bwd():  # B1, the delta pre-pass, B2 and B3, as a training step runs them
        o_, lse_ = flash.flash_attention_fwd(q, k, v, causal=True)
        flash.flash_attention_bwd(q, k, v, o_, lse_, do, causal=True)

    fwd_bound = attention_bound(q, k, causal=True)
    bwd_bounds = backward_bounds(q, k, causal=True)
    times = {
        "ring_fwd_ms": time_ms(lambda: ring_schedule(q, k, v, n=RING_N, causal=True), iters=20),
        "ring_fwd_bwd_ms": time_ms(lambda: ring_schedule(q, k, v, do, n=RING_N, causal=True),
                                   iters=20),
        "whole_fwd_ms": time_ms(lambda: flash.flash_attention_fwd(q, k, v, causal=True), iters=20),
        "whole_fwd_bwd_ms": time_ms(whole_fwd_bwd, iters=20),
        "fwd_bound_ms": fwd_bound[0],
        "fwd_bwd_bound_ms": fwd_bound[0] + bwd_bounds["dq"][0] + bwd_bounds["dkv"][0],
    }
    times["ring_fwd_graph_ms"] = graph_ms(lambda: ring_schedule(q, k, v, n=RING_N, causal=True),
                                          calls=5)
    times["whole_fwd_graph_ms"] = graph_ms(
        lambda: flash.flash_attention_fwd(q, k, v, causal=True), calls=5)
    # A backward binds the stream it is prepared on: graph_ms captures on
    # this side stream, where each call prepares its own.
    side = torch.cuda.Stream()
    times["ring_fwd_bwd_graph_ms"] = graph_ms(
        lambda: ring_schedule(q, k, v, do, n=RING_N, causal=True), calls=5, stream=side)
    times["whole_fwd_bwd_graph_ms"] = graph_ms(whole_fwd_bwd, calls=5, stream=side)
    print(f"ring schedule {name} times: {json.dumps(times)}", flush=True)
    if name == RING_CASES[0][0]:  # where the schedule's time goes, at the training shape
        times["profile"] = {
            "fwd": profile_summary(lambda: ring_schedule(q, k, v, n=RING_N, causal=True)),
            "fwd_bwd": profile_summary(lambda: ring_schedule(q, k, v, do, n=RING_N,
                                                             causal=True)),
            "whole_fwd_bwd": profile_summary(whole_fwd_bwd),
        }
        print(f"ring schedule {name} profile: {json.dumps(times['profile'])}", flush=True)
    return launches, {"shape": [b, TRAIN_SEQ, h, hkv, 128], "chunks": RING_N,
                      "launches": dict(zip(("fwd", "dq", "dkv"), launches)),
                      "errors": errs, **times}


def phase_parallel(card: str, training: dict) -> tuple:
    """(a) the ring's chunk schedule at full width in one process; (b) the
    sharded training step under every ported strategy at world size 1, a
    one-rank NCCL group on the card: its first loss, first gradient norm
    and second loss against the single-device step's on the same weights
    and batch, its launches, step time, peak memory and a profile of one
    step. The card's machine has one card, so no number here is of more
    than one."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    ring, ring_launches = {}, None
    for name, b, h, hkv in RING_CASES:
        launches, ring[name] = ring_schedule_check(name, b, h, hkv, g)
        ring_launches = ring_launches or launches
    torch.cuda.empty_cache()

    mesh = build_mesh(MeshSpec(data=1), device_type="cuda")
    cfg = bench_config()
    batch = train_batch(cfg)  # the single-device step's global batch
    per_step = (cfg.n_layers,) * 3
    single = {"first_loss": training["losses"][0], "first_grad_norm": training["grad_norms"][0],
              "second_loss": training["losses"][1]}
    steps, disagree = {}, []
    try:
        for strategy in STRATEGIES:
            ctx = LMTrainContext(cfg, mesh, strategy)
            state = ctx.init_state(SEED)  # the single-device step's weights
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            step_s, metrics = [], []
            for i in range(2):
                t0 = time.perf_counter()
                state, m = counted_step(ctx, state, batch, per_step, f"{strategy} step {i}")
                metrics.append((float(m["loss"]), float(m["grad_norm"])))  # waits for the step
                step_s.append(time.perf_counter() - t0)
            ours = {"first_loss": metrics[0][0], "first_grad_norm": metrics[0][1],
                    "second_loss": metrics[1][0]}
            rel = {k: abs(ours[k] - single[k]) / abs(single[k]) for k in single}
            steps[strategy] = {"step_s": step_s, "losses": [l for l, _ in metrics],
                               "grad_norms": [n for _, n in metrics],
                               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                               "rel_diff": rel}
            tols = {"first_loss": SHARDED_LOSS_RTOL, "first_grad_norm": SHARDED_STEP_RTOL,
                    "second_loss": SHARDED_STEP_RTOL}
            print(f"sharded step {strategy} (world size 1) vs single-device: "
                  + "; ".join(f"{k} {ours[k]:.6f} vs {single[k]:.6f} (rel {rel[k]:.2e}, "
                              f"tol {tols[k]})" for k in single)
                  + f"; step s {step_s}; peak {steps[strategy]['peak_mem_gb']:.2f} GB", flush=True)
            check(all(np.isfinite(metrics[0] + metrics[1])), f"{strategy}: non-finite metrics")
            disagree += [f"{strategy}: {k}" for k in single if not rel[k] <= tols[k]]
            steps[strategy]["profile"] = profile_summary(lambda: ctx.train_step(state, batch))
            print(f"sharded step {strategy} profile: "
                  f"{json.dumps(steps[strategy]['profile'])}", flush=True)
            del ctx, state
            torch.cuda.empty_cache()
        check(not disagree, f"the sharded step disagrees with one device: {disagree}")
    finally:
        dist.destroy_process_group()
    parallel = {
        "card": card,
        "world_size": 1,
        "note": "one card: ring schedule in one process, sharded step at world size 1 "
                "(collectives over one rank are skipped); no multi-GPU number",
        "ring_schedule": ring,
        "sharded_step": {"config": training["config"].replace("dp on one card", "on a "
                                                              "one-rank mesh"),
                         "launches_per_step": dict(zip(("fwd", "dq", "dkv"), per_step)),
                         "single_device": {**single, "profile": training["profile"]},
                         "strategies": steps},
    }
    return parallel, ring_launches, per_step


LIBRARIES = {"flash_attn_fwd": flash.SOURCE, "flash_attn_bwd": flash.BWD_SOURCE}
# Every bf16 kernel must run on wgmma (HGMMA in SASS), not mma.sync (HMMA),
# and spill nothing.
WGMMA_KERNELS = tuple(KERNEL_MARKERS.values())


def _kernel_label(symbol: str) -> str:
    """`fwd_wgmma_kernel<128>` from a mangled symbol such as
    _ZN50_GLOBAL__N__..._cu_cd4330bb16fwd_wgmma_kernelILi128EEEvNS_9TmaParamsE:
    the name is the length-prefixed identifier followed by its template
    argument."""
    for m in re.finditer(r"\d+", symbol):
        for i in range(len(m.group())):  # a hash's digits may run into the length
            n = int(m.group()[i:])
            name = symbol[m.end():m.end() + n]
            arg = re.match(r"ILi(\d+)E", symbol[m.end() + n:])
            if name.endswith("_kernel") and arg:
                return f"{name}<{arg.group(1)}>"
    return symbol


def ptxas_report() -> dict:
    """Registers, static shared memory and spills of every kernel, from the
    `-Xptxas -v` output of the builds."""
    report = {}
    for name in LIBRARIES:
        label = None
        for line in _build.build_logs[name].splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                label = _kernel_label(m.group(1))
                report[label] = {}
                continue
            if label is None:
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                report[label]["spill_stores"] = int(m.group(1))
                report[label]["spill_loads"] = int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                report[label]["registers"] = int(m.group(1))
                sm = re.search(r"(\d+) bytes smem", line)
                report[label]["static_smem"] = int(sm.group(1)) if sm else 0
    for d in flash.HEAD_DIMS:
        for lib, fn, kernel in (("flash_attn_fwd", "flash_attn_fwd_smem_bytes", "fwd_wgmma_kernel"),
                                ("flash_attn_bwd", "flash_attn_bwd_dq_smem_bytes",
                                 "dq_wgmma_kernel"),
                                ("flash_attn_bwd", "flash_attn_bwd_dkv_smem_bytes",
                                 "dkv_wgmma_kernel")):
            entry = report.setdefault(f"{kernel}<{d}>", {})
            entry["dynamic_smem"] = getattr(_build._loaded[lib], fn)(d)
    return report


def sass_report() -> dict:
    """Tensor-core instructions of every kernel in the built libraries'
    SASS (HGMMA is wgmma, HMMA is mma.sync) and the register counts its
    setmaxnreg instructions hand over (ptxas reports only the count at
    entry). Empty where the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        print("sass: no cuobjdump in this toolkit; HGMMA not counted", flush=True)
        return {}
    report = {}
    for name in LIBRARIES:
        out = subprocess.run([tool, "-sass", str(_build.library_paths[name])],
                             capture_output=True, text=True, timeout=300, check=True).stdout
        label = None
        for line in out.splitlines():
            if "Function :" in line:
                label = _kernel_label(line.split("Function :")[1].strip())
                report[label] = {"HGMMA": 0, "HMMA": 0}
            elif label is not None:
                for op in ("HGMMA", "HMMA"):
                    if re.search(rf"\b{op}\.", line):
                        report[label][op] += 1
                m = re.search(r"SETMAXREG\.(\w+)\S*\s[^;]*?(0x[0-9a-f]+)", line)
                if m:
                    report[label].setdefault("setmaxnreg", {})[m.group(1).lower()] = int(
                        m.group(2), 16)
    return report


def build_kernels() -> dict:
    """Build every kernel library, one nvcc per source, started together;
    print and check each kernel's registers, shared memory and spills and,
    where cuobjdump exists, its tensor-core instructions."""
    errors = []

    def build(name, source):
        try:
            _build.load_library(name, [source])
        except Exception as e:  # noqa: BLE001 - reported and failed below
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=build, args=item) for item in LIBRARIES.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    check(not errors, f"build failed: {errors[:1]!r}")
    check(not any(t.is_alive() for t in threads), "a build did not finish")
    print(f"build: {', '.join(LIBRARIES)} in {time.perf_counter() - t0:.1f} s ("
          + ", ".join(f"nvcc {n} {_build.build_seconds[n]:.1f} s" for n in LIBRARIES) + ")",
          flush=True)
    ptxas, sass = ptxas_report(), sass_report()
    for label in sorted(ptxas):
        print(f"ptxas: {label}: {json.dumps(ptxas[label])}"
              + (f" sass: {json.dumps(sass[label])}" if label in sass else ""), flush=True)
    for kernel in WGMMA_KERNELS:
        for d in flash.HEAD_DIMS:
            label = f"{kernel}<{d}>"
            check(ptxas[label].get("spill_stores") == 0 and ptxas[label].get("spill_loads") == 0,
                  f"{label} spills: {ptxas[label]}")
            if sass:
                check(sass[label]["HGMMA"] > 0 and sass[label]["HMMA"] == 0,
                      f"{label} is not all wgmma: {sass[label]}")
    return {"ptxas": ptxas, "sass": sass}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    compiled = build_kernels()
    g = torch.Generator(device="cuda").manual_seed(SEED)
    timing = phase_kernels(g)
    torch.cuda.empty_cache()

    serving, serve_launches = phase_serving(card)
    print(json.dumps({"serving": serving}), flush=True)
    torch.cuda.empty_cache()

    train_timing = phase_backward(g)
    training, train_launches = phase_training(card)
    print(json.dumps({"training": training}), flush=True)
    torch.cuda.empty_cache()

    parallel, ring_launches, sharded_launches = phase_parallel(card, training)
    print(json.dumps({"parallel": parallel}), flush=True)

    source = "ray_tpu_torch/csrc/"
    kernels = [
        {"name": "flash_attn_fwd", "route": "cuda", "source": source + flash.SOURCE,
         "replaces": "ray_tpu/ops/pallas/flash_attention.py:55",
         "design": "fwd_wgmma_kernel: warp-specialised, a producer warpgroup (setmaxnreg "
                   "24) loads by TMA into 3-stage k/v rings with mbarriers; 2 consumer "
                   "warpgroups (setmaxnreg 240) x 64 q rows, wgmma (S=qk^T from shared "
                   "memory, O+=Pv with P from registers), online softmax in exp2 "
                   "overlapping the next S, 128-row kv tiles, o out through shared memory "
                   "by TMA store",
         "launches": serve_launches,
         "launches_by_path": {"serving": serve_launches, "train_step": train_launches[0],
                              "ring_schedule": ring_launches[0],
                              "sharded_train_step": sharded_launches[0]},
         **timing, "at_training_shape": train_timing["flash_attn_fwd"]},
        {"name": "flash_attn_bwd_dq", "route": "cuda", "source": source + flash.BWD_SOURCE,
         "replaces": "ray_tpu/ops/pallas/flash_attention.py:151",
         "design": "dq_wgmma_kernel: warp-specialised, a producer warpgroup (setmaxnreg "
                   "24) loads q/dO once and 64-row k/v tiles through a 3-stage ring by TMA "
                   "with mbarriers; 2 consumer warpgroups (setmaxnreg 240) x 64 q rows, "
                   "lse/delta in registers, wgmma for S, dP (shared memory) and dq (dS from "
                   "registers, k read transposed), S/dP of the next tile issued ahead of "
                   "dS k of this one",
         "launches": train_launches[1],
         "launches_by_path": {"serving": 0, "train_step": train_launches[1],
                              "ring_schedule": ring_launches[1],
                              "sharded_train_step": sharded_launches[1]},
         **train_timing["flash_attn_bwd_dq"]},
        {"name": "flash_attn_bwd_dkv", "route": "cuda", "source": source + flash.BWD_SOURCE,
         "replaces": "ray_tpu/ops/pallas/flash_attention.py:199",
         "design": "dkv_wgmma_kernel: warp-specialised, a producer warpgroup (setmaxnreg "
                   "24) loads k/v once and q/dO through a 3-stage ring by TMA with mbarriers; "
                   "2 consumer warpgroups (setmaxnreg 240) x 64 kv rows, lse/delta by "
                   "cp.async a tile ahead, wgmma for S^T, dP^T (shared memory) and dV, dK "
                   "(P^T, dS^T from registers)",
         "launches": train_launches[2],
         "launches_by_path": {"serving": 0, "train_step": train_launches[2],
                              "ring_schedule": ring_launches[2],
                              "sharded_train_step": sharded_launches[2]},
         **train_timing["flash_attn_bwd_dkv"]},
    ]
    for entry in kernels:
        symbol = KERNEL_MARKERS[entry["name"]]
        entry["compiled"] = {f"{symbol}<{d}>": {**compiled["ptxas"].get(f"{symbol}<{d}>", {}),
                                                **compiled["sass"].get(f"{symbol}<{d}>", {})}
                             for d in flash.HEAD_DIMS}
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}), flush=True)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    modes = {"--forward-times": main_forward_times, "--backward-times": main_backward_times}
    sys.exit(modes.get(" ".join(sys.argv[1:]), main)())
