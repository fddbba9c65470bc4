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
   (FWD_CASES: head_dim 128 and 64, S = 1, 64, 200, 512, 1000, 1024 and
   2048, batch 1 to 16, 8, 16 and 32 heads, GQA, causal and not, bf16 and
   f32, and every shape the later phases give the kernel), with times at the serving shape of the
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
   64, S = 1, 64, 200, 1000, 1024 and 2048, batch 1 to 16, GQA, causal and
   not, bf16 and f32, and every shape the later phases give the kernels),
   with times of each kernel at the training shape (CUDA events around
   eager calls and CUDA-graph replays), of the wrapper's delta pre-pass,
   the plain backward and the library's backward; and 10 repeats of B1, B2,
   B3 and a GEMM at the training shape, which must equal the first call
   bit for bit;
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
   dp, fsdp, tp, fsdp_tp, sp, ep, pp and pp_fsdp on a one-rank NCCL mesh at
   bench.py's head configuration, 2 steps each with exact launch counts,
   the first loss against the single-device step's, step times and peak
   memory;
7. pipeline and experts: (b) the GPipe (`pipeline_apply`, autograd through
   it) and 1F1B (`pipeline_train_step_1f1b`) schedules of bench.py's head
   configuration cut into 4 stages of 4 layers, all in one process, at
   batch 16 x 1024 with M = 16 and 4 microbatches, against the unpipelined
   forward and backward: exact launches, loss, gradient norm and each
   stage's gradients, times and peak memory, 1F1B's peak below GPipe's at
   M = 16, and a profile of GPipe at M = 16; (c) `moe_ffn` at Mixtral-8x7B's expert width (bf16, x [4, 2048,
   4096]) forward and backward against the same block in f32, under `ep`
   on the one-rank mesh against the plain call, times, peak memory and the
   dense dispatch and combine against the expert products; (d)
   `dryrun.entry()`'s forward with 8 B1 launches; and the memory of one
   training layer of the 7B step at an fsdp=8 rank's batch;
8. the RL learners with their env runners on the card, in this process:
   (a) PPO at tests/test_rllib.py::test_ppo_cartpole_learns's
   configuration (2 EnvRunners x 8 CartPoles x 64 steps, 8 epochs x 8
   minibatches) until the mean return reaches 120 (at most 100
   iterations), with each update's CUDA-event time and host issue time and
   the env steps/s; (b) one IMPALA and one APPO update through
   LearnerGroup(num_learners=1) on the one-rank NCCL group; (c) DQN's
   update_many over 4 batches of 32 and sync_target; (d) one SAC update on
   Pendulum transitions; each of (a)-(d) held against the same update on
   the CPU from the same state, batch and draws; (e) one multi-agent PPO
   iteration with a shared and with independent policies; then (f) the
   training state of bench.py's head configuration (bf16, full width and
   depth) saved with Checkpoint.from_torch_state_sharded on the one-rank
   mesh into a directory beside this script (removed after), restored with
   get_torch_state, and a step from it against a step from the unbroken
   state: bit for bit, 16/16/16 launches; bytes, times and GB/s;
9. the port's actor runtime and the trainer on it: (a) ray_tpu_torch.init
   detects the card as the "GPU" resource and a num_gpus=1 task returns
   the card's name from a worker that loaded nothing of the JAX package;
   (b) TorchTrainer with one worker actor holding the card (TorchConfig:
   a one-rank NCCL group) trains phase 5's configuration, seed and batch
   for 4 steps, reporting through the session, with a sharded checkpoint
   after step 2 and a failure after step 3 on the first attempt; the group
   restarts from the checkpoint and runs steps 3 and 4. Every step equals
   phase 5's step of its number bit for bit with 16/16/16 launches, and
   the run's checkpoint restores here to a step equal to the resumed one;
   times of fit(), the first report, the restart and the worker's step;
10. the serve stack and the batch predictor at phase 3's width, weights and
   prompts: (a) `serve.run` deploys llama_1b in one replica actor that
   holds the card (num_gpus=1), and the 16 prompts go concurrently through
   the deployment's handle, the router and `@serve.batch(max_batch_size=8)`;
   (b) the same prompts are POSTed from 16 threads to the HTTP proxy; (c)
   the weights are written as a port Checkpoint beside this script (removed
   after) and BatchPredictor runs the prompts in batches of 8 in one
   predictor actor on the card. The replica and the actor launch B1 once a
   layer a batch and this process never; every batch they ran, rebuilt here
   in the order they report, gives their logits bit for bit, within
   LOGIT_TOL of the plain reference attention; HTTP names the handle's
   token wherever the top-2 gap exceeds LOGIT_TOL; neither process loads
   the JAX package; and B1 is held against its plain version at every
   batch size it met. Times of serve.run, the first answer, each request
   through the handle and through HTTP, the replica's batches on the card,
   its peak memory, and predict() with its checkpoint load.

Prints JSON lines of the serving and training numbers, the profiles, the
pipeline and experts, the RL learners, the checkpoint, the trainer, the
serve stack and the kernels, and last {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

import ray_tpu_torch
from ray_tpu_torch import dryrun, serve
from ray_tpu_torch.air import BatchPredictor, Checkpoint, Predictor
from ray_tpu_torch.models import (
    LMTrainContext,
    MoEConfig,
    TransformerConfig,
    cross_entropy_loss,
    forward,
    init_moe_params,
    init_params,
    moe_ffn,
)
from ray_tpu_torch.models import moe, transformer
from ray_tpu_torch.ops.cuda import _build
from ray_tpu_torch.ops.cuda import flash_attention as flash
from ray_tpu_torch.ops.ring_attention import ring_schedule
from ray_tpu_torch.parallel import (
    MeshSpec,
    build_mesh,
    pipeline_apply,
    pipeline_train_step_1f1b,
    resolve_rules,
)
from ray_tpu_torch.parallel.sharding import tree_leaves, tree_map
from ray_tpu_torch.rllib import (
    APPOConfig,
    ContinuousReplayBuffer,
    DQNConfig,
    EnvRunner,
    IMPALAConfig,
    LearnerGroup,
    MultiAgentCartPole,
    MultiAgentEnvRunner,
    MultiAgentPPOConfig,
    PPOConfig,
    ReplayBuffer,
    SACConfig,
    SampleBatch,
    make_appo_learner,
    make_impala_learner,
    make_policy_learners,
    make_sac_learner,
)
from ray_tpu_torch.rllib import dqn, ppo, sac
from ray_tpu_torch.rllib.sample_batch import ACTIONS, ADVANTAGES, LOGPS, OBS, RETURNS

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
    # The shapes the main paths of phase 7 give B1: a 1F1B or GPipe
    # microbatch of bench.py's head configuration at M = 16 and 4,
    # dryrun.entry()'s forward, and one layer of the 7B step.
    ("pp_m16", 1, 1024, 16, 16, 128, torch.bfloat16, True),
    ("pp_m4", 4, 1024, 16, 16, 128, torch.bfloat16, True),
    ("entry", 4, 512, 8, 8, 128, torch.bfloat16, True),
    ("llama_7b_layer", 1, 2048, 32, 32, 128, torch.bfloat16, True),
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


def check_fwd_case(g, name, b, s, h, hkv, d, dtype, causal) -> tuple:
    """B1 against its plain version at one shape, from random inputs;
    returns the largest error in o and the inputs."""
    q, k, v = rand_qkv(g, b, s, h, hkv, d, dtype)
    o, lse = flash.flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    o_p, lse_p = flash.flash_attention_fwd_plain(q.float(), k.float(), v.float(), causal=causal)
    err_o = (o.float() - o_p).abs().max().item()
    err_lse = (lse - lse_p).abs().max().item()
    tol_o, tol_lse = TOL[dtype]
    ok = err_o <= tol_o and err_lse <= tol_lse and torch.isfinite(o).all().item()
    print(f"kernel {name}: {b}x{s}x{h}/{hkv}x{d} {str(dtype)[6:]} causal={causal} "
          f"max|o-plain|={err_o:.3e} (tol {tol_o}) max|lse-plain|={err_lse:.3e} "
          f"(tol {tol_lse}) {'ok' if ok else 'FAIL'}", flush=True)
    check(ok, f"flash_attn_fwd disagrees with its plain version in case {name}")
    return err_o, (q, k, v)


def phase_kernels(g) -> dict:
    """B1 against its plain version; returns the serving-shape numbers."""
    serving = None
    for case in FWD_CASES:
        err_o, qkv = check_fwd_case(g, *case)
        if case[0] == "serving_causal":
            serving = dict(max_abs_err=err_o, **forward_times(*qkv))
            print(f"kernel timing at serving shape: {json.dumps(serving)}", flush=True)
        del qkv
    return serving


def llama_1b_params(cfg: TransformerConfig) -> dict:
    """Phase 3's weights: llama_1b drawn from the seeded generator on the
    card and cast to the compute dtype once at load (forward casts each
    weight to it at use, so the rounding is the same)."""
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    return tree_map(lambda t: t.to(cfg.dtype), params)


def serving_prompts(cfg: TransformerConfig) -> list:
    """Phase 3's prompts: N_REQUESTS lists of PROMPT_LEN token ids from SEED."""
    return np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (N_REQUESTS, PROMPT_LEN)).tolist()


class LMServer:
    """A replica holding the decoder: next-token prediction for a batch of
    equal-length prompts in one forward, as in
    tests/test_serve.py::test_batched_jax_inference."""

    def __init__(self, cfg: TransformerConfig, params):
        self.cfg = cfg
        self.params = params
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


def phase_serving(card: str) -> tuple:
    cfg = TransformerConfig.llama_1b()
    server = LMServer(cfg, llama_1b_params(cfg))
    torch.cuda.empty_cache()
    prompts = serving_prompts(cfg)
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
    zero_launch_counts()
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    check(not errors, f"request failed: {errors[:1]!r}")
    check(not any(t.is_alive() for t in threads), "a request did not finish")
    check(all(isinstance(o, int) and 0 <= o < cfg.vocab_size for o in outs), "bad answers")

    n_batches = len(server.batches)
    check(sum(b[0] for b in server.batches) == N_REQUESTS, "requests lost in batching")
    check(launches == (cfg.n_layers * n_batches, 0, 0),
          f"flash kernels launched {launches} times for {n_batches} batches "
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
        "peak_mem_gb": peak_gb, "flash_launches": launches[0],
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
    # The shapes the main paths of phase 7 give B2 and B3 (see FWD_CASES).
    ("pp_m16", 1, TRAIN_SEQ, 16, 16, 128, torch.bfloat16, True, False),
    ("pp_m4", 4, TRAIN_SEQ, 16, 16, 128, torch.bfloat16, True, False),
    ("llama_7b_layer", 1, 2048, 32, 32, 128, torch.bfloat16, True, False),
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


# Repeats of B1, B2/B3 and a GEMM of the step's width on the same inputs,
# compared bit for bit with the first call. All are deterministic by design,
# and the checks of phases 5 and 6 at 1e-5 assume it; one machine gave
# repeats that differed (PERF.md §7). The check fails here, naming what did
# not repeat, before a later check fails for it without saying why.
REPEATS = 10


def reproducibility(q, k, v, do) -> dict:
    o0, lse0 = flash.flash_attention_fwd(q, k, v, causal=True)
    g0 = flash.flash_attention_bwd(q, k, v, o0, lse0, do, causal=True)
    a, w = q.reshape(-1, q.shape[2] * q.shape[3]), v.reshape(-1, q.shape[2] * q.shape[3])
    w = w[:a.shape[1]]
    c0 = a @ w
    differ = {"fwd": 0, "dq": 0, "dk": 0, "dv": 0, "gemm": 0}
    for _ in range(REPEATS):
        o, lse = flash.flash_attention_fwd(q, k, v, causal=True)
        differ["fwd"] += not (torch.equal(o, o0) and torch.equal(lse, lse0))
        for name, ours, first in zip(("dq", "dk", "dv"),
                                     flash.flash_attention_bwd(q, k, v, o0, lse0, do, causal=True),
                                     g0):
            differ[name] += not torch.equal(ours, first)
        differ["gemm"] += not torch.equal(a @ w, c0)
    out = {"repeats": REPEATS, "differing": differ}
    print(f"reproducibility at the training shape: {json.dumps(out)}", flush=True)
    names = {"fwd": "B1", "dq": "B2", "dk": "B3", "dv": "B3", "gemm": "the cuBLAS GEMM"}
    check(not any(differ.values()), "repeats differ bit for bit: " + ", ".join(
        f"{names[k]} ({k}) in {n} of {REPEATS}" for k, n in differ.items() if n))
    return out


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
            reproducibility(q, k, v, do)
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


# The names of launch_counts()' three counts, as columns of a table.
LAUNCH_KEYS = ("launches", "launches_dq", "launches_dkv")


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
    params = tree_map(lambda t: t.detach().clone().requires_grad_(True), state["params"])
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
STRATEGIES = ("dp", "fsdp", "tp", "fsdp_tp", "sp", "ep", "pp", "pp_fsdp")


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


# -- phase 7: pipeline and experts ----------------------------------------------

# The pipeline schedules at bench.py's head configuration, its 16 layers cut
# into PP_STAGES stages of 4, all in one process (one card): M = 16, the
# derived count at batch 16 (the largest divisor up to 4P), and M = 4.
PP_STAGES = 4
PP_MICROBATCHES = (16, 4)
# Against the unpipelined forward and backward on the same weights and
# batch, both bf16 with the same kernels: a schedule runs each row's
# products on microbatches of 16 / M rows, whose matmuls take other tile
# shapes and summation orders, and sums the parameters' gradients over the
# microbatches in f32. The loss, a mean over 16,384 tokens, within 1e-3
# relative; the gradient norm, and each stage's gradients (the norm of the
# difference over the norm of the unpipelined stage's), within 1e-2 relative:
# bf16 products of other shapes differ by an ulp (2^-8) in places.
PP_LOSS_RTOL = 1e-3
PP_GRAD_RTOL = 1e-2

# Mixtral-8x7B's expert width (mistralai/Mixtral-8x7B-v0.1 config.json:
# hidden_size 4096, intermediate_size 14336, num_local_experts 8,
# num_experts_per_tok 2), the JAX package's capacity_factor 1.25, on
# x [4, 2048, 4096].
MIXTRAL = dict(n_experts=8, top_k=2, d_model=4096, d_ff=14336, capacity_factor=1.25)
MOE_SHAPE = (4, 2048)
# The bf16 block against the same block in f32 on the same (bf16-valued)
# weights and x. bf16 routing logits can flip a near-tie top-2 choice, and a
# flip moves the queue positions after it and so the drops at the capacity
# edge: such tokens take other experts and are no rounding error. Their
# share is held to MOE_FLIP_SHARE; the rest, routed alike in both, to
# MOE_Y_TOL of the largest |y| (the bf16 block rounds g, u, h, the down
# product and the gates to bf16, 2^-9 relative each, and sums two experts);
# the gradients, with the flipped rows' cotangents set to 0 in both runs,
# to MOE_GRAD_RTOL in the norm of the difference over the f32 norm per leaf
# (bf16 products over 2560-14336 terms); the aux loss, whose top-1 shares
# move with the flips, to MOE_FLIP_SHARE relative.
MOE_FLIP_SHARE = 5e-2
MOE_Y_TOL = 3e-2
MOE_GRAD_RTOL = 3e-2


def _loss_and_grads(cfg, params, batch, schedule: str, m: int = 0):
    """(loss, layer-leaf gradients) of one forward and backward of `cfg`'s
    decoder on `batch`: unpipelined, or its layers as a GPipe or 1F1B
    schedule of PP_STAGES stages in one process, embedding and head around
    it. The 1F1B step computes no embedding or head gradient."""
    layers = tree_leaves(params["layers"])
    positions = torch.arange(batch["tokens"].shape[1], device="cuda")
    def head(y, t):
        return cross_entropy_loss(transformer._logits(params, y, cfg, None), t)

    if schedule == "unpipelined":
        loss = cross_entropy_loss(forward(params, batch["tokens"], cfg), batch["targets"])
        return loss.detach(), torch.autograd.grad(loss, layers)
    stage = transformer.pipeline_stage(cfg, positions)
    stacked = transformer.stack_stages(params["layers"], PP_STAGES)
    x = transformer._embed(params, batch["tokens"], cfg, None)
    if schedule == "gpipe":
        loss = head(pipeline_apply(stage, stacked, x, n_microbatches=m), batch["targets"])
        return loss.detach(), torch.autograd.grad(loss, layers)
    loss, grads = pipeline_train_step_1f1b(stage, head, stacked, x.detach(), batch["targets"],
                                           n_microbatches=m)
    return loss, [g.reshape(w.shape) for g, w in zip(tree_leaves(grads), layers)]


def _grad_norm(grads) -> float:
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g, dtype=torch.float32) for g in grads])).item()


def _stage_rel_errors(grads, ref) -> list:
    """Per stage: |ours - unpipelined| / |unpipelined| over its layers."""
    out = []
    for s in range(PP_STAGES):
        part = lambda g: g.reshape(PP_STAGES, -1)[s].float()  # noqa: E731
        diff = _grad_norm([part(a) - part(b) for a, b in zip(grads, ref)])
        out.append(diff / _grad_norm([part(b) for b in ref]))
    return out


def _timed_run(fn):
    """fn()'s result, its host time to a synchronize, its peak memory, and
    the host's time to issue it (to fn's return, the card running behind:
    where it is close to the first, the host sets the time)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    issued = time.perf_counter() - t0
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 1e9, issued


def pipeline_schedules() -> tuple:
    """GPipe and 1F1B in one process at bench.py's head configuration
    against the unpipelined forward and backward: exact launches, loss and
    gradients, times (the second of two runs each) and peak memory."""
    cfg = bench_config()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    batch = train_batch(cfg)
    L = cfg.n_layers
    zero_launch_counts()
    unpipelined = lambda: _loss_and_grads(cfg, params, batch, "unpipelined")  # noqa: E731
    (ref_loss, ref), _, ref_peak, _ = _timed_run(unpipelined)
    check(launch_counts() == (L, L, L), f"unpipelined launches {launch_counts()}")
    _, ref_s, _, ref_issue = _timed_run(unpipelined)
    ref_norm = _grad_norm(ref)
    out = {"config": "bench.py head (d2048 L16 H16/16 ff5504 V32000, bf16, remat qkv_attn), "
                     f"batch {TRAIN_BATCH} x {TRAIN_SEQ}, {PP_STAGES} stages of "
                     f"{L // PP_STAGES} layers in one process",
           "unpipelined": {"loss": float(ref_loss), "grad_norm": ref_norm, "s": ref_s,
                           "host_issue_s": ref_issue, "peak_mem_gb": ref_peak}}
    launches, bad = {}, []
    for schedule in ("gpipe", "1f1b"):
        for m in PP_MICROBATCHES:
            expect = ((m * L // PP_STAGES * (2 * PP_STAGES - 1)) if schedule == "1f1b"
                      else m * L, m * L, m * L)
            run = lambda: _loss_and_grads(cfg, params, batch, schedule, m)  # noqa: E731
            zero_launch_counts()
            (loss, grads), _, peak, _ = _timed_run(run)
            got = launch_counts()
            _, secs, _, issued = _timed_run(run)
            loss_rel = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
            norm_rel = abs(_grad_norm(grads) - ref_norm) / ref_norm
            stage_rel = _stage_rel_errors(grads, ref)
            row = {"m": m, "launches": dict(zip(("fwd", "dq", "dkv"), got)),
                   "expected_launches": dict(zip(("fwd", "dq", "dkv"), expect)),
                   "loss": float(loss), "loss_rel": loss_rel, "grad_norm_rel": norm_rel,
                   "stage_grad_rel": stage_rel, "s": secs, "s_over_unpipelined": secs / ref_s,
                   "host_issue_s": issued, "peak_mem_gb": peak}
            if (schedule, m) == ("gpipe", PP_MICROBATCHES[0]):  # where its time goes
                row["profile"] = profile_summary(run)
            print(f"pipeline {schedule} M={m}: {json.dumps(row)}", flush=True)
            out[f"{schedule}_m{m}"] = row
            if got != expect:
                bad.append(f"{schedule} M={m}: launches {got}, expected {expect}")
            if not (loss_rel <= PP_LOSS_RTOL and norm_rel <= PP_GRAD_RTOL
                    and max(stage_rel) <= PP_GRAD_RTOL):
                bad.append(f"{schedule} M={m}: loss {loss_rel:.2e}, grad norm {norm_rel:.2e}, "
                           f"stages {stage_rel}")
            launches.setdefault(schedule, got)
            del grads
            torch.cuda.empty_cache()
    check(not bad, f"pipeline schedules: {bad}")
    m = PP_MICROBATCHES[0]
    check(out[f"1f1b_m{m}"]["peak_mem_gb"] < out[f"gpipe_m{m}"]["peak_mem_gb"],
          f"1F1B's peak is not below GPipe's at M={m}")
    return out, launches


def _moe_kept(params, x, cfg) -> torch.Tensor:
    """[T, E]: which experts keep each token, as moe_ffn routes it."""
    tokens = x.reshape(-1, x.shape[-1])
    kept = moe._route(tokens, params["router"].to(x.dtype), cfg,
                      moe._capacity(cfg, tokens.shape[0]))[2]
    return kept.sum(dim=1) > 0


def _moe_fwd_bwd(params, x, r, cfg):
    y, aux = moe_ffn(params, x, cfg)
    grads = torch.autograd.grad(torch.sum(y.float() * r) + aux, list(params.values()) + [x])
    return y.detach(), aux.detach(), grads


def moe_at_mixtral_width(mesh) -> dict:
    """moe_ffn at Mixtral-8x7B's expert width, bf16, against the same block
    in f32; under `ep` on the one-rank mesh against the plain call; times,
    peak memory, and the dense dispatch and combine against the experts."""
    cfg = MoEConfig(**MIXTRAL)
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    params = init_moe_params(cfg, g, device="cuda", dtype=torch.bfloat16)
    x = torch.randn(MOE_SHAPE + (cfg.d_model,), generator=g, device="cuda").to(torch.bfloat16)
    r = torch.randn(x.shape, generator=g, device="cuda")
    p32 = {k: v.float().requires_grad_(True) for k, v in params.items()}
    x32 = x.float().requires_grad_(True)
    for v in params.values():
        v.requires_grad_(True)
    x.requires_grad_(True)
    with torch.no_grad():
        alike = (_moe_kept(params, x, cfg) == _moe_kept(p32, x32, cfg)).all(dim=-1)
    flip_share = 1.0 - alike.float().mean().item()
    r = r * alike.reshape(MOE_SHAPE + (1,))  # flipped rows drop out of both objectives
    (y, aux, grads), _, peak, _ = _timed_run(lambda: _moe_fwd_bwd(params, x, r, cfg))
    secs = [_timed_run(lambda: _moe_fwd_bwd(params, x, r, cfg))[1] for _ in range(3)]
    (y32, aux32, grads32), secs32, peak32, _ = _timed_run(lambda: _moe_fwd_bwd(p32, x32, r, cfg))
    rows = alike.reshape(MOE_SHAPE)
    y_err = ((y.float() - y32)[rows].abs().max() / y32.abs().max()).item()
    aux_rel = abs(aux.item() - aux32.item()) / aux32.item()
    grad_rel = {name: (torch.linalg.vector_norm(a.float() - b) / torch.linalg.vector_norm(b)).item()
                for name, a, b in zip(list(params) + ["x"], grads, grads32)}
    del grads32, p32, x32, y32
    torch.cuda.empty_cache()
    with torch.no_grad():
        plain = moe_ffn(params, x, cfg)
        ep = moe_ffn(params, x, cfg, rules=resolve_rules("ep"), mesh=mesh)
    ep_equal = torch.equal(plain[0], ep[0]) and torch.equal(plain[1], ep[1])
    # The forward's three parts at its own shapes: the dense dispatch
    # einsum, the expert products, the dense combine einsum.
    with torch.no_grad():
        tokens = x.detach().reshape(-1, cfg.d_model)
        T = tokens.shape[0]
        cap = moe._capacity(cfg, T)
        _, gates, onehot, position = moe._route(tokens, params["router"], cfg, cap)
        pos = torch.einsum("tke,tke->tk", position, onehot).to(torch.int64)
        combine = torch.einsum("tk,tke,tkc->tec", gates, onehot,
                               torch.nn.functional.one_hot(pos, cap).to(torch.float32))
        dispatch = (combine > 0).to(torch.bfloat16)
        combine = combine.to(torch.bfloat16)
        expert_in = torch.einsum("td,tec->ecd", tokens, dispatch)
        w = {k: v.detach() for k, v in params.items()}

        def experts():
            h = (torch.nn.functional.silu(torch.einsum("ecd,edf->ecf", expert_in, w["w_gate"]))
                 * torch.einsum("ecd,edf->ecf", expert_in, w["w_up"]))
            return torch.einsum("ecf,efd->ecd", h, w["w_down"])

        expert_out = experts()
        parts_ms = {
            "dispatch": time_ms(lambda: torch.einsum("td,tec->ecd", tokens, dispatch), iters=5),
            "experts": time_ms(experts, iters=5),
            "combine": time_ms(lambda: torch.einsum("ecd,tec->td", expert_out, combine), iters=5),
        }
        forward_ms = time_ms(lambda: moe_ffn(params, x, cfg), iters=5)
    profile = profile_summary(lambda: moe_ffn(params, x, cfg))
    out = {"source": "mistralai/Mixtral-8x7B-v0.1 config.json (hidden 4096, intermediate "
                     "14336, 8 experts, top-2); capacity_factor 1.25",
           "x": list(x.shape), "capacity": cap, "flip_share": flip_share,
           "y_err_share_of_max": y_err, "aux_rel": aux_rel, "grad_rel": grad_rel,
           "bounds": {"flip_share": MOE_FLIP_SHARE, "y": MOE_Y_TOL, "grad": MOE_GRAD_RTOL,
                      "aux": MOE_FLIP_SHARE},
           "fwd_bwd_s": secs, "fwd_bwd_s_f32": secs32, "peak_mem_gb": peak,
           "peak_mem_gb_f32": peak32, "forward_ms": forward_ms, "parts_ms": parts_ms,
           "dispatch_combine_share": (parts_ms["dispatch"] + parts_ms["combine"])
           / sum(parts_ms.values()),
           "ep_one_rank_equal": ep_equal,
           "profile_forward": {k: profile[k] for k in ("window_ms", "device_ms", "idle_ms",
                                                       "top_kernels")}}
    print(f"moe at Mixtral width: {json.dumps(out)}", flush=True)
    check(flip_share <= MOE_FLIP_SHARE, f"moe: {flip_share:.3%} of tokens routed differently")
    check(y_err <= MOE_Y_TOL, f"moe: y off by {y_err:.2e} of max on rows routed alike")
    check(aux_rel <= MOE_FLIP_SHARE, f"moe: aux off by {aux_rel:.2e}")
    check(all(v <= MOE_GRAD_RTOL for v in grad_rel.values()), f"moe: gradients {grad_rel}")
    check(ep_equal, "moe under ep on one rank differs from the plain call")
    return out


def entry_on_card() -> dict:
    """dryrun.entry()'s forward at its configuration: 8 B1 launches."""
    fn, args = dryrun.entry(device="cuda")
    zero_launch_counts()
    with torch.no_grad():
        logits = fn(*args)
    torch.cuda.synchronize()
    got = launch_counts()
    out = {"shape": list(logits.shape), "launches": dict(zip(("fwd", "dq", "dkv"), got)),
           "finite": bool(torch.isfinite(logits).all())}
    print(f"entry(): {json.dumps(out)}", flush=True)
    check(got == (8, 0, 0), f"entry(): launches {got}, expected (8, 0, 0)")
    check(out["finite"] and out["shape"] == [4, 512, 32000], f"entry(): {out}")
    return out


def one_7b_layer_temporaries() -> dict:
    """Memory of one training forward and backward of the 7B step's layer
    (remat attn, f32 params) at one fsdp=8 rank's batch, 1 x 2048: the peak
    above the parameters, which the 7B accounting adds to its state."""
    cfg = dataclasses.replace(dryrun.llama_7b_train_config(), n_layers=1)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    leaves = tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    toks = torch.zeros((1, cfg.max_seq_len), dtype=torch.long, device="cuda")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    (grads, _, peak, _) = _timed_run(lambda: torch.autograd.grad(
        cross_entropy_loss(forward(params, toks, cfg), toks), leaves))
    grad_bytes = sum(g.numel() * g.element_size() for g in grads)
    out = {"peak_above_params_gb": peak - base / 1e9,
           "of_which_grads_gb": grad_bytes / 1e9,
           "state_per_rank_gb": {k: v / 1e9 for k, v in dryrun.check_7b_state_fits().items()}}
    print(f"7B one layer: {json.dumps(out)}", flush=True)
    del grads, params
    torch.cuda.empty_cache()
    return out


def phase_pipeline_experts(card: str) -> tuple:
    """Phase 7: (b) the pipeline schedules in one process, (c) MoE at
    Mixtral's expert width, (d) dryrun.entry(), and one 7B layer's memory."""
    mesh = build_mesh(MeshSpec(data=1), device_type="cuda")  # the one-rank group of phase 6
    schedules, launches = pipeline_schedules()
    torch.cuda.empty_cache()
    out = {"card": card, "schedules": schedules, "moe": moe_at_mixtral_width(mesh),
           "entry": entry_on_card(), "llama_7b_layer": one_7b_layer_temporaries()}
    return out, launches


# -- phase 8: the RL learners and the sharded checkpoint ---------------------------

# PPO at tests/test_rllib.py::test_ppo_cartpole_learns's configuration: the
# best mean return of the last 100 episodes must reach PPO_TARGET within
# PPO_MAX_ITERS iterations.
PPO_TARGET = 120.0
PPO_MAX_ITERS = 100
# Every learner update on the card against the same update on the CPU (the
# same state, batch and draws; f32 on both, TF32 off): the same ops with
# their sums in other orders, the bounds of the CPU parity tests against
# the JAX package (tests/test_torch_rllib.py). There the port's 64-step
# PPO update is 4.2e-7 off JAX's in the parameters after 64 Adam steps, so
# 1e-5 absolute for parameters, targets and Adam moments; metrics within
# 1e-5 relative, with a floor of 1e-6 absolute for a mean of terms of both
# signs near zero (the policy loss of standardised advantages).
RL_ATOL = 1e-5
RL_RTOL = 1e-5
RL_METRIC_ATOL = 1e-6


def tensors_of(tree) -> list:
    """A state's tensors, in leaf order (counts and generators left out)."""
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


class draws:
    """The draws of the port's one draw function `module.name` (PPO's
    permutations, SAC's noise): recorded on the card, then replayed on the
    CPU twin, which cannot reproduce a CUDA generator's stream."""

    def __init__(self, module, name: str):
        self.module, self.name, self.orig, self.seen = module, name, getattr(module, name), []

    def record(self) -> None:
        def rec(*args, **kw):
            out = self.orig(*args, **kw)
            self.seen.append(out.cpu())
            return out

        setattr(self.module, self.name, rec)

    def replay(self) -> None:
        it = iter(self.seen)
        setattr(self.module, self.name, lambda *args, **kw: next(it))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def held_against_cpu(what: str, card_out, cpu_out) -> dict:
    """The card's (state, metrics) against the CPU twin's: every tensor of
    the state within RL_ATOL, every metric within RL_RTOL (floor
    RL_METRIC_ATOL)."""
    (state, metrics), (cpu_state, cpu_metrics) = card_out, cpu_out
    ours, theirs = tensors_of(state), tensors_of(cpu_state)
    check(len(ours) == len(theirs), f"{what}: states differ in shape")
    param_err = max(float((a.detach().cpu() - b.detach()).abs().max()) for a, b in
                    zip(ours, theirs))
    rel = {k: abs(float(metrics[k]) - float(cpu_metrics[k])) / max(abs(float(cpu_metrics[k])),
                                                                     1e-30) for k in metrics}
    bad = [k for k in metrics if abs(float(metrics[k]) - float(cpu_metrics[k]))
           > RL_RTOL * abs(float(cpu_metrics[k])) + RL_METRIC_ATOL]
    print(f"rllib {what} on the card vs the CPU: state max |diff| {param_err:.3g} (tol "
          f"{RL_ATOL}); metrics rel {json.dumps(rel)} (tol {RL_RTOL}, floor {RL_METRIC_ATOL})",
          flush=True)
    check(param_err <= RL_ATOL and not bad, f"{what}: card and CPU disagree ({param_err}, {bad})")
    return {"max_state_abs_err": param_err, "metric_rel_err": rel,
            "metrics": {k: float(v) for k, v in metrics.items()}}


def timed_update(update, *args) -> tuple:
    """One update: (its output, its CUDA-event ms, the host's ms to issue
    it)."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    out = update(*args)
    issue_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end), issue_ms


PPO_COLUMNS = (OBS, ACTIONS, LOGPS, ADVANTAGES, RETURNS)


def ppo_on_card() -> dict:
    """(a) PPO's dataflow (PPO.train() without the actor hop): 2 EnvRunners
    x 8 CartPoles x 64 steps in this process, policy inference and the
    learner on the card, until the mean return reaches PPO_TARGET; the
    first update held against the CPU."""
    cfg = (PPOConfig().environment("CartPole-v1")
           .env_runners(num_env_runners=2, num_envs_per_runner=8, rollout_length=64)
           .training(lr=1e-3, num_epochs=8, minibatch_size=128, entropy_coeff=0.005)
           .debugging(seed=7))
    runners = [EnvRunner(cfg.env, cfg.num_envs_per_runner, cfg.rollout_length, gamma=cfg.gamma,
                         lam=cfg.lam, seed=cfg.seed + 1000 * (i + 1), hidden=cfg.hidden)
               for i in range(cfg.num_env_runners)]
    init_state, update = ppo._make_learner(cfg, 4, 2)
    _, cpu_update = ppo._make_learner(cfg, 4, 2, device="cpu")
    state = init_state(cfg.seed)
    returns, best, steps, sample_s, update_ms, issue_ms = [], 0.0, 0, 0.0, [], []
    t_start = time.perf_counter()
    for it in range(1, PPO_MAX_ITERS + 1):
        t0 = time.perf_counter()
        results = [r.sample(state["params"]) for r in runners]
        sample_s += time.perf_counter() - t0
        batch = SampleBatch.concat_samples([SampleBatch(r["batch"]) for r in results])
        cols = {k: batch[k] for k in PPO_COLUMNS}
        steps += batch.count
        returns = (returns + [x for r in results for x in r["episode_returns"]])[-100:]
        if it == 1:
            cpu_state = Checkpoint.from_torch_state(state).get_torch_state()
            with draws(ppo, "_permutation") as perms:
                perms.record()
                (state, metrics), ms, host = timed_update(update, state, cols)
                perms.replay()
                held = held_against_cpu("ppo (8 epochs x 8 minibatches)", (state, metrics),
                                        cpu_update(cpu_state, cols))
        else:
            (state, metrics), ms, host = timed_update(update, state, cols)
        update_ms.append(ms)
        issue_ms.append(host)
        check(np.isfinite(float(metrics["total_loss"])), f"ppo: non-finite loss at {it}")
        best = max(best, float(np.mean(returns)) if returns else 0.0)
        if best >= PPO_TARGET:
            break
    total_s = time.perf_counter() - t_start
    print(f"rllib ppo: best mean return {best:.1f} after {it} iterations ({total_s:.1f} s); "
          f"update {np.median(update_ms):.1f} ms (CUDA events, median), host issue "
          f"{np.median(issue_ms):.1f} ms; env steps/s {steps / sample_s:.0f} sampling, "
          f"{steps / total_s:.0f} overall", flush=True)
    check(best >= PPO_TARGET, f"ppo: best mean return {best:.1f} < {PPO_TARGET} after {it} "
                              "iterations")
    return {"iterations": it, "best_mean_return": best, "seconds": total_s,
            "env_steps": steps, "env_steps_per_s_sampling": steps / sample_s,
            "env_steps_per_s": steps / total_s,
            "update_ms_median": float(np.median(update_ms)), "update_ms": update_ms,
            "host_issue_ms_median": float(np.median(issue_ms)),
            "host_share": float(np.median(np.array(issue_ms) / np.array(update_ms))),
            "minibatch_steps_per_update": 64, "first_update_vs_cpu": held}


def vtrace_learners_on_card() -> dict:
    """(b) one IMPALA and one APPO update through LearnerGroup(num_learners=1)
    on the one-rank NCCL group, each on a sample_trajectory batch of 2
    runners x 8 envs x 16 steps, against the unsharded update on the CPU."""
    runners = [EnvRunner("CartPole-v1", 8, 16, seed=SEED + 1000 * (i + 1)) for i in range(2)]
    # The first collective on the NCCL group creates its communicator (the
    # steps of phase 6 at world size 1 issue none): timed apart.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dist.all_reduce(torch.zeros(1, device="cuda"))
    torch.cuda.synchronize()
    out = {"first_nccl_collective_ms": (time.perf_counter() - t0) * 1e3}
    for name, config, make in (("impala", IMPALAConfig(), make_impala_learner),
                               ("appo", APPOConfig(), make_appo_learner)):
        init_state, update = make(config, 4, 2)
        _, cpu_update = make(config, 4, 2, device="cpu")
        state = init_state(SEED)
        trajs = [r.sample_trajectory(state["params"]) for r in runners]
        batch = {k: np.concatenate([t["batch"][k] for t in trajs], axis=1)
                 for k in trajs[0]["batch"]}  # [T, N] = [16, 16]
        cpu_state = Checkpoint.from_torch_state(state).get_torch_state()
        group = LearnerGroup(update, 1)
        check(group.group is not None, f"{name}: the learner group is not on the NCCL group")
        card, ms, host = timed_update(group.update, state, batch)
        out[name] = {**held_against_cpu(name, card, cpu_update(cpu_state, batch)),
                     "update_ms": ms, "host_issue_ms": host}
    return out


def dqn_on_card() -> dict:
    """(c) DQN: a _DQNRunner's epsilon-greedy transitions (Q-values on the
    card) into a ReplayBuffer, update_many over U = 4 batches of 32, then
    sync_target, against the CPU."""
    runner = dqn._DQNRunner("CartPole-v1", 8, SEED)
    init_state, update_many, sync = dqn._make_learner(DQNConfig(), 4, 2)
    _, cpu_update_many, cpu_sync = dqn._make_learner(DQNConfig(), 4, 2, device="cpu")
    state = init_state(SEED)
    buffer = ReplayBuffer(10_000, 4)
    got = runner.collect(state["params"], 32, 0.5)
    buffer.add_batch(got["obs"], got["actions"], got["rewards"], got["next_obs"], got["dones"])
    rng = np.random.default_rng(SEED)
    stacked = [buffer.sample(32, rng) for _ in range(4)]
    batches = tuple(np.stack([s[i] for s in stacked]) for i in range(5))
    cpu_state = Checkpoint.from_torch_state(state).get_torch_state()
    (state, loss), ms, host = timed_update(update_many, state, batches)
    cpu_state, cpu_loss = cpu_update_many(cpu_state, batches)
    held = held_against_cpu("dqn (update_many U=4, then sync_target)",
                            (sync(state), {"loss": loss}),
                            (cpu_sync(cpu_state), {"loss": cpu_loss}))
    return {**held, "update_ms": ms, "host_issue_ms": host, "transitions": got["steps"]}


def sac_on_card() -> dict:
    """(d) SAC: a _SACRunner's Pendulum transitions (the actor on the card)
    into a ContinuousReplayBuffer, one update of 256 with the same noise on
    both sides, against the CPU."""
    cfg = SACConfig()
    runner = sac._SACRunner("Pendulum-v1", 8, SEED, cfg.hidden, cfg.act_limit)
    init_state, update = make_sac_learner(cfg, 3, 1)
    _, cpu_update = make_sac_learner(cfg, 3, 1, device="cpu")
    state = init_state(SEED)
    buffer = ContinuousReplayBuffer(10_000, 3, 1)
    got = runner.collect(state["params"], 32)
    b = got["batch"]
    buffer.add_batch(b["obs"], b["actions"], b["rewards"], b["next_obs"], b["terminateds"])
    batch = buffer.sample(cfg.batch_size, np.random.default_rng(SEED))
    cpu_state = Checkpoint.from_torch_state(state).get_torch_state()
    with draws(sac, "_normal") as noise:
        noise.record()
        card, ms, host = timed_update(update, state, batch)
        noise.replay()
        held = held_against_cpu("sac", card, cpu_update(cpu_state, batch))
    return {**held, "update_ms": ms, "host_issue_ms": host}


def multi_agent_on_card() -> dict:
    """(e) one multi-agent PPO iteration (2 MultiAgentEnvRunners x 8 envs x
    32 steps of a 2-agent CartPole, then each policy's PPO update on the
    card), with a shared and with independent policies."""
    out = {}
    for name, mapping in (("shared", {"agent_0": "shared", "agent_1": "shared"}),
                          ("independent", {"agent_0": "p0", "agent_1": "p1"})):
        cfg = (MultiAgentPPOConfig().environment(MultiAgentCartPole).multi_agent(mapping)
               .debugging(seed=SEED))
        pids, updates, states = make_policy_learners(cfg)
        runners = [MultiAgentEnvRunner(cfg.env_creator, cfg.num_envs_per_runner,
                                       cfg.rollout_length, mapping,
                                       seed=cfg.seed + 1000 * (i + 1)) for i in range(2)]
        t0 = time.perf_counter()
        results = [r.sample({pid: states[pid]["params"] for pid in pids}) for r in runners]
        losses, rows = {}, {}
        for pid in pids:
            batch = SampleBatch.concat_samples([SampleBatch(r["batches"][pid]) for r in results])
            rows[pid] = batch.count
            states[pid], m = updates[pid](states[pid], {k: batch[k] for k in PPO_COLUMNS})
            losses[pid] = float(m["total_loss"])
        seconds = time.perf_counter() - t0
        check(all(np.isfinite(list(losses.values()))), f"multi-agent {name}: {losses}")
        check(sum(rows.values()) == sum(r["steps"] for r in results),
              f"multi-agent {name}: {rows} rows for {[r['steps'] for r in results]} steps")
        print(f"rllib multi-agent ppo ({name}): policies {pids}, rows {rows}, total loss "
              f"{losses}, one iteration {seconds:.2f} s", flush=True)
        out[name] = {"policies": pids, "rows": rows, "total_loss": losses, "seconds": seconds}
    return out


def checkpoint_on_card(mesh) -> tuple:
    """(f) bench.py's head configuration's state at full width and depth
    (bf16 params and Adam moments, after one step), saved with
    from_torch_state_sharded on the one-rank NCCL mesh into a directory
    beside this script (removed after), restored with get_torch_state, and
    one step from the restored state against one from the unbroken state:
    bit for bit, 16/16/16 launches."""
    cfg = bench_config()
    ctx = LMTrainContext(cfg, mesh, "fsdp")
    per_step = (cfg.n_layers,) * 3
    batch = train_batch(cfg)
    state, _ = ctx.train_step(ctx.init_state(SEED), batch)  # moments and count nonzero
    tensors = tensors_of(state)
    state_bytes = sum(t.numel() * t.element_size() for t in tensors)
    where = os.path.dirname(os.path.abspath(__file__))
    free = shutil.disk_usage(where).free
    print(f"checkpoint: state {state_bytes / 1e9:.3f} GB, free space {free / 1e9:.1f} GB",
          flush=True)
    check(free > 2 * state_bytes, f"checkpoint: {free / 1e9:.1f} GB free cannot hold the "
                                  f"{state_bytes / 1e9:.2f} GB state twice over")
    path = tempfile.mkdtemp(prefix=".ckpt-", dir=where)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt = Checkpoint.from_torch_state_sharded(state, path, mesh, ctx.state_placements(),
                                                   step=state["step"])
        save_s = time.perf_counter() - t0
        written = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path)
                      for f in fs)
        t0 = time.perf_counter()
        restored = ckpt.get_torch_state(placements=ctx.state_placements(), mesh=mesh)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(path, ignore_errors=True)
    back = tensors_of(restored)
    same = len(back) == len(tensors) and all(torch.equal(a, b) for a, b in zip(tensors, back))
    check(same, "checkpoint: the restored state is not the saved one bit for bit")
    resumed, m_resumed = counted_step(ctx, restored, batch, per_step, "resumed step")
    unbroken, m_unbroken = counted_step(ctx, state, batch, per_step, "unbroken step")
    a_leaves, b_leaves = tensors_of(resumed), tensors_of(unbroken)
    bitwise = (torch.equal(m_resumed["loss"], m_unbroken["loss"])
               and len(a_leaves) == len(b_leaves)
               and all(torch.equal(a, b) for a, b in zip(a_leaves, b_leaves)))
    out = {"config": "bench.py head: d2048 L16 H16/16 ff5504 V32000, bf16 params and Adam "
                     "moments, after one step, fsdp on a one-rank NCCL mesh",
           "state_bytes": state_bytes, "bytes_written": written, "free_bytes_before": free,
           "save_s": save_s, "save_gb_per_s": written / save_s / 1e9,
           "restore_s": restore_s, "restore_gb_per_s": written / restore_s / 1e9,
           "restored_bitwise": same, "resumed_step_bitwise": bitwise,
           "resumed_loss": float(m_resumed["loss"]), "unbroken_loss": float(m_unbroken["loss"]),
           "launches_resumed_step": dict(zip(("fwd", "dq", "dkv"), per_step))}
    print(f"checkpoint: wrote {written / 1e9:.3f} GB in {save_s:.2f} s "
          f"({out['save_gb_per_s']:.2f} GB/s), restored in {restore_s:.2f} s "
          f"({out['restore_gb_per_s']:.2f} GB/s); resumed step loss {out['resumed_loss']:.6f} "
          f"vs unbroken {out['unbroken_loss']:.6f}, bitwise {bitwise}", flush=True)
    check(bitwise, "checkpoint: the resumed step is not the unbroken step bit for bit")
    return out, per_step


def phase_rl_checkpoint(card: str) -> tuple:
    """Phase 8: the RL learners with their env runners on the card, then the
    sharded checkpoint of the training state."""
    t0 = time.perf_counter()
    mesh = build_mesh(MeshSpec(data=1), device_type="cuda")  # the one-rank group of phase 6
    rllib = {"card": card, "ppo": ppo_on_card(), **vtrace_learners_on_card(),
             "dqn": dqn_on_card(), "sac": sac_on_card(), "multi_agent": multi_agent_on_card(),
             "bounds": {"state_atol": RL_ATOL, "metric_rtol": RL_RTOL,
                        "metric_atol": RL_METRIC_ATOL}}
    rllib["seconds"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    checkpoint, launches = checkpoint_on_card(mesh)
    checkpoint["card"] = card
    checkpoint["seconds"] = time.perf_counter() - t1
    print(f"phase 8: {time.perf_counter() - t0:.1f} s", flush=True)
    return rllib, checkpoint, launches


# -- phase 9: the actor runtime and the trainer on it -----------------------------

# The trainer's run is phase 5's training (same seed, batch and step) in a
# worker actor: steps 1 to TRAINER_STEPS, a sharded checkpoint after
# TRAINER_CKPT_STEP, and on the first attempt a failure after
# TRAINER_FAIL_STEP's report, from which the group restarts at the
# checkpoint. Every step is held to phase 5's step of that number bit for
# bit: the same deterministic kernels and products on the same card.
TRAINER_STEPS = 4
TRAINER_CKPT_STEP = 2
TRAINER_FAIL_STEP = 3
# The restarted worker's free memory at its start against the first
# worker's: the dead worker's CUDA context (tens of GB) must be gone, and
# the rest of the card is as it was.
TRAINER_FREE_SLACK = 2e9


def foreign_modules() -> list:
    """The modules of the JAX package, or of jax, this process has loaded."""
    return sorted(m for m in sys.modules if m.split(".")[0] in ("ray_tpu", "jax", "jaxlib"))


def gpu_probe() -> tuple:
    """Run as a num_gpus=1 task: the card's name as its worker sees it, and
    what of the JAX package that worker loaded."""
    return torch.cuda.get_device_name(0), foreign_modules()


def trainer_loop(config: dict) -> None:
    """Phase 9's train loop, in the worker actor: bench.py's head
    configuration on a one-rank NCCL group, phase 5's single-device step
    (LMTrainContext(bench_config()), init_state(SEED), train_batch drawn
    here), reporting plain floats each step."""
    from ray_tpu_torch import train

    entered = time.time()
    marker = os.path.join(config["storage"], "failed_attempt.json")
    failed = None
    if os.path.exists(marker):
        with open(marker) as f:
            failed = json.load(f)
    # main() turns TF32 off (torch.backends.cuda.matmul.allow_tf32), as this
    # does; torch.backends is a module that does not pickle, and this
    # function is pickled by value.
    torch.set_float32_matmul_precision("highest")
    free_at_start = torch.cuda.mem_get_info()[0]
    mesh = build_mesh(MeshSpec(data=1), device_type="cuda")
    cfg = bench_config()
    ctx = LMTrainContext(cfg)
    state = ctx.init_state(SEED)
    batch = train_batch(cfg)
    first, restore_s = 1, None
    resume = train.get_checkpoint()
    if resume is not None:
        t0 = time.perf_counter()
        state = resume.get_torch_state(target=state, placements={}, mesh=mesh)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        first = state["step"] + 1
    start = {"attempt": 1 if failed is None else 2, "pid": os.getpid(),
             "entered_at": entered, "state_ready_at": time.time(),
             "free_at_start_bytes": free_at_start, "restore_s": restore_s,
             "failed_at": failed and failed["failed_at"], "foreign_modules": foreign_modules()}
    for step in range(first, TRAINER_STEPS + 1):
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        zero_launch_counts()
        state, m = ctx.train_step(state, batch)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        fwd, dq, dkv = launch_counts()
        report = {**(start if step == first else {"attempt": start["attempt"]}), "step": step,
                  "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                  "step_s": step_s, "launches": [fwd, dq, dkv],
                  "peak_bytes": torch.cuda.max_memory_allocated()}
        ckpt = None
        if step == TRAINER_CKPT_STEP:
            t0 = time.perf_counter()
            ckpt = Checkpoint.from_torch_state_sharded(
                state, os.path.join(config["storage"], f"step{step}"), mesh, {}, step=step)
            report["save_s"] = time.perf_counter() - t0
        report["reported_at"] = time.time()
        train.report(report, checkpoint=ckpt)
        if failed is None and step == TRAINER_FAIL_STEP:
            # The report of this step is dropped from the run's history at the
            # restart; the marker keeps it, and tells the next attempt it is one.
            with open(marker, "w") as f:
                json.dump({"failed_at": time.time(), "report": report}, f)
            raise RuntimeError(f"chip_smoke: planned failure after step {step}")


def phase_runtime_trainer(card: str, training: dict) -> tuple:
    """Phase 9: (a) the port's actor runtime on the card, then (b) the
    trainer (TorchTrainer, one worker actor holding the card) training
    phase 5's configuration with a failure and a restart from the sharded
    checkpoint; then the run's checkpoint restored in this process and a
    step from it."""
    from ray_tpu_torch.air import FailureConfig, RunConfig, ScalingConfig
    from ray_tpu_torch.train import TorchTrainer

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f"phase 9: card memory free {free / 1e9:.2f} of {total / 1e9:.2f} GB "
          f"(this process holds {torch.cuda.memory_reserved() / 1e9:.2f} GB)", flush=True)

    # (a) The runtime detects the card; a num_gpus=1 task runs on it.
    t0 = time.perf_counter()
    ray_tpu_torch.init(num_cpus=4)
    try:
        init_s = time.perf_counter() - t0
        resources = ray_tpu_torch.cluster_resources()
        check(resources.get("GPU") == 1, f"runtime: resources {resources}, expected GPU 1")
        t0 = time.perf_counter()
        name, foreign = ray_tpu_torch.get(ray_tpu_torch.remote(num_gpus=1)(gpu_probe).remote(),
                                          timeout=300)
        task_s = time.perf_counter() - t0
    finally:
        ray_tpu_torch.shutdown()
    check(name == torch.cuda.get_device_name(0), f"runtime: the task saw {name!r}")
    check(foreign == [], f"runtime: the task's worker loaded {foreign}")
    runtime = {"init_s": init_s, "resources": resources, "first_gpu_task_s": task_s,
               "task_device": name}
    print(f"runtime: init {init_s:.3f} s, resources {resources}; first num_gpus=1 task "
          f"(spawn, torch import, CUDA init) {task_s:.3f} s on {name}", flush=True)

    # (b) The trainer, on a runtime of its own, so that its first worker is
    # a new process too.
    storage = tempfile.mkdtemp(prefix=".trainer-", dir=os.path.dirname(os.path.abspath(__file__)))
    cfg = bench_config()
    per_step = [cfg.n_layers] * 3  # qkv_attn: B1, B2 and B3 once per layer
    try:
        ray_tpu_torch.init(num_cpus=4)
        try:
            trainer = TorchTrainer(
                trainer_loop, train_loop_config={"storage": storage},
                scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
                run_config=RunConfig(storage_path=storage,
                                     failure_config=FailureConfig(max_failures=1)))
            fit_at = time.time()
            result = trainer.fit()
            fit_s = time.time() - fit_at
            check(result.error is None, f"trainer: {result.error!r}")
            with open(os.path.join(storage, "failed_attempt.json")) as f:
                failed = json.load(f)
        finally:
            ray_tpu_torch.shutdown()
        hist = result.metrics_history
        got = [(r["attempt"], r["step"]) for r in hist]
        check(got == [(1, 1), (1, 2), (2, 3), (2, 4)], f"trainer: reports (attempt, step) {got}")
        reports = hist[:2] + [failed["report"]] + hist[2:]
        for r in reports:
            check(r["launches"] == per_step,
                  f"trainer: attempt {r['attempt']} step {r['step']} launches {r['launches']}")
        first, resumed = hist[0], hist[2]
        for r in (first, resumed):
            check(r["foreign_modules"] == [],
                  f"trainer: attempt {r['attempt']}'s worker loaded {r['foreign_modules']}")
        # Every step equals phase 5's step of its number, bit for bit; so the
        # resumed steps equal the failed attempt's step 3 and the unbroken step 4.
        for r in reports:
            i = r["step"] - 1
            check(r["loss"] == training["losses"][i] and r["grad_norm"] == training["grad_norms"][i],
                  f"trainer: attempt {r['attempt']} step {r['step']} loss {r['loss']!r} grad "
                  f"norm {r['grad_norm']!r}, phase 5 {training['losses'][i]!r} "
                  f"{training['grad_norms'][i]!r}")
        check(hist[2]["loss"] == failed["report"]["loss"]
              and hist[2]["grad_norm"] == failed["report"]["grad_norm"],
              "trainer: the resumed step 3 is not the failed attempt's step 3")
        check(result.metrics == hist[-1], "trainer: Result.metrics is not the last report")
        check(resumed["free_at_start_bytes"] > first["free_at_start_bytes"] - TRAINER_FREE_SLACK,
              f"trainer: the restarted worker started with {resumed['free_at_start_bytes'] / 1e9:.2f}"
              f" GB free, the first with {first['free_at_start_bytes'] / 1e9:.2f}")

        # Result.checkpoint restores: here, on a one-rank group of this
        # process, and a step from it is the resumed step 3.
        mesh = build_mesh(MeshSpec(data=1), device_type="cuda")
        ctx = LMTrainContext(cfg)
        state = result.checkpoint.get_torch_state(target=ctx.init_state(SEED), placements={},
                                                  mesh=mesh)
        check(state["step"] == TRAINER_CKPT_STEP, f"trainer: checkpoint at step {state['step']}")
        _, m = counted_step(ctx, state, train_batch(cfg), tuple(per_step),
                            "step from Result.checkpoint")
        check(float(m["loss"]) == resumed["loss"] and float(m["grad_norm"]) == resumed["grad_norm"],
              "trainer: a step from Result.checkpoint is not the resumed step 3")
        del state, m
        dist.destroy_process_group()
    finally:
        shutil.rmtree(storage, ignore_errors=True)
    torch.cuda.empty_cache()

    # Warm steps: neither a process's first (which imports the torch modules
    # torch.utils.checkpoint needs and loads kernels lazily) nor the one
    # right after the save, which ran slower (cause not split): 1.2 and 2.4.
    warm = [hist[1]["step_s"], hist[3]["step_s"]]
    out = {
        "card": card,
        "config": "bench.py head: d2048 L16 H16/16 ff5504 V32000, bf16, remat qkv_attn, batch "
                  "16 x 1024; TorchTrainer, 1 worker actor (GPU 1), one-rank NCCL group, "
                  f"{TRAINER_STEPS} steps, sharded checkpoint after step {TRAINER_CKPT_STEP}, "
                  f"failure after step {TRAINER_FAIL_STEP} on the first attempt",
        "runtime": runtime, "fit_s": fit_s,
        "first_report_s": first["reported_at"] - fit_at,
        "first_worker": {k: first[k] - fit_at for k in ("entered_at", "state_ready_at")},
        "restart_s": resumed["reported_at"] - failed["failed_at"],
        "restarted_worker": {k: resumed[k] - failed["failed_at"]
                             for k in ("entered_at", "state_ready_at")},
        "restore_s": resumed["restore_s"], "save_s": hist[1]["save_s"],
        "free_at_start_gb": [first["free_at_start_bytes"] / 1e9,
                             resumed["free_at_start_bytes"] / 1e9],
        "worker_pids": [first["pid"], resumed["pid"]],
        "step_s": {f"{r['attempt']}.{r['step']}": r["step_s"] for r in reports},
        "warm_step_s": warm, "phase5_step_s": training["step_s"],
        "warm_step_over_phase5": float(np.mean(warm)) / training["step_s"],
        "peak_mem_gb": max(r["peak_bytes"] for r in reports) / 1e9,
        "losses": [r["loss"] for r in reports], "grad_norms": [r["grad_norm"] for r in reports],
        "launches_per_step": dict(zip(("fwd", "dq", "dkv"), first["launches"])),
    }
    print(f"trainer: card {card}; fit {fit_s:.2f} s; fit() to first report "
          f"{out['first_report_s']:.2f} s (worker entered the loop at "
          f"{out['first_worker']['entered_at']:.2f} s, its first step "
          f"{hist[0]['step_s']:.2f} s); warm step {np.mean(warm):.4f} s vs "
          f"phase 5 {training['step_s']:.4f} s (x{out['warm_step_over_phase5']:.3f}); "
          f"failure to resumed first report {out['restart_s']:.2f} s (restore "
          f"{out['restore_s']:.2f} s); save {out['save_s']:.2f} s; free at start "
          f"{out['free_at_start_gb'][0]:.2f} / {out['free_at_start_gb'][1]:.2f} GB; "
          f"peak {out['peak_mem_gb']:.2f} GB; steps 1-{TRAINER_STEPS} equal phase 5's bit for "
          f"bit, launches {first['launches']} each", flush=True)
    print(f"phase 9: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return out, tuple(first["launches"])


# Phase 10: the serve stack and the batch predictor. Every wait on them is
# bounded by this many seconds: a replica's cold start (spawn, torch import,
# CUDA init, weights, a warm-up batch) must end well inside the
# controller's 120 s grace for a replica that has not answered a health
# check, and a replica whose constructor raises fails its first call with
# that error.
SERVE_TIMEOUT = 300


class LMDeployment:
    """Phase 10's deployment: llama_1b's decoder with phase 3's weights in a
    replica actor that holds the card, one forward a batch. A request is
    {"tokens": [...]}; its answer carries the next token and the top-2 gap
    of the last-position logits, and with {"logits": True} also the logits
    row itself (f32), the id of the batch it ran in and its index there.
    Forwards run one at a time, so that each batch's CUDA-event time is its
    own; each batch also keeps how long it waited for the card.
    Pickled by value (this script is __main__): its globals are
    ray_tpu_torch's, torch's, numpy's and this script's own functions."""

    def __init__(self):
        t0 = time.perf_counter()
        if not torch.cuda.is_available():
            raise RuntimeError("chip_smoke: the replica finds no CUDA device")
        self.cfg = TransformerConfig.llama_1b()
        self.params = llama_1b_params(self.cfg)
        self.lock = threading.Lock()
        self.next_id = 0
        self.batches = []
        # A warm-up batch through the whole batch body (cuBLAS handles and
        # heuristics, and the first launch of every kernel it uses, topk's
        # included) before the first request.
        self.predict_batch.__wrapped__(self, [{"tokens": [0] * PROMPT_LEN}] * MAX_BATCH)
        self.start_s = time.perf_counter() - t0

    @serve.batch(max_batch_size=MAX_BATCH, batch_wait_timeout_s=2.0)
    def predict_batch(self, requests):
        formed = time.perf_counter()
        with self.lock:
            card_wait_s = time.perf_counter() - formed
            batch_id, self.next_id = self.next_id, self.next_id + 1
            toks = torch.tensor([r["tokens"] for r in requests], dtype=torch.long, device="cuda")
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            with torch.no_grad():
                last = forward(self.params, toks, self.cfg)[:, -1, :]
            end.record()
            top2 = last.topk(2, dim=-1).values
            rows = last.cpu().numpy()  # waits for the card
            tokens, gaps = last.argmax(-1).tolist(), (top2[:, 0] - top2[:, 1]).tolist()
            self.batches.append({"id": batch_id, "size": len(requests),
                                 "device_ms": start.elapsed_time(end),
                                 "card_wait_s": card_wait_s})
        return [{"token": tokens[i], "gap": gaps[i],
                 **({"logits": rows[i].copy(), "batch": batch_id, "index": i}
                    if r.get("logits") else {})}
                for i, r in enumerate(requests)]

    def __call__(self, request):
        return self.predict_batch(request)

    def reset(self) -> list:
        """Zero this process's kernel launch counts, its record of batches
        and its peak memory; returns the sizes of the batches dropped from
        the record (those run since the last `stats`)."""
        with self.lock:
            sizes = [b["size"] for b in self.batches]
            zero_launch_counts()
            self.batches = []
            torch.cuda.reset_peak_memory_stats()
        return sizes

    def stats(self) -> dict:
        """This process's card, B1-B3 launch counts, peak memory and kernel
        builds, and the batches run since the last `reset` (taken from the
        record)."""
        with self.lock:
            batches, self.batches = self.batches, []
            return {"device": torch.cuda.get_device_name(),
                    "launches": launch_counts(),
                    "batches": batches, "peak_bytes": torch.cuda.max_memory_allocated(),
                    "foreign_modules": foreign_modules(), "build_s": dict(_build.build_seconds),
                    "start_s": self.start_s}


class LMPredictor(Predictor):
    """Phase 10's predictor: llama_1b's weights restored from a port
    Checkpoint onto the predictor actor's card; the next token and the
    last-position logits row of each prompt of a batch, in one forward, with
    the actor's B1-B3 launch counts after the batch. Pickled by value, as
    LMDeployment."""

    @classmethod
    def from_checkpoint(cls, checkpoint, **kw):
        t0 = time.perf_counter()
        if not torch.cuda.is_available():
            raise RuntimeError("chip_smoke: the predictor actor finds no CUDA device")
        p = cls()
        p.cfg = TransformerConfig.llama_1b()
        p.params = tree_map(lambda t: t.to("cuda"), checkpoint.get_torch_state())
        torch.cuda.synchronize()
        p.load_s = time.perf_counter() - t0
        p.batches = 0
        zero_launch_counts()
        return p

    def predict(self, batch):
        toks = torch.as_tensor(np.asarray(batch["tokens"]), dtype=torch.long).to("cuda")
        with torch.no_grad():
            last = forward(self.params, toks, self.cfg)[:, -1, :]
        n = len(toks)
        out = {"id": np.asarray(batch["id"]), "token": last.argmax(-1).cpu().numpy(),
               "logits": last.cpu().numpy(), "batch": np.full(n, self.batches),
               **{k: np.full(n, c) for k, c in zip(LAUNCH_KEYS, launch_counts())},
               "load_s": np.full(n, self.load_s),
               "foreign": np.full(n, len(foreign_modules()))}
        self.batches += 1
        return out


def concurrent_requests(send, prompts, logits: bool) -> tuple:
    """Each prompt through `send` from a thread of its own, all started
    together: the answers, each one's latency and the wall time."""
    n = len(prompts)
    outs, lat, errors = [None] * n, [None] * n, []

    def call(i):
        try:
            t0 = time.perf_counter()
            outs[i] = send({"tokens": prompts[i], **({"logits": True} if logits else {})})
            lat[i] = time.perf_counter() - t0
        except Exception as e:  # noqa: BLE001 - reported and failed below
            errors.append(e)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(n)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=SERVE_TIMEOUT + 60)
    wall = time.perf_counter() - t0
    check(not errors, f"request failed: {errors[:1]!r}")
    check(not any(t.is_alive() for t in threads), "a request did not finish")
    return outs, lat, wall


def http_post(url: str, body) -> dict:
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=SERVE_TIMEOUT) as resp:
        return json.loads(resp.read())["result"]


def rebuild_batches(what: str, params, cfg, prompts, outs, batches) -> float:
    """The batches another process ran, rebuilt here in the order it reports
    them from the prompts its answers place in them, through this process's
    kernel path: every logits row must equal that process's bit for bit.
    Against the plain reference attention every row is within LOGIT_TOL, and
    the argmax agrees wherever the top-2 gap exceeds it (phase 3's rule).
    Returns the largest difference from the reference."""
    place = {(o["batch"], o["index"]): i for i, o in enumerate(outs)}
    check(len(place) == len(outs), f"{what}: two answers name one place in a batch")
    check(sum(b["size"] for b in batches) == len(outs), f"{what}: requests lost in batching")
    ref_cfg = dataclasses.replace(cfg, attention_impl="reference")
    diff, clear_n, agree_n = 0.0, 0, 0
    for b in batches:
        idx = [place.get((b["id"], j)) for j in range(b["size"])]
        check(None not in idx, f"{what}: batch {b['id']} has an unanswered place")
        toks = torch.tensor([prompts[i] for i in idx], dtype=torch.long, device="cuda")
        theirs = torch.from_numpy(np.stack([outs[i]["logits"] for i in idx])).to("cuda")
        check(bool(torch.isfinite(theirs).all()), f"{what}: non-finite logits")
        check([outs[i]["token"] for i in idx] == theirs.argmax(-1).tolist(),
              f"{what}: batch {b['id']}'s tokens are not its logits' argmax")
        with torch.no_grad():
            mine = forward(params, toks, cfg)[:, -1, :]
            ref = forward(params, toks, ref_cfg)[:, -1, :]
        check(torch.equal(mine, theirs),
              f"{what}: batch {b['id']}'s logits differ from this process's kernel path "
              f"(max |diff| {(mine - theirs).abs().max().item():.3e})")
        diff = max(diff, (theirs - ref).abs().max().item())
        top2 = ref.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > LOGIT_TOL
        agree = theirs.argmax(-1) == ref.argmax(-1)
        clear_n += int(clear.sum())
        agree_n += int((agree & clear).sum())
        check(bool(agree[clear].all()), f"{what}: next token disagrees with the reference")
    check(diff <= LOGIT_TOL, f"{what}: logits differ from the reference attention by {diff}")
    print(f"{what}: {len(batches)} batches rebuilt here equal bit for bit; max|logits - "
          f"reference| = {diff:.4f} (tol {LOGIT_TOL}); argmax agrees on {agree_n}/{clear_n} "
          f"requests with a top-2 gap over the tolerance", flush=True)
    return diff


def replica_run(handle, send, prompts, logits: bool, n_layers: int, what: str) -> tuple:
    """One concurrent run of the prompts through the replica, after a
    warm-up batch of the first MAX_BATCH of them on the same path (the
    first calls through the proxy and the router): this process's and the
    replica's B1-B3 counts zeroed just before the run and read just after;
    the replica must have launched B1 once a layer a batch and B2, B3
    never, and this process none of them."""
    warmup_wall = concurrent_requests(send, prompts[:MAX_BATCH], logits)[2]
    warmup_sizes = ray_tpu_torch.get(handle.reset.remote(), timeout=SERVE_TIMEOUT)
    zero_launch_counts()
    outs, lat, wall = concurrent_requests(send, prompts, logits)
    here = launch_counts()
    stats = ray_tpu_torch.get(handle.stats.remote(), timeout=SERVE_TIMEOUT)
    batches = stats["batches"]
    check(here == (0, 0, 0), f"{what}: this process launched B1-B3 {here} times")
    check(tuple(stats["launches"]) == (n_layers * len(batches), 0, 0),
          f"{what}: the replica launched B1-B3 {stats['launches']} times for {len(batches)} "
          f"batches of {n_layers} layers")
    check(sum(b["size"] for b in batches) == len(prompts),
          f"{what}: batch sizes {[b['size'] for b in batches]}")
    return outs, {"latency_s_median": float(np.median(lat)), "latency_s_max": max(lat),
                  "wall_s": wall, "prefill_tokens_per_s": len(lat) * PROMPT_LEN / wall,
                  "batch_sizes": [b["size"] for b in batches],
                  "batch_device_ms": [b["device_ms"] for b in batches],
                  "batch_card_wait_s": [b["card_wait_s"] for b in batches],
                  "warmup_wall_s": warmup_wall, "warmup_batch_sizes": warmup_sizes,
                  "replica_launches": list(stats["launches"]),
                  "peak_mem_gb": stats["peak_bytes"] / 1e9}, stats


def phase_serve_stack(card: str, serving: dict) -> tuple:
    """Phase 10: llama_1b served by the port's serve stack from a replica
    actor on the card, (a) through the deployment's handle and (b) through
    the HTTP proxy, then (c) the same prompts through BatchPredictor from a
    port Checkpoint in a predictor actor on the card."""
    from ray_tpu_torch import data as rd

    t_phase = time.perf_counter()
    cfg = TransformerConfig.llama_1b()
    prompts = serving_prompts(cfg)
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix=".predict-", dir=os.path.dirname(os.path.abspath(__file__)))
    ray_tpu_torch.init(num_cpus=4)
    try:
        check(ray_tpu_torch.cluster_resources().get("GPU") == 1,
              f"runtime: resources {ray_tpu_torch.cluster_resources()}")
        serve.start(http_options={"host": "127.0.0.1", "port": 0})
        try:
            t0 = time.perf_counter()
            handle = serve.run(serve.deployment(
                LMDeployment, name="lm", num_replicas=1, max_concurrent_queries=16,
                ray_actor_options={"num_gpus": 1}).bind())
            run_s = time.perf_counter() - t0
            # The first answer comes once the replica's constructor has run.
            startup_sizes = ray_tpu_torch.get(handle.reset.remote(), timeout=SERVE_TIMEOUT)
            first_answer_s = time.perf_counter() - t0

            # (a) Through the deployment's handle.
            outs_a, handle_s, stats_a = replica_run(
                handle, lambda r: ray_tpu_torch.get(handle.remote(r), timeout=SERVE_TIMEOUT),
                prompts, True, cfg.n_layers, "serve stack (handle)")
            check(stats_a["device"] == torch.cuda.get_device_name(0),
                  f"the replica ran on {stats_a['device']!r}")
            check(stats_a["foreign_modules"] == [],
                  f"the replica loaded {stats_a['foreign_modules']}")
            check(stats_a["build_s"] and all(s == 0.0 for s in stats_a["build_s"].values()),
                  f"the replica built kernels again: {stats_a['build_s']}")

            # (b) The same prompts through the HTTP proxy.
            url = serve.get_http_address() + "/lm"
            outs_b, http_s, stats_b = replica_run(
                handle, lambda r: http_post(url, r), prompts, False, cfg.n_layers,
                "serve stack (HTTP)")
        finally:
            serve.shutdown()

        params = llama_1b_params(cfg)
        diff_a = rebuild_batches("serve stack (handle)", params, cfg, prompts, outs_a,
                                  stats_a["batches"])
        clear = [o["gap"] > LOGIT_TOL for o in outs_a]
        http_agree = [b["token"] == a["token"] for a, b in zip(outs_a, outs_b)]
        check(all(ok for ok, c in zip(http_agree, clear) if c),
              "serve stack (HTTP): a clear token differs from the handle's")
        check(all(set(o) == {"token", "gap"} for o in outs_b),
              "serve stack (HTTP): an answer carries more than the token and the gap")
        print(f"serve stack (HTTP): tokens agree with the handle's on "
              f"{sum(a for a, c in zip(http_agree, clear) if c)}/{sum(clear)} clear prompts "
              f"({sum(http_agree)}/{N_REQUESTS} in all)", flush=True)

        # (c) Offline batch prediction from a port Checkpoint.
        t0 = time.perf_counter()
        ckpt = Checkpoint.from_directory(
            Checkpoint.from_torch_state(params).to_directory(os.path.join(root, "lm")))
        save_s = time.perf_counter() - t0
        ds = rd.from_items([{"id": i, "tokens": p} for i, p in enumerate(prompts)],
                           parallelism=2)
        # predict() copies a directory checkpoint into a new temporary
        # directory, which it leaves behind: keep that copy under `root`.
        tempfile.tempdir, saved_tempdir = root, tempfile.tempdir
        zero_launch_counts()
        t0 = time.perf_counter()
        try:
            out = BatchPredictor.from_checkpoint(ckpt, LMPredictor).predict(
                ds, batch_size=MAX_BATCH, num_actors=1, num_gpus_per_actor=1)
            pred_batches = list(out.iter_batches(batch_size=MAX_BATCH))
        finally:
            tempfile.tempdir = saved_tempdir
        predict_s = time.perf_counter() - t0
        here = launch_counts()
        check(here == (0, 0, 0), f"batch predictor: this process launched B1-B3 {here} times")
    finally:
        ray_tpu_torch.shutdown()
        shutil.rmtree(root, ignore_errors=True)

    rows = {k: np.concatenate([b[k] for b in pred_batches]) for k in pred_batches[0]}
    check(sorted(rows["id"].tolist()) == list(range(N_REQUESTS)),
          f"batch predictor: ids {rows['id'].tolist()}")
    check(not rows["foreign"].any(), "batch predictor: the actor loaded the JAX package")
    launches_c = tuple(int(rows[k].max()) for k in LAUNCH_KEYS)
    check(launches_c == (cfg.n_layers * 2, 0, 0) and sorted(set(rows["launches"].tolist()))
          == [cfg.n_layers, 2 * cfg.n_layers],
          f"batch predictor: launches {sorted(set(rows['launches'].tolist()))}, B2/B3 "
          f"{launches_c[1:]}")
    outs_c, batches_c = [None] * N_REQUESTS, []
    for b in sorted(set(rows["batch"].tolist())):
        sel = np.flatnonzero(rows["batch"] == b)
        batches_c.append({"id": b, "size": len(sel)})
        for j, r in enumerate(sel):
            outs_c[rows["id"][r]] = {"batch": b, "index": j, "token": int(rows["token"][r]),
                                     "logits": rows["logits"][r]}
    check([b["size"] for b in batches_c] == [MAX_BATCH, MAX_BATCH],
          f"batch predictor: batch sizes {[b['size'] for b in batches_c]}")
    diff_c = rebuild_batches("batch predictor", params, cfg, prompts, outs_c, batches_c)
    del params

    # Every batch size B1 met in this phase (the predictor's are checked
    # above to be MAX_BATCH), against its plain version.
    g = torch.Generator(device="cuda").manual_seed(SEED + 10)
    sizes = sorted({b["size"] for s in (stats_a, stats_b) for b in s["batches"]}
                   | set(startup_sizes) | set(handle_s["warmup_batch_sizes"])
                   | set(http_s["warmup_batch_sizes"]))
    for b in sizes:
        check_fwd_case(g, f"serve_stack_b{b}", b, PROMPT_LEN, 16, 16, 128, torch.bfloat16, True)
    torch.cuda.empty_cache()

    out = {
        "card": card,
        "config": "llama_1b (d2048 L16 H16/16 Dh128 ff5504 V32000, bf16 compute), phase 3's "
                  f"weights and {N_REQUESTS} prompts of {PROMPT_LEN}; one replica actor "
                  "(num_gpus=1, max_concurrent_queries=16, @serve.batch 8 / 2 s)",
        "serve_run_s": run_s, "first_answer_s": first_answer_s,
        "replica_start_s": stats_a["start_s"], "replica_build_s": stats_a["build_s"],
        "handle": handle_s, "http": http_s,
        "phase3_batch_latency_s": serving["batch_latency_s"],
        "phase3_solo_batch_latency_s": serving["solo_batch_latency_s"],
        "replica_peak_mem_gb": max(handle_s["peak_mem_gb"], http_s["peak_mem_gb"]),
        "max_logit_diff_vs_reference": diff_a,
        "predictor": {"save_s": save_s, "predict_s": predict_s,
                      "load_s": float(rows["load_s"][0]), "batch_sizes": [MAX_BATCH] * 2,
                      "launches": list(launches_c),
                      "max_logit_diff_vs_reference": diff_c},
        "kernel_checks_at_batch": sizes,
    }
    print(f"serve stack: card {card}; serve.run {run_s:.2f} s, first answer {first_answer_s:.2f} s "
          f"(replica start {stats_a['start_s']:.2f} s, kernel build {stats_a['build_s']}); handle "
          f"median {handle_s['latency_s_median']:.4f} s max {handle_s['latency_s_max']:.4f} s, "
          f"batches {handle_s['batch_sizes']} of {handle_s['batch_device_ms']} ms on the card; "
          f"HTTP median {http_s['latency_s_median']:.4f} s max {http_s['latency_s_max']:.4f} s, "
          f"batches {http_s['batch_sizes']}; predict {predict_s:.2f} s (load "
          f"{out['predictor']['load_s']:.2f} s)", flush=True)
    print(f"phase 10: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return out, {"serve_stack": tuple(stats_a["launches"]),
                 "serve_stack_http": tuple(stats_b["launches"]), "batch_predictor": launches_c}


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
    details = subprocess.run(
        ["nvidia-smi", "--query-gpu=driver_version,clocks.max.sm,ecc.mode.current",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card details (driver, max SM clock, ECC): {details}", flush=True)
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

    try:
        parallel, ring_launches, sharded_launches = phase_parallel(card, training)
        print(json.dumps({"parallel": parallel}), flush=True)
        torch.cuda.empty_cache()
        pipeline, pp_launches = phase_pipeline_experts(card)
        print(json.dumps({"pipeline": pipeline}), flush=True)
        torch.cuda.empty_cache()
        rllib, checkpoint, ckpt_launches = phase_rl_checkpoint(card)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print(json.dumps({"rllib": rllib}), flush=True)
    print(json.dumps({"checkpoint": checkpoint}), flush=True)
    torch.cuda.empty_cache()

    trainer, trainer_launches = phase_runtime_trainer(card, training)
    print(json.dumps({"trainer": trainer}), flush=True)
    torch.cuda.empty_cache()

    serve_stack, stack_launches = phase_serve_stack(card, serving)
    print(json.dumps({"serve_stack": serve_stack}), flush=True)

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
         "launches": serve_launches[0],
         "launches_by_path": {"serving": serve_launches[0], "train_step": train_launches[0],
                              "ring_schedule": ring_launches[0],
                              "sharded_train_step": sharded_launches[0],
                              "pp_train_step": sharded_launches[0],
                              "pipeline_gpipe": pp_launches["gpipe"][0],
                              "pipeline_1f1b": pp_launches["1f1b"][0],
                              "checkpoint_resumed_step": ckpt_launches[0],
                              "trainer_worker_step": trainer_launches[0],
                              **{k: v[0] for k, v in stack_launches.items()}},
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
         "launches_by_path": {"serving": serve_launches[1], "train_step": train_launches[1],
                              "ring_schedule": ring_launches[1],
                              "sharded_train_step": sharded_launches[1],
                              "pp_train_step": sharded_launches[1],
                              "pipeline_gpipe": pp_launches["gpipe"][1],
                              "pipeline_1f1b": pp_launches["1f1b"][1],
                              "checkpoint_resumed_step": ckpt_launches[1],
                              "trainer_worker_step": trainer_launches[1],
                              **{k: v[1] for k, v in stack_launches.items()}},
         **train_timing["flash_attn_bwd_dq"]},
        {"name": "flash_attn_bwd_dkv", "route": "cuda", "source": source + flash.BWD_SOURCE,
         "replaces": "ray_tpu/ops/pallas/flash_attention.py:199",
         "design": "dkv_wgmma_kernel: warp-specialised, a producer warpgroup (setmaxnreg "
                   "24) loads k/v once and q/dO through a 3-stage ring by TMA with mbarriers; "
                   "2 consumer warpgroups (setmaxnreg 240) x 64 kv rows, lse/delta by "
                   "cp.async a tile ahead, wgmma for S^T, dP^T (shared memory) and dV, dK "
                   "(P^T, dS^T from registers)",
         "launches": train_launches[2],
         "launches_by_path": {"serving": serve_launches[2], "train_step": train_launches[2],
                              "ring_schedule": ring_launches[2],
                              "sharded_train_step": sharded_launches[2],
                              "pp_train_step": sharded_launches[2],
                              "pipeline_gpipe": pp_launches["gpipe"][2],
                              "pipeline_1f1b": pp_launches["1f1b"][2],
                              "checkpoint_resumed_step": ckpt_launches[2],
                              "trainer_worker_step": trainer_launches[2],
                              **{k: v[2] for k, v in stack_launches.items()}},
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
