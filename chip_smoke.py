#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`ray_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --forward-times   # only B1's times (main_forward_times)
    python3 chip_smoke.py --backward-times  # only B2's and B3's (main_backward_times)
    python3 chip_smoke.py --adamw-times     # only the clip + AdamW kernel's (main_adamw_times)

Phases, in order; any failure raises and the script exits nonzero without
printing the final line:

1. device and build: needs a CUDA card; prints the card's name and power
   limit (nvidia-smi) and builds the flash-attention forward and backward
   kernels and the clip + AdamW kernel (A1) from ray_tpu_torch/csrc with
   nvcc, one nvcc per source, started together; prints each kernel's
   registers, shared memory and spills (ptxas) and, where the toolkit has
   cuobjdump, its HGMMA (wgmma) and HMMA (mma.sync) instruction counts, and
   fails if A1 or a bf16 attention kernel spills, or the latter (all three
   run on wgmma) holds an mma.sync;
2. the forward kernels against their plain PyTorch version on the card
   (FWD_CASES: head_dim 128 and 64, S = 1 to 16384, batch 1 to 16, 4 to
   32 heads, GQA, causal and not, bf16 and f32, and every shape the later
   phases give the kernel; the plain version over slices of the heads,
   PLAIN_SCORES_BYTES of scores each), with times at the serving shape of the
   kernel, the plain version and one PyTorch library call computing the
   same function (a yardstick the port never calls): CUDA events around
   eager calls, as a caller waits, and CUDA-graph replays, the card alone,
   with the host's time to issue a call (forward_times); then A1 at
   InternLM2-1.8B's 12 leaves in f32 and bf16 (phase_adamw): two updates,
   under and over the clip, each output element against the plain chain in
   f64 on the same inputs (ADAMW_TERM_SHARE), and the times of the kernel,
   the plain chain and the library's fused AdamW;
3. the serving path at the full width of TransformerConfig.llama_1b (random
   weights from a seeded generator): 16 requests of 1024 tokens from 16
   threads through `@serve.batch(max_batch_size=8)`, the kernel's launch
   count read around that run, and one batch recomputed with the plain
   reference attention; then one batch alone, host-timed, and a
   torch.profiler breakdown of one batch's device time by kernel;
4. the backward kernels (dq, dk/dv) after the forward kernel against the
   plain forward and backward in f32 from the same inputs (BWD_CASES: the
   training shape causal and full and with a permuted dO, head_dim 128 and
   64, S = 1 to 16384, batch 1 to 16, GQA, causal and not, bf16 and f32,
   and every shape the later phases give the kernels),
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
   bench.py's head configuration cut to 8 of its 16 layers, 2 steps each
   with exact launch counts, the first loss against the single-device
   step's at that depth, step times and peak memory;
7. pipeline and experts: (b) the GPipe (`pipeline_apply`, autograd through
   it) and 1F1B (`pipeline_train_step_1f1b`) schedules of bench.py's head
   configuration at 8 of its 16 layers, cut into 4 stages of 2 layers, all
   in one process, at
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
   the card's name, its card id (0) and its CUDA_VISIBLE_DEVICES from a
   worker that loaded nothing of the JAX package;
   (b) TorchTrainer with one worker actor holding the card (TorchConfig:
   a one-rank NCCL group) trains phase 5's configuration, seed and batch
   for 4 steps, reporting through the session, with a sharded checkpoint
   after step 2 and a failure after step 3 on the first attempt; the group
   restarts from the checkpoint and runs steps 3 and 4. Every step equals
   phase 5's step of its number bit for bit with 16/16/16 launches, and
   the run's checkpoint restores here to a step equal to the resumed one;
   the worker's card id; times of fit(), the first report, the restart
   and the worker's step;
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
   its peak memory, predict() with its checkpoint load, and the card ids of
   the replica and the predictor actor;
11. the RL algorithm classes, their learners on the card in this process
   and their env runners actors of the port's runtime on the CPU: (a)
   `PPOConfig().build()` at phase 8's PPO configuration, train() until the
   mean return reaches 120 (at most 100 iterations): build() seconds (the
   runners' cold start), iterations and iterations/s, env steps/s, each
   learner update's CUDA-event ms and host issue ms beside phase 8's; the
   card's free memory before build() and after the runners answer ping
   within RL_RUNNER_MEM of each other (no runner opens a CUDA context);
   (b) save() after the last iteration and restore() into a second PPO on
   the card: every leaf, Adam moment and the generator's state equal, and
   one update of each on one fixed batch equal, bit for bit; (c) IMPALA
   and APPO, 3 iterations each; DQN, 3 iterations, then its greedy action
   against the argmax of the learner's Q; SAC, 3 iterations on Pendulum;
   MultiAgentPPO, 1 iteration with a shared and with independent policies.
   Every metric finite, no actor of a stopped algorithm alive, and no
   attention kernel launched in the phase;
12. tune over the trainer on the card: (a) `tune.Tuner` over
   `ray_tpu_torch.train.torch.TorchTrainer` (one worker, use_gpu) at phase
   5's configuration, learning rates 3e-4 (phase 5's) and 1e-4 as a grid,
   3 steps each, trials of CPU 1: each trial's worker holds the one "GPU",
   so the second waits for the card until the first ends; both end
   TERMINATED, the 3e-4 trial's steps equal phase 5's bit for bit, the 1e-4
   trial's first step equals phase 5's and its second differs, each worker
   holds card ids [0], the step windows do not overlap, 16/16/16 launches a
   step, and get_best_result() is the lower last loss; times of fit(), each
   trial's first report and the second trial's wait for the card; (b) a
   function trainable in a trial actor holding the card ({"CPU": 1, "GPU":
   1}) trains phase 5's configuration at 2 layers for 4 steps, reporting a
   Checkpoint.from_torch_state each step, fails once after step 2 and is
   retried from that checkpoint (FailureConfig(max_failures=1)): its steps
   equal an unbroken run of the same steps here bit for bit, 2/2/2
   launches a step, card ids [0], the restore's seconds; (c)
   `prepare_model` in a TorchTrainer worker puts a Linear(4, 1) on the
   worker's cuda:0, and its loss falls through `prepare_data_loader`'s
   batches. Every wait of the phase is bounded by TUNE_TIMEOUT;
13. the cluster layer, each part in processes of its own that import this
   script from its directory: (a) `JobSubmissionClient` submits a job (its
   log and entrypoint under a .jobs-* directory beside this script, removed
   after) that trains phase 5's configuration from its seed for 3 steps
   with the kernels phase 1 built: SUCCEEDED, its losses and grad norms read
   back from its log equal phase 5's first three bit for bit, 16/16/16
   launches a step; a second job holds 8 GiB of the card and multiplies
   until `stop_job`: STOPPED, and neither nvidia-smi nor the card's free
   memory shows it after; (b) `python -m ray_tpu_torch.scripts.cli start
   --head` with its session under a .cluster-* directory (removed after), a
   driver attached by its head.json running phase 3's first batch (llama_1b,
   its weights and first 8 prompts) as a num_gpus=1 task: the logits equal
   phase 3's bit for bit, B1 16 times and B2, B3 never, card id 0; `cli
   status` shows the head's "GPU" 1; `cli stop` ends the head and its
   worker, off the card; (c) a driver whose head holds no "GPU"
   (RAY_TPU_CHIPS=0) and a StandardAutoscaler over LocalNodeProvider with
   one node type {"CPU": 2, "GPU": 1}, max 1: the same batch waits, the
   autoscaler adds the node, the task runs in its worker on card 0 with the
   same logits, and the idle node is terminated, its worker off the card;
   (d) `cli microbenchmark --json`: the port's ray_perf, all eight benches.
   Times from submit to RUNNING, to the first step and to SUCCEEDED, of the
   attached driver's task, from demand to node and node to result. Every
   wait is bounded by CLUSTER_TIMEOUT;
14. the repo's drivers: (a) `python bench_torch.py` as a user runs it (the
   head configuration, then bench.py's sweep 8 x 2048, 4 x 4096, 2 x 8192
   and 1 x 16384 at constant tokens a step, remat_policy None at 16384):
   its one line, with bench.py's keys, every sweep point finite with
   0 < mfu < 1 and neither an error nor skipped; (b) at each sweep point's
   configuration and batch, one step from a fresh seeded state here with
   exact launches (16/16/16, and 32/16/16 at 16384) and its peak memory,
   its loss within TRAIN_LOSS_TOL of the same state's forward with the
   plain reference attention; B1, B2, B3 and the delta pre-pass timed at
   [1, 16384, 16, 128] beside their bounds; (c) `python
   scripts/profile_step_gpu.py`, which must exit 0 and print every line,
   then one step of its full-step configuration (d1536 L24 H12, remat
   None, batch 8 x 2048) as in (b): 48/24/24 launches. Each driver is
   bounded by DRIVER_TIMEOUT.

Launches are counted as deltas of `_build.launch_counts()` (the counter
`cuda_kernel_launches`, by C entry point) around the work, in the process
that launches. Every training step whose launches are counted (phases 5,
6, 8, 9, 12, 13 and 14) also holds A1 to one launch a leaf; the kernels
line gives A1's count a step by path (ADAMW_LAUNCHES).

Prints JSON lines of the serving and training numbers, the profiles, the
pipeline and experts, the RL learners, the checkpoint, the trainer, the
serve stack, the RL algorithms, tune, the cluster layer, the drivers and
the kernels, and last {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import pickle
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

import bench_torch
import ray_tpu_torch
from ray_tpu_torch import dryrun, serve
from ray_tpu_torch.air import BatchPredictor, Checkpoint, Predictor
from ray_tpu_torch.models import (
    LMTrainContext,
    MoEConfig,
    TransformerConfig,
    cross_entropy_loss,
    default_optimizer,
    forward,
    init_moe_params,
    init_params,
    moe_ffn,
)
from ray_tpu_torch.models import lm, moe, transformer
from ray_tpu_torch.ops.cuda import _build, adamw
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
    CartPoleVectorEnv,
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
from ray_tpu_torch.rllib import apply_policy, dqn, ppo, sac
from ray_tpu_torch.util.state import list_actors
from ray_tpu_torch.rllib.sample_batch import ACTIONS, ADVANTAGES, LOGPS, OBS, RETURNS


def _script(name: str):
    """A module of scripts/ (a directory, not a package), from its file."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


profile_step_gpu = _script("profile_step_gpu")

# H100 SXM published dense peaks (NVIDIA data sheet), at a 700 W limit; the
# bf16 peak is bench_torch.py's, by the card's name (`peak_flops`).
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


def peak_flops(dtype) -> float:
    """The card's dense peak in `dtype`: bf16's from bench_torch.py's table
    by the card's name, f32's outside the tensor cores otherwise."""
    if dtype == torch.bfloat16:
        return bench_torch.card_peak(torch.cuda.get_device_name())
    return PEAK_F32_FLOPS


def bound(flops: float, nbytes: float, dtype):
    peak = peak_flops(dtype)
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


# The attention shapes of phase 14's paths: bench.py's sequence sweep at the
# head configuration's 16 heads, the profiler's, and 4 q heads over 1 kv
# head at the sweep's longest sequence (name, B, S, H, Hkv, head_dim, dtype,
# causal).
SWEEP_CASES_FWD = [
    *((f"sweep_{s}", b, s, 16, 16, 128, torch.bfloat16, True) for b, s in bench_torch.SWEEP),
    ("profile_h12", profile_step_gpu.B, profile_step_gpu.S, profile_step_gpu.H,
     profile_step_gpu.H, profile_step_gpu.Dh, torch.bfloat16, True),
    ("gqa_4_1_16384", 1, 16384, 4, 1, 128, torch.bfloat16, True),
]

# The plain versions hold f32 scores [B, H, Sq, Sk] and, backward, up to
# four more of that size: 17 GB each at [1, 16384, 16, 128]. So they run
# over slices of the kv heads (with their q heads), each slice's scores at
# most PLAIN_SCORES_BYTES; heads are independent, so the slices joined are
# the plain version's result.
PLAIN_SCORES_BYTES = 4 << 30


def plain_attention(q, k, v, causal: bool, do=None) -> tuple:
    """The plain forward (o, lse) in f32 of these inputs and, given dO, the
    plain backward (dq, dk, dv) from that o and lse, over slices of the
    heads."""
    b, sq, h, _ = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    group = h // hkv
    n = max(1, PLAIN_SCORES_BYTES // (b * group * sq * sk * 4))
    outs = []
    for j in range(0, hkv, n):
        kv, qh = slice(j, j + n), slice(j * group, (j + n) * group)
        f32 = [t.float() for t in (q[:, :, qh], k[:, :, kv], v[:, :, kv])]
        o, lse = flash.flash_attention_fwd_plain(*f32, causal=causal)
        grads = None if do is None else flash.flash_attention_bwd_plain(
            *f32, o, lse, do[:, :, qh].float(), causal=causal)
        outs.append((o, lse, grads))
    grads = None if do is None else tuple(torch.cat([x[2][i] for x in outs], 2)
                                          for i in range(3))
    return torch.cat([x[0] for x in outs], 2), torch.cat([x[1] for x in outs], 1), grads


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
    # The shapes phase 14 gives B1: bench.py's sequence sweep, the
    # profiler's 12 heads, and GQA at the sweep's longest sequence.
    *SWEEP_CASES_FWD,
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


# InternLM2-1.8B's widths (huggingface.co/internlm/internlm2-1_8b), the
# model of the benchmark's train-4k cell: its 12 leaves are what A1 is
# checked and timed at.
INTERNLM2_1_8B = TransformerConfig(vocab_size=92544, d_model=2048, n_layers=24, n_heads=16,
                                   n_kv_heads=8, d_ff=8192)
# default_optimizer()'s constants.
ADAMW_HYPER = dict(learning_rate=3e-4, weight_decay=0.1, b1=0.9, b2=0.95, eps=1e-8,
                   max_norm=1.0)
# A1 against the plain chain (`_clip_adamw_plain`) run in f64 on the same
# inputs, element by element. An f32 output lies within 2^-20 of the
# magnitude of the terms of the sum that forms it: the kernel rounds a few
# times in f32, each time by at most 2^-24 of what it rounds, and a sum may
# cancel down to those errors. A bf16 output may lie one bf16 ulp of the
# f64 value further off: the kernel rounds each stored value once, by half
# an ulp, and its f32 error may carry it over a rounding boundary. A value
# left unwritten, a term dropped or a constant misplaced is off by far more;
# the check asserts that the inputs themselves lie outside the tolerance.
ADAMW_TERM_SHARE = 2.0 ** -20
# Elements a chunk of the f64 reference holds (eight f64 temporaries of
# 0.27 GB at a time beside the leaves).
ADAMW_CHUNK = 1 << 25


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp of each element of `x`: 2^(e-8) where |x| lies in
    [2^(e-1), 2^e), the subnormal step 2^-133 at least."""
    _, e = torch.frexp(x)
    ulp = torch.ldexp(torch.ones_like(x), (e - 8).clamp(min=-133))
    return torch.where(x == 0, 2.0 ** -133, ulp)


def adamw_gaps(before: list, grads: list, after: list, norm, count: int) -> dict:
    """A1's update of each leaf (`after`, its p, mu and nu as the kernel
    wrote them) against the plain chain run in f64 on the same inputs
    (`before`, its p, mu and nu before; `grads`), with the norm `norm` and
    step count `count`: each output's largest error as a share of its
    element's tolerance (`worst`, at most 1 to pass), and the same share of
    the value it held before (`unwritten`, above 1 where the check sees a
    value the kernel would leave unwritten). The tolerance is
    ADAMW_TERM_SHARE of the magnitude of the terms: mu's |b1 mu| + |(1 - b1)
    g'|, nu's own value, p's |p| (1 + lr wd) + lr (mu's magnitude) / (bc1
    (sqrt(nu_hat) + eps)), which also bounds what mu's error moves p by;
    one bf16 ulp of the f64 value more for bf16 leaves."""
    h = ADAMW_HYPER
    lr, wd, b1, b2, eps = (h[k] for k in ("learning_rate", "weight_decay", "b1", "b2", "eps"))
    worst, unwritten = dict.fromkeys(("p", "mu", "nu"), 0.0), dict.fromkeys(("p", "mu", "nu"), 0.0)
    for (p0, m0, v0), g, outs in zip(before, grads, after):
        flat = [t.reshape(-1) for t in (p0, g, m0, v0, *outs)]
        for lo in range(0, p0.numel(), ADAMW_CHUNK):
            p0c, gc, m0c, v0c, pk, mk, vk = (t[lo:lo + ADAMW_CHUNK] for t in flat)
            p, g64, m, v = (t.double() for t in (p0c, gc, m0c, v0c))
            lm._clip_adamw_plain([g64], [m], [v], [p], norm, count, **h)
            mu_mag = b1 * m0c.double().abs() + (1 - b1) * g64.abs()
            p_mag = (p0c.double().abs() * (1 + lr * wd)
                     + lr * mu_mag / ((1 - b1 ** count) * ((v / (1 - b2 ** count)).sqrt() + eps)))
            for name, ref, mag, ours, old in (("p", p, p_mag, pk, p0c), ("mu", m, mu_mag, mk, m0c),
                                              ("nu", v, v, vk, v0c)):
                # At least the least f32 step, where every term is 0 (a
                # gradient drawn as exactly 0 from zero moments).
                tol = ADAMW_TERM_SHARE * mag + (bf16_ulp(ref) if ours.dtype == torch.bfloat16
                                                else 2.0 ** -149)
                share = ((ours.double() - ref).abs() / tol).nan_to_num(nan=float("inf"))
                worst[name] = max(worst[name], share.max().item())
                unwritten[name] = max(unwritten[name],
                                      ((old.double() - ref).abs() / tol).max().item())
    return {"worst": worst, "unwritten": unwritten}


def adamw_times(dtype) -> dict:
    """A1 at InternLM2-1.8B's 12 leaves in `dtype`, after the global norm.
    First two updates of all 12 leaves by `clip_adamw`, each checked by
    adamw_gaps: the first with the gradients' own norm (under the clip)
    from zero moments, the second with fresh gradients and ten times their
    norm (over it).
    Then, on the same card tensors, CUDA events around eager updates, as a
    step waits for them: the kernel (`ms`, one launch a leaf), the plain
    `_foreach` chain (`plain_ms`), the library's fused AdamW (`library_ms`:
    torch._fused_adamw_ with the clip as its grad_scale, a yardstick the
    port never calls, which also writes the unscaled gradients back, 32 B a
    parameter in f32) and the global norm (`norm_ms`); the kernel's bound
    (28 B a parameter in f32, 14 in bf16, at the card's peak bytes/s) and
    the bytes/s it reached. The timed updates take the gradients' own norm,
    under the clip, so the chain's in-place clip and the library's
    unscaling leave the gradients as they are."""
    g = torch.Generator(device="cuda").manual_seed(SEED)
    params = [p.detach().to(dtype) for p in
              tree_leaves(init_params(INTERNLM2_1_8B, g, device="cuda"))]
    grads = [(torch.randn(p.shape, generator=g, device="cuda") * 1e-5).to(dtype)
             for p in params]
    mu, nu = [torch.zeros_like(p) for p in params], [torch.zeros_like(p) for p in params]
    checks, seen = {}, dict.fromkeys(("p", "mu", "nu"), 0.0)
    for count in (1, 2):
        if count == 2:  # fresh gradients, as the next step's
            for t in grads:
                t.copy_(torch.randn(t.shape, generator=g, device="cuda") * 1e-5)
        norm = lm._global_norm(grads)
        n = norm if count == 1 else norm * 10
        before = [(p.clone(), m.clone(), v.clone()) for p, m, v in zip(params, mu, nu)]
        since = _build.launch_counts()
        adamw.clip_adamw(grads, mu, nu, params, n, count, **ADAMW_HYPER)
        launched = adamw_launches(since)
        check(launched == len(params), f"A1 {dtype}: {launched} launches for {len(params)} leaves")
        gaps = adamw_gaps(before, grads, list(zip(params, mu, nu)), n, count)
        del before
        torch.cuda.empty_cache()
        checks[f"step_{count}_norm_{float(n):.4f}"] = gaps
        print(f"A1 {dtype} update {count} (norm {float(n):.4f}) against the plain chain in f64: "
              f"{json.dumps(gaps)}", flush=True)
        check(all(v <= 1 for v in gaps["worst"].values()),
              f"A1 {dtype} update {count}: an output outside its tolerance: {gaps['worst']}")
        seen = {k: max(v, gaps["unwritten"][k]) for k, v in seen.items()}
    # A bf16 moment may move by less than an ulp in one update (nu by 5% at
    # most), so the outputs left unwritten must show in one of the two.
    check(all(v > 1 for v in seen.values()),
          f"A1 {dtype}: the check cannot see an unwritten value: {seen}")
    nbytes = 7 * params[0].element_size() * sum(p.numel() for p in params)
    ms = time_ms(lambda: adamw.clip_adamw(grads, mu, nu, params, norm, 3, **ADAMW_HYPER),
                 iters=10)
    least_ms, _ = bound(0.0, nbytes, dtype)
    steps = [torch.full((), 3.0, device="cuda") for _ in params]
    scale = torch.clamp(norm, min=ADAMW_HYPER["max_norm"]) / ADAMW_HYPER["max_norm"]
    h = ADAMW_HYPER
    library = lambda: torch._fused_adamw_(  # noqa: E731
        params, grads, mu, nu, [], steps, lr=h["learning_rate"], beta1=h["b1"], beta2=h["b2"],
        weight_decay=h["weight_decay"], eps=h["eps"], amsgrad=False, maximize=False,
        grad_scale=scale, found_inf=None)
    return dict(
        dtype=str(dtype), leaves=len(params), params=sum(p.numel() for p in params),
        checks=checks, bytes=nbytes, ms=ms, bytes_per_s=nbytes / ms * 1e3, bound_ms=least_ms,
        plain_ms=time_ms(lambda: lm._clip_adamw_plain(grads, mu, nu, params, norm, 3,
                                                      **ADAMW_HYPER), iters=5),
        library_ms=time_ms(library, iters=10),
        norm_ms=time_ms(lambda: lm._global_norm(grads), iters=10),
    )


def phase_adamw() -> dict:
    """A1 checked and timed (adamw_times) for f32 leaves (the benchmark's
    masters) and bf16 ones (bench_torch.py's)."""
    times = {}
    for dtype in (torch.float32, torch.bfloat16):
        times[str(dtype)] = adamw_times(dtype)
        torch.cuda.empty_cache()
    return times


def main_adamw_times() -> int:
    """`python3 chip_smoke.py --adamw-times`: phase_adamw, and nothing else,
    for the `ray_tpu_torch` beside this script."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    print(f"card: {card_line()}", flush=True)
    print(json.dumps({"adamw_times": phase_adamw()}), flush=True)
    return 0


def check_fwd_case(g, name, b, s, h, hkv, d, dtype, causal) -> tuple:
    """B1 against its plain version at one shape, from random inputs;
    returns the largest error in o and the inputs."""
    q, k, v = rand_qkv(g, b, s, h, hkv, d, dtype)
    o, lse = flash.flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    o_p, lse_p, _ = plain_attention(q, k, v, causal)
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
    # Warm-up batch (cuBLAS handles and heuristics), outside the counted run;
    # its logits are the batch phase 13's tasks must give.
    server.predict_batch.__wrapped__(server, prompts[:MAX_BATCH])
    first_batch = server.batches[0][3].cpu().numpy()
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
    since = _build.launch_counts()
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    launches = launch_counts(since)
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
    return serving, launches, first_batch


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
    # The shapes phase 14 gives B2 and B3 (see FWD_CASES).
    *(case + (False,) for case in SWEEP_CASES_FWD),
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
        o_p, lse_p, plain = plain_attention(q, k, v, causal, do)
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
        del q, k, v, do, o, lse, grads, o_p, lse_p, plain
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
    return bench_torch.make_cfg(TRAIN_SEQ)


# B1's, B2's and B3's C entry points, as `_build.launch_counts()` names them.
LAUNCH_KEYS = ("flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv")


def launch_counts(since: dict) -> tuple:
    """B1's, B2's and B3's launches in this process since `since`, a
    `_build.launch_counts()` taken before the work."""
    now = _build.launch_counts()
    return tuple(now.get(k, 0) - since.get(k, 0) for k in LAUNCH_KEYS)


def adamw_launches(since: dict) -> int:
    """A1's launches in this process since `since`, as `launch_counts`."""
    return _build.launch_counts().get("adamw_update", 0) - since.get("adamw_update", 0)


# The leaves of a dense TransformerConfig's parameter tree (embed, final
# norm, head and 9 stacked [L, ...] leaves): A1's launches in one step.
LM_LEAVES = 12
# A1's launches in one step of each training path, as that path's own run
# counted them.
ADAMW_LAUNCHES = {}


def counted_step(ctx, state, batch, expect: tuple, what: str, path: str = None):
    """One train step with the kernels' launches counted around it: B1-B3
    against `expect`, A1 once a leaf; A1's count recorded under `path` in
    ADAMW_LAUNCHES where one is given."""
    leaves = len(state["opt_state"]["mu"])
    since = _build.launch_counts()
    state, metrics = ctx.train_step(state, batch)
    got, got_adamw = launch_counts(since), adamw_launches(since)
    check(got == expect, f"{what}: launches (fwd, dq, dkv) = {got}, expected {expect}")
    check(got_adamw == leaves, f"{what}: {got_adamw} clip + AdamW launches for {leaves} leaves")
    if path is not None:
        ADAMW_LAUNCHES[path] = got_adamw
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
    """The training cell's global batch on the card, bench_torch.py's head
    batch: one seeded draw of TRAIN_BATCH x (TRAIN_SEQ + 1) tokens, shifted
    into tokens and targets."""
    return bench_torch.token_batch(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, "cuda")


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
        state, m = counted_step(ctx, state, batch, per_step, f"timed step {i}", "train_step")
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
    peak = peak_flops(torch.bfloat16)
    training = {
        "card": card,
        "config": "bench.py head: d2048 L16 H16/16 Dh128 ff5504 V32000, bf16 params and "
                  "compute, remat qkv_attn, batch 16 x seq 1024, dp on one card",
        "n_params": n_params, "warmup_steps": WARMUP_STEPS, "timed_steps": TIMED_STEPS,
        "timed_s": dt, "step_s": dt / TIMED_STEPS,
        "train_tokens_per_s": tokens_per_s,
        "mfu": param_flops * tokens_per_s / peak,
        "mfu_attn_incl": (param_flops + attn_flops) * tokens_per_s / peak,
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
# The sharded steps run at this many of bench.py's 16 layers, against the
# single-device step at the same depth (the script's time: each strategy
# builds its state and takes 3 steps, one profiled).
SHARDED_LAYERS = 8


def ring_schedule_check(name, b, h, hkv, g) -> tuple:
    """The ring's chunk schedule (one process, RING_N virtual ranks)
    against whole-sequence B1, B2 and B3 and the plain f32 versions, with
    its launch counts and times beside the whole-sequence kernels'."""
    q, k, v = rand_qkv(g, b, TRAIN_SEQ, h, hkv, 128, torch.bfloat16)
    do = torch.randn(q.shape, generator=g, device="cuda").to(torch.bfloat16)
    o, lse = flash.flash_attention_fwd(q, k, v, causal=True)
    whole = flash.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    since = _build.launch_counts()
    ring_o, ring_lse, *ring_grads = ring_schedule(q, k, v, do, n=RING_N, causal=True)
    torch.cuda.synchronize()
    launches = launch_counts(since)
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


def phase_parallel(card: str) -> tuple:
    """(a) the ring's chunk schedule at full width in one process; (b) the
    sharded training step under every ported strategy at world size 1, a
    one-rank NCCL group on the card, at SHARDED_LAYERS layers: its first
    loss, first gradient norm and second loss against the single-device
    step's at that depth on the same weights and batch, its launches, step time, peak memory and a profile of one
    step. The card's machine has one card, so no number here is of more
    than one."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    ring, ring_launches = {}, None
    for name, b, h, hkv in RING_CASES:
        launches, ring[name] = ring_schedule_check(name, b, h, hkv, g)
        ring_launches = ring_launches or launches
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(bench_config(), n_layers=SHARDED_LAYERS)
    batch = train_batch(cfg)  # the single-device step's global batch
    per_step = (cfg.n_layers,) * 3
    ctx = LMTrainContext(cfg)  # the single-device step at this depth
    state, single = ctx.init_state(SEED), []
    for i in range(2):
        state, m = counted_step(ctx, state, batch, per_step, f"single-device step {i}")
        single.append((float(m["loss"]), float(m["grad_norm"])))
    single = {"first_loss": single[0][0], "first_grad_norm": single[0][1],
              "second_loss": single[1][0]}
    del ctx, state
    torch.cuda.empty_cache()
    mesh = build_mesh(MeshSpec(data=1), device_type="cuda")
    steps, disagree = {}, []
    for strategy in STRATEGIES:
        ctx = LMTrainContext(cfg, mesh, strategy)
        state = ctx.init_state(SEED)  # the single-device step's weights
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_s, metrics = [], []
        for i in range(2):
            t0 = time.perf_counter()
            state, m = counted_step(ctx, state, batch, per_step, f"{strategy} step {i}",
                                    "sharded_train_step")
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
        "sharded_step": {"config": f"bench.py head cut to {cfg.n_layers} layers (d2048 "
                                   "H16/16 ff5504 V32000, bf16, remat qkv_attn), batch 16 x "
                                   "1024, on a one-rank mesh",
                         "launches_per_step": dict(zip(("fwd", "dq", "dkv"), per_step)),
                         "single_device": single, "strategies": steps},
    }
    return parallel, ring_launches, per_step


# -- phase 7: pipeline and experts ----------------------------------------------

# The pipeline schedules at bench.py's head configuration cut to PP_LAYERS of
# its 16 layers (the script's time: the schedules are host-bound, so their
# time, the profile's above all, goes with the depth), in PP_STAGES stages
# of 2, all in one process (one card): M = 16, the derived count at batch 16
# (the largest divisor up to 4P), and M = 4.
PP_LAYERS = 8
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
    cfg = dataclasses.replace(bench_config(), n_layers=PP_LAYERS)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    batch = train_batch(cfg)
    L = cfg.n_layers
    since = _build.launch_counts()
    unpipelined = lambda: _loss_and_grads(cfg, params, batch, "unpipelined")  # noqa: E731
    (ref_loss, ref), _, ref_peak, _ = _timed_run(unpipelined)
    check(launch_counts(since) == (L, L, L), f"unpipelined launches {launch_counts(since)}")
    _, ref_s, _, ref_issue = _timed_run(unpipelined)
    ref_norm = _grad_norm(ref)
    out = {"config": f"bench.py head cut to {L} layers (d2048 H16/16 ff5504 V32000, bf16, "
                     f"remat qkv_attn), batch {TRAIN_BATCH} x {TRAIN_SEQ}, {PP_STAGES} stages of "
                     f"{L // PP_STAGES} layers in one process",
           "unpipelined": {"loss": float(ref_loss), "grad_norm": ref_norm, "s": ref_s,
                           "host_issue_s": ref_issue, "peak_mem_gb": ref_peak}}
    launches, bad = {}, []
    for schedule in ("gpipe", "1f1b"):
        for m in PP_MICROBATCHES:
            expect = ((m * L // PP_STAGES * (2 * PP_STAGES - 1)) if schedule == "1f1b"
                      else m * L, m * L, m * L)
            run = lambda: _loss_and_grads(cfg, params, batch, schedule, m)  # noqa: E731
            since = _build.launch_counts()
            (loss, grads), _, peak, _ = _timed_run(run)
            got = launch_counts(since)
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
    since = _build.launch_counts()
    with torch.no_grad():
        logits = fn(*args)
    torch.cuda.synchronize()
    got = launch_counts(since)
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
    resumed, m_resumed = counted_step(ctx, restored, batch, per_step, "resumed step",
                                      "checkpoint_resumed_step")
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


def visible_card(card_id: int) -> str:
    """What a worker given card `card_id` sees as its CUDA_VISIBLE_DEVICES:
    this process's entry at that index where it has the variable, else the
    id."""
    parent = os.environ.get("CUDA_VISIBLE_DEVICES")
    return str(card_id) if parent is None else parent.split(",")[card_id].strip()


def foreign_modules() -> list:
    """The modules of the JAX package, or of jax, this process has loaded."""
    return sorted(m for m in sys.modules if m.split(".")[0] in ("ray_tpu", "jax", "jaxlib"))


def gpu_probe() -> tuple:
    """Run as a num_gpus=1 task: the card's name as its worker sees it, what
    of the JAX package that worker loaded, the card ids the runtime gave it
    and its CUDA_VISIBLE_DEVICES."""
    return (torch.cuda.get_device_name(0), foreign_modules(), ray_tpu_torch.get_gpu_ids(),
            os.environ.get("CUDA_VISIBLE_DEVICES"))


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
             "failed_at": failed and failed["failed_at"], "foreign_modules": foreign_modules(),
             "gpu_ids": ray_tpu_torch.get_gpu_ids(),
             "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES")}
    for step in range(first, TRAINER_STEPS + 1):
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        since = _build.launch_counts()
        state, m = ctx.train_step(state, batch)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        fwd, dq, dkv = launch_counts(since)
        report = {**(start if step == first else {"attempt": start["attempt"]}), "step": step,
                  "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                  "step_s": step_s, "launches": [fwd, dq, dkv],
                  "adamw_launches": adamw_launches(since),
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
        name, foreign, task_ids, task_visible = ray_tpu_torch.get(
            ray_tpu_torch.remote(num_gpus=1)(gpu_probe).remote(), timeout=300)
        task_s = time.perf_counter() - t0
    finally:
        ray_tpu_torch.shutdown()
    check(name == torch.cuda.get_device_name(0), f"runtime: the task saw {name!r}")
    check(foreign == [], f"runtime: the task's worker loaded {foreign}")
    check(task_ids == [0] and task_visible == visible_card(0),
          f"runtime: the task holds card ids {task_ids}, sees {task_visible!r}")
    runtime = {"init_s": init_s, "resources": resources, "first_gpu_task_s": task_s,
               "task_device": name, "task_gpu_ids": task_ids,
               "task_cuda_visible_devices": task_visible}
    print(f"runtime: init {init_s:.3f} s, resources {resources}; first num_gpus=1 task "
          f"(spawn, torch import, CUDA init) {task_s:.3f} s on {name}, card ids {task_ids}, "
          f"CUDA_VISIBLE_DEVICES={task_visible}", flush=True)

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
            check(r["adamw_launches"] == LM_LEAVES, f"trainer: attempt {r['attempt']} step "
                  f"{r['step']}: {r['adamw_launches']} clip + AdamW launches")
        ADAMW_LAUNCHES["trainer_worker_step"] = reports[0]["adamw_launches"]
        first, resumed = hist[0], hist[2]
        for r in (first, resumed):
            check(r["foreign_modules"] == [],
                  f"trainer: attempt {r['attempt']}'s worker loaded {r['foreign_modules']}")
            check(r["gpu_ids"] == [0] and r["cuda_visible_devices"] == visible_card(0),
                  f"trainer: attempt {r['attempt']}'s worker holds card ids {r['gpu_ids']}, "
                  f"sees {r['cuda_visible_devices']!r}")
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
        "worker_gpu_ids": [first["gpu_ids"], resumed["gpu_ids"]],
        "worker_cuda_visible_devices": [first["cuda_visible_devices"],
                                        resumed["cuda_visible_devices"]],
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
          f"bit, launches {first['launches']} each; the workers' card ids {first['gpu_ids']} and "
          f"{resumed['gpu_ids']}, CUDA_VISIBLE_DEVICES={first['cuda_visible_devices']}",
          flush=True)
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
        """Start this process's kernel launch counts, its record of batches
        and its peak memory anew; returns the sizes of the batches dropped
        from the record (those run since the last `stats`)."""
        with self.lock:
            sizes = [b["size"] for b in self.batches]
            self.since = _build.launch_counts()
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
                    "launches": launch_counts(self.since),
                    "batches": batches, "peak_bytes": torch.cuda.max_memory_allocated(),
                    "foreign_modules": foreign_modules(), "build_s": kernel_builds(),
                    "start_s": self.start_s, "gpu_ids": ray_tpu_torch.get_gpu_ids(),
                    "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES")}


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
        p.since = _build.launch_counts()
        return p

    def predict(self, batch):
        toks = torch.as_tensor(np.asarray(batch["tokens"]), dtype=torch.long).to("cuda")
        with torch.no_grad():
            last = forward(self.params, toks, self.cfg)[:, -1, :]
        n = len(toks)
        out = {"id": np.asarray(batch["id"]), "token": last.argmax(-1).cpu().numpy(),
               "logits": last.cpu().numpy(), "batch": np.full(n, self.batches),
               **{k: np.full(n, c) for k, c in zip(LAUNCH_KEYS, launch_counts(self.since))},
               "load_s": np.full(n, self.load_s),
               "foreign": np.full(n, len(foreign_modules())),
               "gpu_ids": np.full(n, ",".join(map(str, ray_tpu_torch.get_gpu_ids()))),
               "cuda_visible_devices": np.full(n, os.environ.get("CUDA_VISIBLE_DEVICES", ""))}
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
    replica's B1-B3 counts taken just before the run and just after;
    the replica must have launched B1 once a layer a batch and B2, B3
    never, and this process none of them."""
    warmup_wall = concurrent_requests(send, prompts[:MAX_BATCH], logits)[2]
    warmup_sizes = ray_tpu_torch.get(handle.reset.remote(), timeout=SERVE_TIMEOUT)
    since = _build.launch_counts()
    outs, lat, wall = concurrent_requests(send, prompts, logits)
    here = launch_counts(since)
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
            check(stats_a["gpu_ids"] == [0] and stats_a["cuda_visible_devices"] == visible_card(0),
                  f"the replica holds card ids {stats_a['gpu_ids']}, sees "
                  f"{stats_a['cuda_visible_devices']!r}")
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
        since = _build.launch_counts()
        t0 = time.perf_counter()
        try:
            out = BatchPredictor.from_checkpoint(ckpt, LMPredictor).predict(
                ds, batch_size=MAX_BATCH, num_actors=1, num_gpus_per_actor=1)
            pred_batches = list(out.iter_batches(batch_size=MAX_BATCH))
        finally:
            tempfile.tempdir = saved_tempdir
        predict_s = time.perf_counter() - t0
        here = launch_counts(since)
        check(here == (0, 0, 0), f"batch predictor: this process launched B1-B3 {here} times")
    finally:
        ray_tpu_torch.shutdown()
        shutil.rmtree(root, ignore_errors=True)

    rows = {k: np.concatenate([b[k] for b in pred_batches]) for k in pred_batches[0]}
    check(sorted(rows["id"].tolist()) == list(range(N_REQUESTS)),
          f"batch predictor: ids {rows['id'].tolist()}")
    check(not rows["foreign"].any(), "batch predictor: the actor loaded the JAX package")
    pred_ids = sorted(set(rows["gpu_ids"].tolist()))
    pred_visible = sorted(set(rows["cuda_visible_devices"].tolist()))
    check(pred_ids == ["0"] and pred_visible == [visible_card(0)],
          f"batch predictor: the actor holds card ids {pred_ids}, sees {pred_visible}")
    launches_c = tuple(int(rows[k].max()) for k in LAUNCH_KEYS)
    fwd_counts = sorted(set(rows[LAUNCH_KEYS[0]].tolist()))
    check(launches_c == (cfg.n_layers * 2, 0, 0) and fwd_counts == [cfg.n_layers, 2 * cfg.n_layers],
          f"batch predictor: launches {fwd_counts}, B2/B3 "
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
        "replica_gpu_ids": stats_a["gpu_ids"],
        "replica_cuda_visible_devices": stats_a["cuda_visible_devices"],
        "predictor_gpu_ids": pred_ids, "predictor_cuda_visible_devices": pred_visible,
    }
    print(f"serve stack: card {card}; serve.run {run_s:.2f} s, first answer {first_answer_s:.2f} s "
          f"(replica start {stats_a['start_s']:.2f} s, kernel build {stats_a['build_s']}); handle "
          f"median {handle_s['latency_s_median']:.4f} s max {handle_s['latency_s_max']:.4f} s, "
          f"batches {handle_s['batch_sizes']} of {handle_s['batch_device_ms']} ms on the card; "
          f"HTTP median {http_s['latency_s_median']:.4f} s max {http_s['latency_s_max']:.4f} s, "
          f"batches {http_s['batch_sizes']}; predict {predict_s:.2f} s (load "
          f"{out['predictor']['load_s']:.2f} s); card ids: replica {stats_a['gpu_ids']} "
          f"(CUDA_VISIBLE_DEVICES={stats_a['cuda_visible_devices']}), predictor actor "
          f"{pred_ids} ({pred_visible})", flush=True)
    print(f"phase 10: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return out, {"serve_stack": tuple(stats_a["launches"]),
                 "serve_stack_http": tuple(stats_b["launches"]), "batch_predictor": launches_c}


# -- phase 11: the RL algorithm classes --------------------------------------------

# The card memory the runner actors of an algorithm may take, read as the
# card's free memory before build() against after the runners answered
# ping: each runner runs on the CPU, and a CUDA context of its own would
# take about 500 MB.
RL_RUNNER_MEM = 256e6
# How long stop() may take to leave none of an algorithm's actors alive.
RL_STOP_TIMEOUT = 60


def ppo_phase11_config():
    """Phase 8's PPO configuration (tests/test_rllib.py::
    test_ppo_cartpole_learns): CartPole, 2 runners x 8 envs x 64 steps, lr
    1e-3, 8 epochs of minibatches of 128, entropy 0.005, seed 7."""
    return (PPOConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=2, num_envs_per_runner=8, rollout_length=64)
            .training(lr=1e-3, num_epochs=8, minibatch_size=128, entropy_coeff=0.005)
            .debugging(seed=7))


def stopped(what: str, algo) -> None:
    """stop() the algorithm, then wait until the runtime lists none of its
    runner actors alive."""
    ids = [r._actor_id for r in algo.runners]
    algo.stop()
    deadline = time.monotonic() + RL_STOP_TIMEOUT
    while True:
        states = {a["actor_id"]: a["state"] for a in list_actors()}
        alive = [a for a in ids if states.get(a) != "DEAD"]
        if not alive or time.monotonic() > deadline:
            break
        time.sleep(0.1)
    check(not alive, f"{what}: actors {alive} alive after stop()")


def finite_results(what: str, results: list) -> None:
    bad = [(r["training_iteration"], k) for r in results for k, v in r.items()
           if not np.isfinite(v)]
    check(not bad, f"{what}: non-finite results {bad}")


def same_leaf(x, y) -> bool:
    if isinstance(x, torch.Tensor):
        return isinstance(y, torch.Tensor) and x.device == y.device and torch.equal(x, y)
    if isinstance(x, torch.Generator):
        return isinstance(y, torch.Generator) and torch.equal(x.get_state(), y.get_state())
    return x == y


def same_state(a, b) -> bool:
    """Two learner states equal bit for bit: every tensor (on the same
    device), Adam's count and the generator's state."""
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(same_leaf(x, y) for x, y in zip(la, lb))


def ppo_algorithm_on_card(phase8: dict) -> dict:
    """(a) PPO to a mean return of 120 with runner actors, the update timed;
    (b) save, restore into a second PPO, and one update of each on one
    fixed batch."""
    cfg = ppo_phase11_config()
    torch.cuda.synchronize()
    free_before = torch.cuda.mem_get_info()[0]
    t0 = time.perf_counter()
    algo = cfg.build()
    build_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    runner_mem = free_before - torch.cuda.mem_get_info()[0]
    check(algo.device.type == "cuda", f"ppo: the learner is on {algo.device}")
    check(runner_mem < RL_RUNNER_MEM,
          f"ppo: the card lost {runner_mem / 1e6:.0f} MB while the runners started")
    update = algo._update
    timings = []

    def timed(state, batch):
        out, ms, host = timed_update(update, state, batch)
        timings.append((ms, host))
        return out

    algo._update = timed
    results, best = [], 0.0
    t0 = time.perf_counter()
    for it in range(1, PPO_MAX_ITERS + 1):
        results.append(algo.train())
        best = max(best, results[-1]["episode_reward_mean"])
        if best >= PPO_TARGET:
            break
    train_s = time.perf_counter() - t0
    finite_results("ppo", results)
    check(best >= PPO_TARGET, f"ppo: best mean return {best:.1f} < {PPO_TARGET} after {it} "
                              "iterations with runner actors")
    update_ms = [t[0] for t in timings]
    issue_ms = [t[1] for t in timings]
    steps = results[-1]["num_env_steps_sampled"]

    # (b) The full learner state through save() and restore().
    algo._update = update
    root = tempfile.mkdtemp(prefix=".rl-", dir=os.path.dirname(os.path.abspath(__file__)))
    algo2 = None
    try:
        t0 = time.perf_counter()
        path = algo.save(os.path.join(root, "ppo"))
        save_s = time.perf_counter() - t0
        algo2 = ppo_phase11_config().debugging(seed=8).build()
        check(not same_state(algo._state, algo2._state), "ppo: a fresh PPO equals the trained one")
        t0 = time.perf_counter()
        algo2.restore(path)
        restore_s = time.perf_counter() - t0
        check(algo2.iteration == algo.iteration, f"ppo: restored iteration {algo2.iteration}")
        check(same_state(algo._state, algo2._state),
              "ppo: the restored learner state differs from the saved one")
        runner = EnvRunner(cfg.env, cfg.num_envs_per_runner, cfg.rollout_length, gamma=cfg.gamma,
                           lam=cfg.lam, seed=99, hidden=cfg.hidden, device="cpu")
        batch = runner.sample(algo.get_weights())["batch"]
        cols = {k: batch[k] for k in PPO_COLUMNS}
        s1, m1 = algo._update(algo._state, cols)
        s2, m2 = algo2._update(algo2._state, cols)
        m1, m2 = ({k: float(v) for k, v in m.items()} for m in (m1, m2))
        check(same_state(s1, s2) and m1 == m2,
              f"ppo: one update from the restored state differs ({m1} vs {m2})")
    finally:
        stopped("ppo", algo)
        if algo2 is not None:
            stopped("ppo (restored)", algo2)
        shutil.rmtree(root, ignore_errors=True)
    out = {"build_s": build_s, "runner_card_mem_bytes": runner_mem,
           "iterations": it, "best_mean_return": best, "train_s": train_s,
           "iterations_per_s": it / train_s, "env_steps": steps,
           "env_steps_per_s_overall": steps / train_s,
           "env_steps_per_sec_median": float(np.median([r["env_steps_per_sec"]
                                                        for r in results])),
           "update_ms_median": float(np.median(update_ms)), "update_ms": update_ms,
           "host_issue_ms_median": float(np.median(issue_ms)),
           "host_share": float(np.median(np.array(issue_ms) / np.array(update_ms))),
           "phase8_update_ms_median": phase8["update_ms_median"],
           "phase8_iterations": phase8["iterations"],
           "save_s": save_s, "restore_s": restore_s,
           "restore_bitwise": True, "update_after_restore": m1}
    print(f"rl algorithms ppo: build() {build_s:.2f} s (2 runner actors, card memory "
          f"{runner_mem / 1e6:.1f} MB); best mean return {best:.1f} after {it} iterations "
          f"({train_s:.1f} s, {it / train_s:.2f} it/s); env steps/s {out['env_steps_per_sec_median']:.0f}"
          f" (train() median), {steps / train_s:.0f} overall; update {out['update_ms_median']:.1f} ms "
          f"(CUDA events, median), host issue {out['host_issue_ms_median']:.1f} ms, host share "
          f"{out['host_share']:.3f}; phase 8 in process {phase8['update_ms_median']:.1f} ms; save "
          f"{save_s:.3f} s, restore {restore_s:.3f} s, the restored state and its next update "
          f"equal bit for bit", flush=True)
    return out


def algorithm_runs(what: str, algo, iterations: int) -> dict:
    """`iterations` of train() on a built algorithm, then stop()."""
    try:
        t0 = time.perf_counter()
        results = [algo.train() for _ in range(iterations)]
        train_s = time.perf_counter() - t0
    finally:
        stopped(what, algo)
    finite_results(what, results)
    last = results[-1]
    print(f"rl algorithms {what}: {iterations} iterations in {train_s:.2f} s; last "
          f"{json.dumps(last)}", flush=True)
    return {"iterations": iterations, "train_s": train_s, "last": last}


def other_algorithms_on_card() -> dict:
    """(c) IMPALA, APPO, DQN, SAC and MultiAgentPPO, each built on the card
    with its runner actors."""
    out = {}
    for name, config in (("impala", IMPALAConfig()), ("appo", APPOConfig())):
        t0 = time.perf_counter()
        algo = config.environment("CartPole-v1").debugging(seed=11).build()
        build_s = time.perf_counter() - t0
        out[name] = {"build_s": build_s, **algorithm_runs(name, algo, 3)}
        check(out[name]["last"]["avg_weights_lag"] >= 0, f"{name}: weights lag")

    t0 = time.perf_counter()
    algo = DQNConfig().environment("CartPole-v1").debugging(seed=3).build()
    build_s = time.perf_counter() - t0
    try:
        results = [algo.train() for _ in range(3)]
        check(results[-1]["loss"] > 0, "dqn: no update ran")
        obs = CartPoleVectorEnv(16, seed=5).reset(seed=5)
        with torch.no_grad():
            q = apply_policy(algo._state["params"],
                             torch.as_tensor(np.asarray(obs, np.float32), device=algo.device))[0]
        want = q.argmax(1).tolist()
        got = [algo.compute_single_action(o, explore=False) for o in obs]
        check(got == want, f"dqn: greedy actions {got}, argmax of the learner's Q {want}")
    finally:
        stopped("dqn", algo)
    finite_results("dqn", results)
    out["dqn"] = {"build_s": build_s, "iterations": 3, "last": results[-1],
                  "greedy_actions_checked": len(got)}
    print(f"rl algorithms dqn: 3 iterations, last {json.dumps(results[-1])}; greedy actions of "
          f"{len(got)} observations equal the argmax of the learner's Q", flush=True)

    # SAC: learning from 256 transitions (its default waits for 1000, and 3
    # iterations of 8 envs x 32 steps collect 768) so that its update runs.
    t0 = time.perf_counter()
    algo = (SACConfig().environment("Pendulum-v1").training(learning_starts=256)
            .debugging(seed=0).build())
    build_s = time.perf_counter() - t0
    out["sac"] = {"build_s": build_s, **algorithm_runs("sac", algo, 3)}
    check("q_loss" in out["sac"]["last"], "sac: no update ran")

    for mapping in ({"agent_0": "shared", "agent_1": "shared"},
                    {"agent_0": "p0", "agent_1": "p1"}):
        name = "multi_agent_" + ("shared" if len(set(mapping.values())) == 1 else "independent")
        t0 = time.perf_counter()
        algo = (MultiAgentPPOConfig()
                .environment(lambda num_envs, seed: MultiAgentCartPole(num_envs, 2, seed))
                .multi_agent(mapping).debugging(seed=5).build())
        build_s = time.perf_counter() - t0
        out[name] = {"build_s": build_s, **algorithm_runs(name, algo, 1)}
        check(all(f"{p}/total_loss" in out[name]["last"] for p in set(mapping.values())),
              f"{name}: a policy did not train")
    return out


def phase_rl_algorithms(card: str, phase8: dict) -> tuple:
    """Phase 11: the RL algorithm classes with the learner on the card and
    the env runners actors of the port's runtime; no attention kernel runs
    in it."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    since = _build.launch_counts()
    ray_tpu_torch.init()
    try:
        out = {"card": card, "ppo": ppo_algorithm_on_card(phase8), **other_algorithms_on_card()}
    finally:
        ray_tpu_torch.shutdown()
    launches = launch_counts(since)
    check(launches == (0, 0, 0), f"rl algorithms: B1-B3 launched {launches} times")
    out["launches"] = list(launches)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 11: {out['seconds']:.1f} s", flush=True)
    return out, launches


# Phase 12: tune over the trainer on the card. (a) A Tuner over a
# TorchTrainer at phase 5's configuration: two learning rates, each trial's
# trainer worker holding the one "GPU", so the trials take the card in
# turn; TUNE_LRS[0] is phase 5's rate (default_optimizer), whose steps equal
# phase 5's bit for bit. (b) A function trainable holding the card itself
# at TUNE_FN_LAYERS layers, a Checkpoint.from_torch_state each step, a
# planned failure after TUNE_FN_FAIL_STEP and a retry from that step's
# checkpoint. (c) prepare_model placing a model on a train worker's card.
TUNE_LRS = (3e-4, 1e-4)
TUNE_STEPS = 3
TUNE_FN_LAYERS = 2
TUNE_FN_STEPS = 4
TUNE_FN_FAIL_STEP = 2
# Every wait of the phase: a Tuner's fit() or a trainer's, each trial's
# workers' cold starts and the second trial's wait for the card included.
TUNE_TIMEOUT = 600


def process_started_at() -> float:
    """This process's start, in seconds since the epoch (Linux /proc): a
    worker that holds a grant of cards is started when the grant is placed."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as f:
        boot = next(int(line.split()[1]) for line in f if line.startswith("btime"))
    return boot + ticks / os.sysconf("SC_CLK_TCK")


def tune_trainer_loop(config: dict) -> None:
    """Phase 12 (a)'s train loop, in a trial's trainer worker: phase 9's
    loop (phase 5's configuration, seed, batch and single-device step) for
    TUNE_STEPS steps at the trial's learning rate."""
    from ray_tpu_torch import train

    entered = time.time()
    torch.set_float32_matmul_precision("highest")  # as trainer_loop: TF32 off
    cfg = bench_config()
    ctx = LMTrainContext(cfg, optimizer=default_optimizer(config["lr"]))
    state = ctx.init_state(SEED)
    batch = train_batch(cfg)
    start = {"lr": config["lr"], "pid": os.getpid(), "placed_at": process_started_at(),
             "entered_at": entered, "foreign_modules": foreign_modules(),
             "gpu_ids": ray_tpu_torch.get_gpu_ids(),
             "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES")}
    for step in range(1, TUNE_STEPS + 1):
        torch.cuda.synchronize()
        started_at = time.time()
        since = _build.launch_counts()
        state, m = ctx.train_step(state, batch)
        torch.cuda.synchronize()
        launches = list(launch_counts(since))
        train.report({**(start if step == 1 else {}), "step": step, "loss": float(m["loss"]),
                      "grad_norm": float(m["grad_norm"]), "launches": launches,
                      "adamw_launches": adamw_launches(since),
                      "started_at": started_at, "reported_at": time.time()})


def tune_function_trainable(config: dict) -> None:
    """Phase 12 (b)'s trainable, in a trial actor that holds the card: phase
    5's configuration at TUNE_FN_LAYERS layers, TUNE_FN_STEPS steps, a
    Checkpoint.from_torch_state with each report; on the first attempt a
    failure after step TUNE_FN_FAIL_STEP's report, once the driver has
    taken it (so that the retry starts from its checkpoint)."""
    from ray_tpu_torch import tune
    from ray_tpu_torch.train import session

    torch.set_float32_matmul_precision("highest")
    marker = os.path.join(config["storage"], "failed_attempt.json")
    attempt = 2 if os.path.exists(marker) else 1
    cfg = dataclasses.replace(bench_config(), n_layers=TUNE_FN_LAYERS)
    ctx = LMTrainContext(cfg)
    state = ctx.init_state(SEED)
    batch = train_batch(cfg)
    first, restore_s = 1, None
    resume = tune.get_checkpoint()
    if resume is not None:
        t0 = time.perf_counter()
        state = resume.get_torch_state(target=state)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        first = state["step"] + 1
    start = {"attempt": attempt, "pid": os.getpid(), "restore_s": restore_s,
             "gpu_ids": ray_tpu_torch.get_gpu_ids(), "foreign_modules": foreign_modules(),
             "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES")}
    for step in range(first, TUNE_FN_STEPS + 1):
        since = _build.launch_counts()
        state, m = ctx.train_step(state, batch)
        torch.cuda.synchronize()
        launches = list(launch_counts(since))
        tune.report({**(start if step == first else {"attempt": attempt}), "step": step,
                     "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                     "launches": launches, "adamw_launches": adamw_launches(since),
                     "reported_at": time.time()},
                    checkpoint=Checkpoint.from_torch_state(state))
        if attempt == 1 and step == TUNE_FN_FAIL_STEP:
            deadline = time.monotonic() + TUNE_TIMEOUT
            while session.get_session()._reports and time.monotonic() < deadline:
                time.sleep(0.05)
            with open(marker, "w") as f:
                json.dump({"failed_at": time.time()}, f)
            raise RuntimeError(f"chip_smoke: planned failure after step {step}")


def prepare_model_loop(config: dict) -> None:
    """Phase 12 (c)'s loop, in a train worker holding the card:
    tests/test_torch_trainer.py's regression (a Linear(4, 1) to a fixed
    linear map) through prepare_model and prepare_data_loader."""
    from torch.utils.data import TensorDataset

    from ray_tpu_torch.train import session
    from ray_tpu_torch.train.torch import prepare_data_loader, prepare_model

    torch.manual_seed(1234)
    model = prepare_model(torch.nn.Linear(4, 1))
    device = next(model.parameters()).device
    opt = torch.optim.SGD(model.parameters(), lr=0.05)
    x = torch.randn(64, 4, generator=torch.Generator().manual_seed(0))
    y = x @ torch.tensor([[1.0, -2.0, 3.0, 0.5]]).T + 0.1
    loader = prepare_data_loader(TensorDataset(x, y), batch_size=16, shuffle=False)
    losses = []
    for _ in range(30):
        for xb, yb in loader:
            opt.zero_grad()
            loss = ((model(xb.to(device)) - yb.to(device)) ** 2).mean()
            loss.backward()
            opt.step()
        losses.append(loss.item())
    session.report({"devices": sorted({str(p.device) for p in model.parameters()}),
                    "gpu_ids": ray_tpu_torch.get_gpu_ids(), "losses": losses})


def bounded(fn, what: str):
    """fn() in a thread, its result or its exception; the phase fails if it
    has not returned within TUNE_TIMEOUT seconds."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:  # noqa: BLE001 - raised below, in the caller
            out["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(TUNE_TIMEOUT)
    check(not t.is_alive(), f"{what} did not return within {TUNE_TIMEOUT} s")
    if "error" in out:
        raise out["error"]
    return out["value"]


def tuner_over_trainer(training: dict, storage: str) -> dict:
    """Phase 12 (a): Tuner.fit() over TorchTrainer, two trials in turn on
    the card, each held to phase 5's steps."""
    from ray_tpu_torch import tune
    from ray_tpu_torch.air import RunConfig, ScalingConfig
    from ray_tpu_torch.train.torch import TorchTrainer

    per_step = [bench_config().n_layers] * 3  # qkv_attn: B1, B2 and B3 once per layer
    trainer = TorchTrainer(tune_trainer_loop,
                           scaling_config=ScalingConfig(num_workers=1, use_gpu=True))
    tuner = tune.Tuner(
        trainer, param_space={"lr": tune.grid_search(list(TUNE_LRS))},
        tune_config=tune.TuneConfig(metric="loss", mode="min",
                                    resources_per_trial={"CPU": 1}),
        run_config=RunConfig(name="trainer", storage_path=storage))
    fit_at = time.time()
    results = bounded(tuner.fit, "tune: Tuner.fit() over TorchTrainer")
    fit_s = time.time() - fit_at
    check(len(results) == len(TUNE_LRS), f"tune: {len(results)} trials")
    hist = {}
    for t in results.trials:
        check(t.status == "TERMINATED" and t.error is None,
              f"tune: trial {t.config} ended {t.status}: {t.error}")
        h = t.metrics_history
        check([r["step"] for r in h] == list(range(1, TUNE_STEPS + 1)),
              f"tune: trial {t.config} reported steps {[r['step'] for r in h]}")
        hist[h[0]["lr"]] = h
    check(sorted(hist) == sorted(TUNE_LRS), f"tune: trials at {sorted(hist)}")
    for lr, h in hist.items():
        first = h[0]
        check(first["foreign_modules"] == [], f"tune: lr {lr}'s worker loaded "
              f"{first['foreign_modules']}")
        check(first["gpu_ids"] == [0] and first["cuda_visible_devices"] == visible_card(0),
              f"tune: lr {lr}'s worker holds card ids {first['gpu_ids']}, sees "
              f"{first['cuda_visible_devices']!r}")
        for r in h:
            check(r["launches"] == per_step, f"tune: lr {lr} step {r['step']} launches "
                  f"{r['launches']}")
            check(r["adamw_launches"] == LM_LEAVES, f"tune: lr {lr} step {r['step']}: "
                  f"{r['adamw_launches']} clip + AdamW launches")
        ADAMW_LAUNCHES["tune_trainer_trial"] = h[0]["adamw_launches"]
    # Phase 5's rate equals phase 5's steps; the other equals its first step
    # (the loss and gradient before any update) and differs from the second.
    base, other = hist[TUNE_LRS[0]], hist[TUNE_LRS[1]]
    for r in base:
        i = r["step"] - 1
        check(r["loss"] == training["losses"][i] and r["grad_norm"] == training["grad_norms"][i],
              f"tune: lr {TUNE_LRS[0]} step {r['step']} loss {r['loss']!r} grad norm "
              f"{r['grad_norm']!r}, phase 5 {training['losses'][i]!r} "
              f"{training['grad_norms'][i]!r}")
    check(other[0]["loss"] == training["losses"][0]
          and other[0]["grad_norm"] == training["grad_norms"][0],
          f"tune: lr {TUNE_LRS[1]}'s first step is not phase 5's")
    check(other[1]["loss"] != training["losses"][1],
          f"tune: lr {TUNE_LRS[1]}'s second step equals phase 5's")
    # The trials took the card in turn: one's steps ended before the other's began.
    a, b = sorted(hist.values(), key=lambda h: h[0]["started_at"])
    check(a[-1]["reported_at"] < b[0]["started_at"],
          "tune: the trials' step windows overlap")
    best = results.get_best_result()
    lowest = min(hist.values(), key=lambda h: h[-1]["loss"])
    check(best.metrics["config"]["lr"] == lowest[0]["lr"]
          and best.metrics["loss"] == lowest[-1]["loss"],
          f"tune: get_best_result() is lr {best.metrics['config']['lr']}, the lowest last "
          f"loss lr {lowest[0]['lr']}")
    return {"fit_s": fit_s,
            "first_report_s": {str(lr): h[0]["reported_at"] - fit_at for lr, h in hist.items()},
            "worker_entered_s": {str(lr): h[0]["entered_at"] - fit_at for lr, h in hist.items()},
            # Both trials asked for the card at fit()'s start (two trial
            # actors at once); the second's worker was placed when the
            # first's released it. Process starts are read from /proc, whose
            # boot time is whole seconds: only their difference is exact.
            "second_trial_card_wait_s": b[0]["placed_at"] - a[0]["placed_at"],
            "handover_s": b[0]["entered_at"] - a[-1]["reported_at"],
            "step_windows_s": [[h[0]["started_at"] - fit_at, h[-1]["reported_at"] - fit_at]
                               for h in (a, b)],
            "losses": {str(lr): [r["loss"] for r in h] for lr, h in hist.items()},
            "grad_norms": {str(lr): [r["grad_norm"] for r in h] for lr, h in hist.items()},
            "best_lr": best.metrics["config"]["lr"],
            "worker_gpu_ids": [h[0]["gpu_ids"] for h in (a, b)],
            "launches_per_step": dict(zip(("fwd", "dq", "dkv"), base[0]["launches"]))}


def function_trial_with_retry(storage: str) -> dict:
    """Phase 12 (b): a function trainable holding the card, failing once
    and retried from its checkpoint; its steps against an unbroken run of
    the same steps in this process."""
    from ray_tpu_torch import tune
    from ray_tpu_torch.air import FailureConfig, RunConfig

    cfg = dataclasses.replace(bench_config(), n_layers=TUNE_FN_LAYERS)
    per_step = [TUNE_FN_LAYERS] * 3
    tuner = tune.Tuner(
        tune_function_trainable, param_space={"storage": storage},
        tune_config=tune.TuneConfig(metric="loss", mode="min",
                                    resources_per_trial={"CPU": 1, "GPU": 1}),
        run_config=RunConfig(name="function", storage_path=storage,
                             failure_config=FailureConfig(max_failures=1)))
    fit_at = time.time()
    results = bounded(tuner.fit, "tune: Tuner.fit() of the function trainable")
    fit_s = time.time() - fit_at
    (trial,) = results.trials
    check(trial.status == "TERMINATED" and trial.error is None and trial.num_failures == 1,
          f"tune: the function trial ended {trial.status} after {trial.num_failures} "
          f"failures: {trial.error}")
    hist = trial.metrics_history
    got = [(r["attempt"], r["step"]) for r in hist]
    check(got == [(1, 1), (1, 2), (2, 3), (2, 4)], f"tune: reports (attempt, step) {got}")
    resumed = hist[2]
    check(resumed["restore_s"] is not None, "tune: the retry did not restore a checkpoint")
    check(resumed["gpu_ids"] == [0] and resumed["cuda_visible_devices"] == visible_card(0),
          f"tune: the trial actor holds card ids {resumed['gpu_ids']}, sees "
          f"{resumed['cuda_visible_devices']!r}")
    check(hist[0]["foreign_modules"] == [] and resumed["foreign_modules"] == [],
          "tune: a trial actor loaded the JAX package")
    for r in hist:
        check(r["launches"] == per_step, f"tune: function trial attempt {r['attempt']} step "
              f"{r['step']} launches {r['launches']}")
        check(r["adamw_launches"] == LM_LEAVES, f"tune: function trial attempt "
              f"{r['attempt']} step {r['step']}: {r['adamw_launches']} clip + AdamW launches")
    ADAMW_LAUNCHES["tune_function_trial"] = hist[0]["adamw_launches"]
    # The same steps unbroken, in this process.
    ctx = LMTrainContext(cfg)
    state = ctx.init_state(SEED)
    batch = train_batch(cfg)
    unbroken = []
    for step in range(1, TUNE_FN_STEPS + 1):
        state, m = counted_step(ctx, state, batch, tuple(per_step), f"unbroken step {step}")
        unbroken.append((float(m["loss"]), float(m["grad_norm"])))
    del state
    for r in hist:
        check((r["loss"], r["grad_norm"]) == unbroken[r["step"] - 1],
              f"tune: function trial attempt {r['attempt']} step {r['step']} "
              f"({r['loss']!r}, {r['grad_norm']!r}) is not the unbroken run's "
              f"{unbroken[r['step'] - 1]!r}")
    with open(os.path.join(storage, "failed_attempt.json")) as f:
        failed_at = json.load(f)["failed_at"]
    return {"fit_s": fit_s, "restore_s": resumed["restore_s"],
            "failure_to_resumed_report_s": resumed["reported_at"] - failed_at,
            "losses": [r["loss"] for r in hist], "grad_norms": [r["grad_norm"] for r in hist],
            "trial_gpu_ids": [hist[0]["gpu_ids"], resumed["gpu_ids"]],
            "launches_per_step": dict(zip(("fwd", "dq", "dkv"), resumed["launches"]))}


def prepare_model_on_card() -> dict:
    """Phase 12 (c): prepare_model places the model on the worker's card."""
    from ray_tpu_torch.air import ScalingConfig
    from ray_tpu_torch.train.torch import TorchTrainer

    t0 = time.time()
    result = bounded(TorchTrainer(prepare_model_loop,
                                  scaling_config=ScalingConfig(num_workers=1)).fit,
                     "tune: prepare_model's trainer")
    check(result.error is None, f"prepare_model: {result.error!r}")
    m = result.metrics
    check(m["devices"] == ["cuda:0"] and m["gpu_ids"] == [0],
          f"prepare_model: parameters on {m['devices']}, card ids {m['gpu_ids']}")
    check(m["losses"][-1] < m["losses"][0], f"prepare_model: loss {m['losses']}")
    return {"fit_s": time.time() - t0, "devices": m["devices"],
            "first_loss": m["losses"][0], "last_loss": m["losses"][-1]}


def phase_tune(card: str, training: dict) -> tuple:
    """Phase 12: tune over the trainer on the card, a function trial with
    a retry, and prepare_model on the card."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    storage = tempfile.mkdtemp(prefix=".tune-", dir=os.path.dirname(os.path.abspath(__file__)))
    try:
        ray_tpu_torch.init(num_cpus=4)
        try:
            trainer = tuner_over_trainer(training, os.path.join(storage, "a"))
            function = function_trial_with_retry(os.path.join(storage, "b"))
            prepared = prepare_model_on_card()
        finally:
            ray_tpu_torch.shutdown()
    finally:
        shutil.rmtree(storage, ignore_errors=True)
    out = {"card": card,
           "config": "(a) bench.py head (d2048 L16 H16/16 ff5504 V32000, bf16, remat qkv_attn, "
                     f"batch 16 x 1024), Tuner over TorchTrainer (1 worker, GPU 1), lr grid "
                     f"{list(TUNE_LRS)}, {TUNE_STEPS} steps, trials with CPU 1; (b) the same at "
                     f"{TUNE_FN_LAYERS} layers in a function trial with CPU 1 GPU 1, "
                     f"{TUNE_FN_STEPS} steps, a failure after step {TUNE_FN_FAIL_STEP}, "
                     "max_failures 1; (c) prepare_model of a Linear(4, 1) in one train worker",
           "tuner_over_trainer": trainer, "function_trial": function, "prepare_model": prepared,
           "seconds": time.perf_counter() - t_phase}
    print(f"tune: card {card}; Tuner over TorchTrainer fit {trainer['fit_s']:.2f} s, first "
          f"reports at {json.dumps(trainer['first_report_s'])} s, the second trial waited "
          f"{trainer['second_trial_card_wait_s']:.2f} s for the card (the first's last report "
          f"to the second's worker in its loop {trainer['handover_s']:.2f} s), lr {TUNE_LRS[0]} steps equal phase 5's bit for bit, "
          f"best lr {trainer['best_lr']}; function trial fit {function['fit_s']:.2f} s, failure to "
          f"resumed report {function['failure_to_resumed_report_s']:.2f} s (restore "
          f"{function['restore_s']:.3f} s), steps equal the unbroken run's; prepare_model on "
          f"{prepared['devices']}, loss {prepared['first_loss']:.4f} -> "
          f"{prepared['last_loss']:.4f}", flush=True)
    print(f"phase 12: {out['seconds']:.1f} s", flush=True)
    launches = {"trainer": tuple(trainer["launches_per_step"].values()),
                "function": tuple(function["launches_per_step"].values())}
    return out, launches


# -- phase 13: the cluster layer ---------------------------------------------------

# Every wait of the phase, a subprocess's run included.
CLUSTER_TIMEOUT = 300
CLUSTER_JOB_STEPS = 3
# The autoscaler's idle timeout: the node goes this long after its last
# lease is given back (the runtime keeps an idle lease 2 s).
CLUSTER_IDLE_S = 2.0
# What the looping job holds on the card, so that the card's free memory
# shows it come and go; and how far the free memory may stay below where it
# was once the job is stopped.
CLUSTER_LOOP_BYTES = 8 << 30
CLUSTER_FREE_SLACK = 1e9
# A worker on an in-process node (LocalNodeProvider's) seals a result of
# max_direct_call_object_size (100 KiB) or more in a store the driver can
# neither read nor pull from, and the driver's get raises ObjectLostError;
# the JAX package's runtime does the same. So (c)'s driver sends results of
# up to this many bytes inline, above the batch's 1 MiB of logits.
CLUSTER_INLINE_BYTES = 4 << 20
HERE = os.path.dirname(os.path.abspath(__file__))
# A subprocess of the phase: this script imported as a module (from HERE,
# on PYTHONPATH or as the job's working directory) and one of its
# functions run with the command line's arguments.
CHILD = "import sys\nimport chip_smoke\nsys.exit(chip_smoke.{entry}(*sys.argv[1:]))\n"


def child_script(workdir: str, entry: str) -> str:
    path = os.path.join(workdir, f"{entry}.py")
    with open(path, "w") as f:
        f.write(CHILD.format(entry=entry))
    return path


def child_env(**extra) -> dict:
    path = os.pathsep.join(p for p in (HERE, os.environ.get("PYTHONPATH")) if p)
    return {**os.environ, "PYTHONPATH": path, **extra}


def run_child(what: str, cmd: list, **extra) -> subprocess.CompletedProcess:
    out = subprocess.run(cmd, capture_output=True, text=True, cwd=HERE, env=child_env(**extra),
                         timeout=CLUSTER_TIMEOUT)
    check(out.returncode == 0, f"{what}: exit {out.returncode}\n{out.stdout[-2000:]}\n"
                               f"{out.stderr[-3000:]}")
    return out


def cli(what: str, *args, **extra) -> subprocess.CompletedProcess:
    return run_child(what, [sys.executable, "-m", "ray_tpu_torch.scripts.cli", *args], **extra)


def card_apps() -> list:
    """The processes nvidia-smi lists on the card, one line each (pid, used
    MiB). Their pids are the host's, which a container does not map to its
    own, so a process is seen on the card by the count going up and down."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


def running(pid: int) -> bool:
    """The process runs (a zombie nobody has reaped yet does not)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def wait_until(cond, what: str, timeout: float = 60.0) -> float:
    """Poll `cond` until it holds; the seconds that took."""
    t0 = time.perf_counter()
    while not cond():
        check(time.perf_counter() - t0 < timeout, f"{what}: not within {timeout} s")
        time.sleep(0.1)
    return time.perf_counter() - t0


def off_the_card(what: str, pids, apps_before: int) -> float:
    """Wait until none of `pids` runs and nvidia-smi lists no more processes
    on the card than the `apps_before` it listed before they started."""
    return wait_until(lambda: not any(running(p) for p in pids)
                      and len(card_apps()) <= apps_before,
                      f"{what}: processes {sorted(pids)} still on the card ({card_apps()})")


def cluster_job_train(steps: str) -> int:
    """Phase 13 (a)'s entrypoint, a submitted job's driver: phase 5's first
    steps (bench.py's head configuration, init_state(SEED), train_batch)
    through LMTrainContext in this process, with the kernels phase 1
    built; prints one JSON line of its losses, grad norms, B1-B3 launches a
    step and when each step ended."""
    entered = time.time()
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: the job finds no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = bench_config()
    ctx = LMTrainContext(cfg)
    state = ctx.init_state(SEED)
    batch = train_batch(cfg)
    losses, grad_norms, launches, adamw_counts, done_at = [], [], [], [], []
    for _ in range(int(steps)):
        since = _build.launch_counts()
        state, m = ctx.train_step(state, batch)
        losses.append(float(m["loss"]))  # waits for the step
        grad_norms.append(float(m["grad_norm"]))
        done_at.append(time.time())
        launches.append(list(launch_counts(since)))
        adamw_counts.append(adamw_launches(since))
    print(json.dumps({"cluster_job": {
        "device": torch.cuda.get_device_name(0), "pid": os.getpid(), "entered_at": entered,
        "losses": losses, "grad_norms": grad_norms, "launches": launches,
        "adamw_launches": adamw_counts,
        "step_done_at": done_at, "build_s": kernel_builds(),
        "foreign_modules": foreign_modules()}}), flush=True)
    return 0


def cluster_job_loop(nbytes: str) -> int:
    """Phase 13 (a)'s second job: holds `nbytes` of the card and multiplies
    on it until it is stopped."""
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: the job finds no CUDA device")
    hold = torch.empty(int(nbytes), dtype=torch.uint8, device="cuda")
    x = torch.randn(2048, 2048, device="cuda")
    torch.cuda.synchronize()
    print(json.dumps({"on_card": os.getpid(), "holds": hold.numel()}), flush=True)
    while True:
        x = torch.tanh(x @ x)
        torch.cuda.synchronize()


def cluster_batch() -> dict:
    """Phase 13's num_gpus=1 task: phase 3's first batch (llama_1b with
    phase 3's weights, its first MAX_BATCH prompts) in one forward in this
    worker; the last-position logits, B1-B3 launches, card ids."""
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: the task finds no CUDA device")
    cfg = TransformerConfig.llama_1b()
    params = llama_1b_params(cfg)
    toks = torch.tensor(serving_prompts(cfg)[:MAX_BATCH], dtype=torch.long, device="cuda")
    since = _build.launch_counts()
    with torch.no_grad():
        last = forward(params, toks, cfg)[:, -1, :]
    launches = launch_counts(since)
    return {"logits": last.cpu().numpy(), "launches": launches, "done_at": time.time(),
            "device": torch.cuda.get_device_name(0), "pid": os.getpid(),
            "gpu_ids": ray_tpu_torch.get_gpu_ids(),
            "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "build_s": kernel_builds(), "foreign_modules": foreign_modules()}


def cluster_attached_driver(address: str, out: str) -> int:
    """Phase 13 (b)'s driver: attaches to the head at `address` (its
    head.json), runs cluster_batch there as a num_gpus=1 task, detaches and
    writes what the task returned to `out`."""
    t0 = time.perf_counter()
    ray_tpu_torch.init(address=address)
    try:
        attach_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = ray_tpu_torch.get(ray_tpu_torch.remote(num_gpus=1)(cluster_batch).remote(),
                                timeout=CLUSTER_TIMEOUT)
        res.update(attach_s=attach_s, task_s=time.perf_counter() - t0)
    finally:
        ray_tpu_torch.shutdown()
    with open(out, "wb") as f:
        pickle.dump(res, f)
    return 0


def cluster_autoscaled_driver(out: str) -> int:
    """Phase 13 (c)'s driver, started with RAY_TPU_CHIPS=0: its runtime's
    head holds no "GPU", so a num_gpus=1 task waits until the autoscaler
    adds the one {"CPU": 2, "GPU": 1} node it may; the task runs there; the
    idle node is then terminated. Writes the task's result and the times."""
    from ray_tpu_torch._private.runtime import get_runtime
    from ray_tpu_torch.autoscaler import (
        AutoscalerConfig, LocalNodeProvider, NodeTypeConfig, StandardAutoscaler)

    ray_tpu_torch.init(num_cpus=2)
    try:
        head = ray_tpu_torch.cluster_resources()
        check("GPU" not in head, f"autoscaler: the head holds {head}")
        provider = LocalNodeProvider()
        scaler = StandardAutoscaler(provider, AutoscalerConfig(
            node_types={"gpu": NodeTypeConfig(resources={"CPU": 2.0, "GPU": 1.0},
                                              max_workers=1)},
            idle_timeout_s=CLUSTER_IDLE_S))
        apps_before = len(card_apps())
        t_demand = time.perf_counter()
        ref = ray_tpu_torch.remote(num_gpus=1)(cluster_batch).remote()
        launched = {}
        deadline = t_demand + CLUSTER_TIMEOUT
        while not launched and time.perf_counter() < deadline:
            launched = scaler.update()["launched"]
            time.sleep(0.05)
        t_node = time.perf_counter()
        check(launched == {"gpu": 1}, f"autoscaler: launched {launched}")
        (node,) = provider.non_terminated_nodes()
        node_resources = dict(get_runtime().state.nodes[provider.runtime_node_id(node)].resources)
        res = ray_tpu_torch.get(ref, timeout=CLUSTER_TIMEOUT)
        t_result = time.perf_counter()
        passes = []
        while provider.non_terminated_nodes() and time.perf_counter() < t_result + 120:
            time.sleep(0.2)
            passes.append(scaler.update())
        t_terminated = time.perf_counter()
        check(provider.non_terminated_nodes() == [], "autoscaler: the idle node was not terminated")
        check(not any(p["launched"] for p in passes), f"autoscaler: launched again: {passes}")
        worker_gone_s = off_the_card("autoscaler: the node's worker", [res["pid"]], apps_before)
        after = ray_tpu_torch.cluster_resources()
    finally:
        ray_tpu_torch.shutdown()
    res.update(head_resources=head, node_resources=node_resources,
               demand_to_node_s=t_node - t_demand, node_to_result_s=t_result - t_node,
               result_to_terminated_s=t_terminated - t_result, worker_gone_s=worker_gone_s,
               resources_after=after)
    with open(out, "wb") as f:
        pickle.dump(res, f)
    return 0


def check_batch(what: str, res: dict, phase3_batch: np.ndarray) -> None:
    """A num_gpus=1 task's batch: phase 3's logits bit for bit, B1 once a
    layer and B2, B3 never, card id 0, nothing of the JAX package, and the
    kernels loaded as phase 1 built them."""
    n_layers = TransformerConfig.llama_1b().n_layers
    check(res["device"] == torch.cuda.get_device_name(0), f"{what}: the task ran on {res['device']}")
    check(tuple(res["launches"]) == (n_layers, 0, 0), f"{what}: launches {res['launches']}")
    check(np.array_equal(res["logits"], phase3_batch),
          f"{what}: logits differ from phase 3's batch (max |diff| "
          f"{np.abs(res['logits'] - phase3_batch).max():.3e})")
    check(res["gpu_ids"] == [0] and res["cuda_visible_devices"] == visible_card(0),
          f"{what}: card ids {res['gpu_ids']}, CUDA_VISIBLE_DEVICES {res['cuda_visible_devices']!r}")
    check(res["foreign_modules"] == [], f"{what}: the worker loaded {res['foreign_modules']}")
    check(set(res["build_s"].values()) <= {0.0}, f"{what}: the worker built {res['build_s']}")


def cluster_jobs(training: dict, workdir: str) -> tuple:
    """(a): a job training phase 5's first steps, and a looping job stopped."""
    from ray_tpu_torch.job_submission import STOPPED, SUCCEEDED, JobSubmissionClient

    client = JobSubmissionClient(log_dir=os.path.join(workdir, "logs"))
    renv = {"working_dir": HERE}
    train_py, loop_py = (child_script(workdir, e) for e in ("cluster_job_train", "cluster_job_loop"))
    job = client.submit_job(entrypoint=f"{sys.executable} {train_py} {CLUSTER_JOB_STEPS}",
                            runtime_env=renv)
    status = client.wait_until_finish(job, timeout=CLUSTER_TIMEOUT)
    info, logs = client.get_job_info(job), client.get_job_logs(job)
    check(status == SUCCEEDED, f"job: {status}, its log:\n{logs[-3000:]}")
    rec = [json.loads(ln) for ln in logs.splitlines() if ln.startswith('{"cluster_job"')]
    check(len(rec) == 1, f"job: {len(rec)} result lines in its log:\n{logs[-3000:]}")
    rec = rec[0]["cluster_job"]
    n = CLUSTER_JOB_STEPS
    check(rec["losses"] == training["losses"][:n] and rec["grad_norms"] == training["grad_norms"][:n],
          f"job: losses {rec['losses']} grad norms {rec['grad_norms']}, phase 5 "
          f"{training['losses'][:n]} {training['grad_norms'][:n]}")
    per_step = [bench_config().n_layers] * 3
    check(rec["launches"] == [per_step] * n, f"job: launches {rec['launches']}")
    check(rec["adamw_launches"] == [LM_LEAVES] * n,
          f"job: clip + AdamW launches {rec['adamw_launches']}")
    ADAMW_LAUNCHES["cluster_job_step"] = rec["adamw_launches"][0]
    check(rec["device"] == torch.cuda.get_device_name(0), f"job: ran on {rec['device']}")
    check(rec["foreign_modules"] == [], f"job: loaded {rec['foreign_modules']}")
    check(set(rec["build_s"].values()) <= {0.0}, f"job: built the kernels again: {rec['build_s']}")
    submitted = info.submission_time
    job_out = {"submit_to_running_s": info.start_time - submitted,
               "submit_to_entry_s": rec["entered_at"] - submitted,
               "submit_to_first_step_s": rec["step_done_at"][0] - submitted,
               "later_step_s": np.diff(rec["step_done_at"]).tolist(),
               "submit_to_succeeded_s": info.end_time - submitted,
               "losses": rec["losses"], "grad_norms": rec["grad_norms"],
               "launches_per_step": dict(zip(("fwd", "dq", "dkv"), rec["launches"][0]))}

    torch.cuda.empty_cache()
    free_before, apps_before = torch.cuda.mem_get_info()[0], card_apps()
    loop = client.submit_job(entrypoint=f"{sys.executable} {loop_py} {CLUSTER_LOOP_BYTES}",
                             runtime_env=renv)
    t0 = time.perf_counter()
    try:
        wait_until(lambda: '"on_card"' in client.get_job_logs(loop)
                   or client.get_job_status(loop) != "RUNNING", "looping job", CLUSTER_TIMEOUT)
        on_card_s = time.perf_counter() - t0
        lines = [ln for ln in client.get_job_logs(loop).splitlines() if ln.startswith('{"on_card"')]
        check(len(lines) == 1, f"looping job: {client.get_job_status(loop)}, its log:\n"
                               f"{client.get_job_logs(loop)[-3000:]}")
        pid = json.loads(lines[0])["on_card"]
        free_holding, apps_holding = torch.cuda.mem_get_info()[0], card_apps()
    finally:
        t0 = time.perf_counter()
        stopped = client.stop_job(loop)
    status = client.wait_until_finish(loop, timeout=60)
    stop_s = time.perf_counter() - t0
    check(stopped and status == STOPPED, f"looping job: stop_job {stopped}, {status}")
    check(free_holding < free_before - 0.9 * CLUSTER_LOOP_BYTES,
          f"looping job: the card's free memory {free_holding / 1e9:.2f} GB while it ran, "
          f"{free_before / 1e9:.2f} GB before")
    check(len(apps_holding) == len(apps_before) + 1,
          f"looping job: nvidia-smi lists {apps_holding} on the card, before it {apps_before}")
    gone_s = off_the_card("looping job", [pid], len(apps_before))
    free_after = torch.cuda.mem_get_info()[0]
    check(free_after > free_before - CLUSTER_FREE_SLACK,
          f"looping job: {free_after / 1e9:.2f} GB free after its stop, {free_before / 1e9:.2f} before")
    job_out["stopped_job"] = {"submit_to_on_card_s": on_card_s, "stop_s": stop_s,
                              "off_the_card_s": gone_s, "free_gb": [
                                  free_before / 1e9, free_holding / 1e9, free_after / 1e9]}
    return job_out, tuple(rec["launches"][0])


def cluster_head(workdir: str, phase3_batch: np.ndarray) -> dict:
    """(b): a head started by the CLI, a driver attached to it running the
    batch on the card, `status` and `stop`."""
    session = os.path.join(workdir, "session")
    apps_before = len(card_apps())
    t0 = time.perf_counter()
    cli("cli start", "start", "--head", "--num-cpus", "4", "--session-dir", session)
    start_s = time.perf_counter() - t0
    head_json = os.path.join(session, "head.json")
    with open(os.path.join(session, "head.pid")) as f:
        head_pid = int(f.read())
    try:
        result = os.path.join(workdir, "attached.pkl")
        t0 = time.perf_counter()
        run_child("attached driver", [sys.executable, child_script(workdir, "cluster_attached_driver"),
                                      head_json, result])
        driver_s = time.perf_counter() - t0
        with open(result, "rb") as f:
            res = pickle.load(f)
        check_batch("attached driver", res, phase3_batch)
        status = json.loads(cli("cli status", "status", "--address", head_json).stdout)
        check(status["resources"].get("GPU") == 1.0, f"cli status: {status['resources']}")
        t0 = time.perf_counter()
        stop = cli("cli stop", "stop", "--session-dir", session)
        check(f"pid {head_pid}" in stop.stdout, f"cli stop: {stop.stdout}")
        gone_s = off_the_card("cli stop", [head_pid, res["pid"]], apps_before)
        stop_s = time.perf_counter() - t0
    finally:
        if running(head_pid):  # a check failed before `cli stop`
            os.kill(head_pid, signal.SIGTERM)
            time.sleep(5)
            if running(head_pid):
                os.kill(head_pid, signal.SIGKILL)
    return {"start_s": start_s, "attach_s": res["attach_s"], "first_gpu_task_s": res["task_s"],
            "driver_process_s": driver_s, "status_resources": status["resources"],
            "stop_to_off_the_card_s": stop_s, "off_the_card_s": gone_s,
            "launches": list(res["launches"]), "gpu_ids": res["gpu_ids"]}


def cluster_autoscaled(workdir: str, phase3_batch: np.ndarray) -> dict:
    """(c): the autoscaler adds the one "GPU" node, which runs the batch."""
    result = os.path.join(workdir, "autoscaled.pkl")
    t0 = time.perf_counter()
    run_child("autoscaled driver", [sys.executable, child_script(workdir, "cluster_autoscaled_driver"),
                                    result], RAY_TPU_CHIPS="0",
              RAY_TPU_MAX_DIRECT_CALL_OBJECT_SIZE=str(CLUSTER_INLINE_BYTES))
    driver_s = time.perf_counter() - t0
    with open(result, "rb") as f:
        res = pickle.load(f)
    check_batch("autoscaled node", res, phase3_batch)
    check(res["node_resources"] == {"CPU": 2.0, "GPU": 1.0}, f"autoscaler: node {res['node_resources']}")
    check("GPU" not in res["resources_after"], f"autoscaler: after {res['resources_after']}")
    return {k: res[k] for k in ("head_resources", "node_resources", "demand_to_node_s",
                                "node_to_result_s", "result_to_terminated_s", "worker_gone_s",
                                "launches", "gpu_ids")} | {"driver_process_s": driver_s}


RAY_PERF_BENCHES = ("single_client_tasks_sync", "single_client_tasks_async",
                    "multi_client_tasks_async", "1_1_actor_calls_sync", "1_1_actor_calls_async",
                    "n_n_actor_calls_async", "single_client_put_ops",
                    "single_client_put_gigabytes")


def cluster_microbenchmark(workdir: str) -> dict:
    """(d): `microbenchmark --json`, the port's ray_perf, all eight benches."""
    path = os.path.join(workdir, "perf.json")
    t0 = time.perf_counter()
    cli("cli microbenchmark", "microbenchmark", "--json", path)
    seconds = time.perf_counter() - t0
    with open(path) as f:
        rows = json.load(f)
    check([r["name"] for r in rows[1:]] == list(RAY_PERF_BENCHES),
          f"ray_perf: benches {[r['name'] for r in rows]}")
    medians = {r["name"]: r.get("ops_per_s", r.get("gb_per_s")) for r in rows[1:]}
    check(all(v > 0 for v in medians.values()), f"ray_perf: {medians}")
    return {"seconds": seconds, "host": {k: v for k, v in rows[0].items() if k != "note"},
            "median": medians, "runs": {r["name"]: r["runs"] for r in rows[1:]}}


def phase_cluster(card: str, training: dict, phase3_batch: np.ndarray) -> tuple:
    """Phase 13: the cluster layer on the card: (a) jobs, (b) a head
    started by the CLI with an attached driver, (c) the autoscaler, (d) the
    microbenchmarks."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    jobs_dir = tempfile.mkdtemp(prefix=".jobs-", dir=HERE)
    cluster_dir = tempfile.mkdtemp(prefix=".cluster-", dir=HERE)
    try:
        jobs, job_launches = cluster_jobs(training, jobs_dir)
        head = cluster_head(cluster_dir, phase3_batch)
        autoscaled = cluster_autoscaled(cluster_dir, phase3_batch)
        perf = cluster_microbenchmark(cluster_dir)
    finally:
        shutil.rmtree(jobs_dir, ignore_errors=True)
        shutil.rmtree(cluster_dir, ignore_errors=True)
    out = {"card": card,
           "config": f"(a) a job training bench.py's head configuration {CLUSTER_JOB_STEPS} steps "
                     "from phase 5's seed and batch, and a job looping on the card, stopped; (b) "
                     "`cli start --head`, a driver attached by head.json running phase 3's first "
                     "batch (llama_1b, 8 x 1024) as a num_gpus=1 task, `cli status`, `cli stop`; "
                     "(c) a driver whose head holds no GPU (RAY_TPU_CHIPS=0), StandardAutoscaler "
                     "over LocalNodeProvider (one node type CPU 2 GPU 1, max 1, idle timeout "
                     f"{CLUSTER_IDLE_S} s), the same batch; (d) `cli microbenchmark --json`",
           "job": jobs, "head": head, "autoscaler": autoscaled, "ray_perf": perf,
           "seconds": time.perf_counter() - t_phase}
    print(f"cluster: card {card}; job submit to RUNNING {jobs['submit_to_running_s']:.4f} s, to "
          f"its first step {jobs['submit_to_first_step_s']:.2f} s, to SUCCEEDED "
          f"{jobs['submit_to_succeeded_s']:.2f} s, losses equal phase 5's bit for bit, launches "
          f"{list(job_launches)} a step; the looping job on the card in "
          f"{jobs['stopped_job']['submit_to_on_card_s']:.2f} s, STOPPED and off the card "
          f"{jobs['stopped_job']['off_the_card_s']:.2f} s after; head started in "
          f"{head['start_s']:.2f} s, attached driver's first GPU task {head['first_gpu_task_s']:.2f} s, "
          f"status GPU {head['status_resources'].get('GPU')}, stop to off the card "
          f"{head['stop_to_off_the_card_s']:.2f} s; autoscaler demand to node "
          f"{autoscaled['demand_to_node_s']:.3f} s, node to result "
          f"{autoscaled['node_to_result_s']:.2f} s, terminated "
          f"{autoscaled['result_to_terminated_s']:.2f} s after; both batches equal phase 3's bit "
          f"for bit, card ids [0]", flush=True)
    print("ray_perf: " + ", ".join(f"{k} {v}" for k, v in perf["median"].items())
          + " (median ops/s; GB/s for the put bench)", flush=True)
    print(f"phase 13: {out['seconds']:.1f} s", flush=True)
    launches = {"cluster_job_step": job_launches,
                "cluster_attached_batch": tuple(head["launches"]),
                "cluster_autoscaled_batch": tuple(autoscaled["launches"])}
    return out, launches


# Phase 14: the repo's drivers, each run as a user runs it, within this
# many seconds.
DRIVER_TIMEOUT = 600
# bench.py's line, and so bench_torch.py's: its keys, and each sweep
# point's.
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "mfu", "n_params", "device",
              "seq_sweep"}
BENCH_POINT_KEYS = {"tokens_per_s", "mfu", "mfu_attn_incl"}


def run_driver(script: str) -> subprocess.CompletedProcess:
    """`python <script>` from this script's directory; fails unless it exits 0."""
    out = subprocess.run([sys.executable, script], capture_output=True, text=True, cwd=HERE,
                         env=child_env(), timeout=DRIVER_TIMEOUT)
    check(out.returncode == 0, f"{script}: exit {out.returncode}\n{out.stdout[-2000:]}\n"
                               f"{out.stderr[-3000:]}")
    return out


def expected_launches(cfg: TransformerConfig) -> tuple:
    """B1, B2 and B3 launches of one step: each once a layer, and B1 twice
    where remat recomputes the whole layer (remat_policy None)."""
    recompute = cfg.remat and cfg.remat_policy is None
    return (cfg.n_layers * (2 if recompute else 1), cfg.n_layers, cfg.n_layers)


def bench_sweep_line() -> dict:
    """(a) `python bench_torch.py`: its one line, with the source's keys, a
    finite head, and every sweep point run with finite numbers, 0 < mfu < 1."""
    t0 = time.perf_counter()
    proc = run_driver("bench_torch.py")
    seconds = time.perf_counter() - t0
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"bench_torch.py ({seconds:.1f} s): {json.dumps(line)}", flush=True)
    check(set(line) == BENCH_KEYS, f"bench_torch.py's keys {sorted(line)}")
    check(line["device"] == torch.cuda.get_device_name(0), f"bench device {line['device']}")
    check(np.isfinite(line["value"]) and 0 < line["mfu"] < 1, f"bench head: {line}")
    check(set(line["seq_sweep"]) == {str(seq) for _, seq in bench_torch.SWEEP},
          f"bench sweep points {sorted(line['seq_sweep'])}")
    for seq, point in line["seq_sweep"].items():
        check(set(point) == BENCH_POINT_KEYS, f"bench sweep point {seq}: {point}")
        check(all(np.isfinite(point[k]) for k in BENCH_POINT_KEYS) and 0 < point["mfu"] < 1,
              f"bench sweep point {seq}: {point}")
    return {"seconds": seconds, "line": line}


def driver_step(what: str, cfg: TransformerConfig, batch: dict, path: str) -> tuple:
    """One step of `cfg` on `batch` from a fresh state (seed SEED) with exact
    launches and its peak memory above what the process held before the
    state was made (`held_before_gb`); its loss against the same state's forward
    with the plain reference attention under no_grad, within TRAIN_LOSS_TOL.
    The reference runs first, since the step updates the state in place. It
    keeps one layer's scores at a time: at [1, 16384] with 16 heads, bf16
    scores of 8.6 GB, their f32 copy and its softmax of 17.2 GB each, ~43 GB
    beside the 5.6 GB state, within the card's 80 GB."""
    expect = expected_launches(cfg)
    held = torch.cuda.memory_allocated()
    ctx = LMTrainContext(cfg, strategy="dp")
    state = ctx.init_state(SEED)
    ref_ctx = LMTrainContext(dataclasses.replace(cfg, attention_impl="reference"),
                             strategy="dp")
    torch.cuda.reset_peak_memory_stats()
    logits = ref_ctx.apply(state["params"], batch["tokens"])
    ref_loss = float(cross_entropy_loss(logits, batch["targets"]))
    ref_peak_gb = (torch.cuda.max_memory_allocated() - held) / 1e9
    del logits
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = counted_step(ctx, state, batch, expect, what, path)
    loss, grad_norm = float(m["loss"]), float(m["grad_norm"])
    step_s = time.perf_counter() - t0
    peak_gb = (torch.cuda.max_memory_allocated() - held) / 1e9
    del state, m
    torch.cuda.empty_cache()
    diff = abs(loss - ref_loss)
    out = {"batch": list(batch["tokens"].shape), "remat_policy": cfg.remat_policy,
           "launches": dict(zip(("fwd", "dq", "dkv"), expect)), "loss": loss,
           "grad_norm": grad_norm, "reference_loss": ref_loss, "loss_diff": diff,
           "first_step_s": step_s, "peak_mem_gb": peak_gb, "reference_peak_mem_gb": ref_peak_gb,
           "held_before_gb": held / 1e9}
    print(f"{what}: {json.dumps(out)}", flush=True)
    check(np.isfinite(loss) and np.isfinite(grad_norm), f"{what}: non-finite loss or grad norm")
    check(diff <= TRAIN_LOSS_TOL, f"{what}: loss {loss} vs reference attention {ref_loss} "
                                  f"(tol {TRAIN_LOSS_TOL})")
    return out, expect


def long_context_kernel_times(g) -> dict:
    """B1, B2 and B3 (and the delta pre-pass) at the sweep's longest shape,
    [1, 16384, 16, 128] causal bf16: CUDA events around eager calls and
    CUDA-graph replays, beside their bounds and the library's forward and
    backward (scaled_dot_product_attention, never called by the port)."""
    q, k, v = rand_qkv(g, 1, 16384, 16, 16, 128, torch.bfloat16)
    do = torch.randn(q.shape, generator=g, device="cuda").to(torch.bfloat16)
    kernel = lambda: flash.flash_attention_fwd(q, k, v, causal=True)  # noqa: E731
    o, lse = kernel()
    bwd = backward_times(q, k, v, o, lse, do)
    delta = lambda: flash._delta(do, o)  # noqa: E731
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    qt, kt, vt = (x.detach().requires_grad_(True) for x in (qt, kt, vt))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_fwd_ms = time_ms(lambda: sdpa(qt.detach(), kt.detach(), vt.detach(), is_causal=True),
                         iters=10)
    lib_fwd_bwd_ms = time_ms(
        lambda: torch.autograd.grad(sdpa(qt, kt, vt, is_causal=True), (qt, kt, vt), dot),
        iters=10)
    fwd_bound, bwd_bound = attention_bound(q, k, causal=True), backward_bounds(q, k, True)
    times = {
        "flash_attn_fwd": dict(ms=time_ms(kernel, iters=10), graph_ms=graph_ms(kernel, calls=5),
                               bound_ms=fwd_bound[0], bound_by=fwd_bound[1],
                               library_ms=lib_fwd_ms),
        "flash_attn_bwd_dq": dict(**bwd["flash_attn_bwd_dq"], bound_ms=bwd_bound["dq"][0],
                                  bound_by=bwd_bound["dq"][1],
                                  delta_prepass=dict(ms=time_ms(delta, iters=10))),
        "flash_attn_bwd_dkv": dict(**bwd["flash_attn_bwd_dkv"], bound_ms=bwd_bound["dkv"][0],
                                   bound_by=bwd_bound["dkv"][1]),
        "library_bwd_pair_ms": lib_fwd_bwd_ms - lib_fwd_ms,
    }
    print(f"kernel timing at [1, 16384, 16, 128]: {json.dumps(times)}", flush=True)
    return times


PROFILE_LINES = ("device:", "card:", "matmul ", "flash fwd:", "flash fwd+bwd(grad):",
                 "blockwise fwd+bwd(grad):", "plain fwd+bwd(grad):", "sdpa fwd:",
                 "sdpa fwd+bwd(grad):", "full step:")


def phase_drivers(card: str, g) -> tuple:
    """Phase 14: (a) bench_torch.py as a user runs it; (b) each sweep point's
    configuration and batch, one counted step in process; the kernels at
    the longest point; (c) scripts/profile_step_gpu.py as a user runs it,
    then one counted step of its full-step configuration in process."""
    t_phase = time.perf_counter()
    bench = bench_sweep_line()
    points, launches = {}, {}
    for bs, seq in bench_torch.SWEEP:
        cfg = bench_torch.make_cfg(seq)
        batch = bench_torch.token_batch(cfg.vocab_size, bs, seq, "cuda")
        points[str(seq)], launches[f"bench_sweep_{seq}"] = driver_step(
            f"bench sweep {bs} x {seq}", cfg, batch, f"bench_sweep_{seq}")
        del batch
    kernel_times = long_context_kernel_times(g)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    proc = run_driver(os.path.join("scripts", "profile_step_gpu.py"))
    profile_s = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    for line in lines:
        print(f"profile_step_gpu: {line}", flush=True)
    check([next((p for p in PROFILE_LINES if line.startswith(p)), None) for line in lines]
          == list(PROFILE_LINES), f"profile_step_gpu.py printed {lines}")
    full_step, launches["profile_step"] = driver_step(
        "profile_step full step", profile_step_gpu.full_step_config(),
        profile_step_gpu.full_step_batch(), "profile_step")
    out = {"card": card,
           "bench_torch": bench, "sweep_steps": points, "kernels_at_16384": kernel_times,
           "profile_step_gpu": {"seconds": profile_s, "lines": lines, "full_step": full_step},
           "seconds": time.perf_counter() - t_phase}
    print(f"phase 14: {out['seconds']:.1f} s", flush=True)
    return out, launches


LIBRARIES = {"flash_attn_fwd": flash.SOURCE, "flash_attn_bwd": flash.BWD_SOURCE,
             "adamw": adamw.SOURCE}
# A1's instantiations, which must spill nothing either.
ADAMW_LABELS = ("adamw_kernel<float>", "adamw_kernel<__nv_bfloat16>")
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
            arg = re.match(r"I(?:Li(\d+)|(f)|13(__nv_bfloat16))E", symbol[m.end() + n:])
            if name.endswith("_kernel") and arg:
                value = arg.group(1) or arg.group(3) or "float"
                return f"{name}<{value}>"
    return symbol


def kernel_builds() -> dict:
    """Seconds of nvcc for each library this process loaded (0.0 where it
    found the library built)."""
    return {name: rec["compile_s"] for name, rec in _build.loads.items()}


def ptxas_report() -> dict:
    """Registers, static shared memory and spills of every kernel, from the
    `-Xptxas -v` output of the builds."""
    report = {}
    for name in LIBRARIES:
        label = None
        with open(_build.loads[name]["log"]) as f:
            log = f.read()
        for line in log.splitlines():
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
        out = subprocess.run([tool, "-sass", _build.loads[name]["path"]],
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
    builds = kernel_builds()
    print(f"build: {', '.join(LIBRARIES)} in {time.perf_counter() - t0:.1f} s ("
          + ", ".join(f"nvcc {n} {builds[n]:.1f} s" for n in LIBRARIES) + ")", flush=True)
    ptxas, sass = ptxas_report(), sass_report()
    for label in sorted(ptxas):
        print(f"ptxas: {label}: {json.dumps(ptxas[label])}"
              + (f" sass: {json.dumps(sass[label])}" if label in sass else ""), flush=True)
    for label in ADAMW_LABELS:
        check(ptxas[label].get("spill_stores") == 0 and ptxas[label].get("spill_loads") == 0,
              f"{label} spills: {ptxas[label]}")
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
    t_start = time.perf_counter()
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
    seconds, lap_at = {}, [t_start]

    def lap(phase: str) -> None:
        """The seconds since the last lap, as the phase's."""
        now = time.perf_counter()
        seconds[phase], lap_at[0] = now - lap_at[0], now

    compiled = build_kernels()
    lap("1")
    g = torch.Generator(device="cuda").manual_seed(SEED)
    timing = phase_kernels(g)
    torch.cuda.empty_cache()
    adamw_timing = phase_adamw()
    print(json.dumps({"adamw_times": adamw_timing}), flush=True)
    lap("2")

    serving, serve_launches, phase3_batch = phase_serving(card)
    print(json.dumps({"serving": serving}), flush=True)
    torch.cuda.empty_cache()
    lap("3")

    train_timing = phase_backward(g)
    lap("4")
    training, train_launches = phase_training(card)
    print(json.dumps({"training": training}), flush=True)
    torch.cuda.empty_cache()
    lap("5")

    try:
        parallel, ring_launches, sharded_launches = phase_parallel(card)
        print(json.dumps({"parallel": parallel}), flush=True)
        torch.cuda.empty_cache()
        lap("6")
        pipeline, pp_launches = phase_pipeline_experts(card)
        print(json.dumps({"pipeline": pipeline}), flush=True)
        torch.cuda.empty_cache()
        lap("7")
        rllib, checkpoint, ckpt_launches = phase_rl_checkpoint(card)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print(json.dumps({"rllib": rllib}), flush=True)
    print(json.dumps({"checkpoint": checkpoint}), flush=True)
    torch.cuda.empty_cache()
    lap("8")

    trainer, trainer_launches = phase_runtime_trainer(card, training)
    print(json.dumps({"trainer": trainer}), flush=True)
    torch.cuda.empty_cache()
    lap("9")

    serve_stack, stack_launches = phase_serve_stack(card, serving)
    print(json.dumps({"serve_stack": serve_stack}), flush=True)
    torch.cuda.empty_cache()
    lap("10")

    rl_algorithms, rl_launches = phase_rl_algorithms(card, rllib["ppo"])
    print(json.dumps({"rl_algorithms": rl_algorithms}), flush=True)
    torch.cuda.empty_cache()
    lap("11")

    tune, tune_launches = phase_tune(card, training)
    print(json.dumps({"tune": tune}), flush=True)
    torch.cuda.empty_cache()
    lap("12")

    cluster, cluster_launches = phase_cluster(card, training, phase3_batch)
    print(json.dumps({"cluster": cluster}), flush=True)
    torch.cuda.empty_cache()
    lap("13")

    drivers, driver_launches = phase_drivers(card, g)
    print(json.dumps({"drivers": drivers}), flush=True)
    lap("14")

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
                              **{k: v[0] for k, v in stack_launches.items()},
                              "rl_algorithms": rl_launches[0],
                              "tune_trainer_trial": tune_launches["trainer"][0],
                              "tune_function_trial": tune_launches["function"][0],
                              **{k: v[0] for k, v in cluster_launches.items()},
                              **{k: v[0] for k, v in driver_launches.items()}},
         **timing, "at_training_shape": train_timing["flash_attn_fwd"],
         "at_seq_16384": drivers["kernels_at_16384"]["flash_attn_fwd"]},
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
                              **{k: v[1] for k, v in stack_launches.items()},
                              "rl_algorithms": rl_launches[1],
                              "tune_trainer_trial": tune_launches["trainer"][1],
                              "tune_function_trial": tune_launches["function"][1],
                              **{k: v[1] for k, v in cluster_launches.items()},
                              **{k: v[1] for k, v in driver_launches.items()}},
         **train_timing["flash_attn_bwd_dq"],
         "at_seq_16384": drivers["kernels_at_16384"]["flash_attn_bwd_dq"]},
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
                              **{k: v[2] for k, v in stack_launches.items()},
                              "rl_algorithms": rl_launches[2],
                              "tune_trainer_trial": tune_launches["trainer"][2],
                              "tune_function_trial": tune_launches["function"][2],
                              **{k: v[2] for k, v in cluster_launches.items()},
                              **{k: v[2] for k, v in driver_launches.items()}},
         **train_timing["flash_attn_bwd_dkv"],
         "at_seq_16384": drivers["kernels_at_16384"]["flash_attn_bwd_dkv"]},
    ]
    for entry in kernels:
        symbol = KERNEL_MARKERS[entry["name"]]
        entry["compiled"] = {f"{symbol}<{d}>": {**compiled["ptxas"].get(f"{symbol}<{d}>", {}),
                                                **compiled["sass"].get(f"{symbol}<{d}>", {})}
                             for d in flash.HEAD_DIMS}
    kernels.append(
        {"name": "adamw", "route": "cuda", "source": source + adamw.SOURCE,
         "replaces": "none: the JAX package leaves clip + AdamW to XLA's fusion of optax's chain",
         "design": "adamw_kernel: clip and AdamW in one pass a leaf after the global norm, "
                   "read from the device; f32 registers in optax's order, 16-byte loads and "
                   "stores (float4, 8 bf16), a grid-stride loop over 4 blocks of 256 an SM, "
                   "one element at a time for a tail or an unaligned pointer",
         "launches": ADAMW_LAUNCHES["train_step"], "launches_by_path": dict(ADAMW_LAUNCHES),
         **adamw_timing,
         "compiled": {label: compiled["ptxas"][label] for label in ADAMW_LABELS}})
    print(f"card: {card}")
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s; by phase "
          + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    modes = {"--forward-times": main_forward_times, "--backward-times": main_backward_times,
             "--adamw-times": main_adamw_times}
    sys.exit(modes.get(" ".join(sys.argv[1:]), main)())
