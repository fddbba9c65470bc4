"""The port's CUDA kernels against their plain versions on the card.

These tests import torch and nothing of jax (the machine with the card has
no jax), and skip themselves where there is no CUDA card. On the card:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels.py

(`--noconftest`: tests/conftest.py imports jax for the JAX package's tests.)
"""

import dataclasses

import pytest
import torch

from ray_tpu_torch.models import LMTrainContext, TransformerConfig, cross_entropy_loss, forward
from ray_tpu_torch.models import transformer
from ray_tpu_torch.ops.cuda import _build
from ray_tpu_torch.ops.cuda import flash_attention as flash
from ray_tpu_torch.ops.ring_attention import ring_schedule
from ray_tpu_torch.parallel import pipeline_apply, pipeline_train_step_1f1b
from ray_tpu_torch.parallel.sharding import tree_leaves

# Backward kernels against the plain backward in f32 from the same inputs,
# as a share of the largest |gradient|: bf16 kernels round P and dS to bf16
# (2^-9 relative) for their products and store bf16 (another 2^-9), summed
# over up to 1024 terms of both signs, so 2e-2; f32 kernels differ by the
# summation order only, so 1e-4.
BWD_REL_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# A gradient that is zero in exact arithmetic (dq and dk when every row sees
# one key, S = 1) holds only rounding noise: its error is taken as a share
# of the case's largest gradient, a floor far below any other case's own
# largest |gradient|.
ZERO_GRAD_FLOOR = 1e-3


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


# B1's, B2's and B3's C entry points, as `_build.launch_counts()` names them.
FLASH = ("flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv")


def _launched_since(before):
    """Each kernel's launches since `before`, a `_build.launch_counts()`;
    kernels not launched since are left out."""
    return {k: n - before.get(k, 0) for k, n in _build.launch_counts().items()
            if n != before.get(k, 0)}


def _qkv(b, sq, h, kv, d, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, sq, h, d), generator=g, device="cuda").to(dtype)
    k = torch.randn((b, sq, kv, d), generator=g, device="cuda").to(dtype)
    v = torch.randn((b, sq, kv, d), generator=g, device="cuda").to(dtype)
    do = torch.randn((b, sq, h, d), generator=g, device="cuda").to(dtype)
    return q, k, v, do


def _rel_err(ours, plain, floor=0.0):
    return ((ours.float() - plain).abs().max() / max(plain.abs().max().item(), floor)).item()


@pytest.mark.gpu
@pytest.mark.parametrize(
    "dtype,sq,kv,causal,d",
    [(torch.bfloat16, 1024, 16, True, 128), (torch.bfloat16, 1000, 4, False, 128),
     (torch.float32, 200, 16, True, 128), (torch.bfloat16, 1, 4, True, 128),
     (torch.bfloat16, 64, 4, True, 128), (torch.bfloat16, 200, 4, False, 128),
     (torch.bfloat16, 1024, 4, False, 128), (torch.bfloat16, 1024, 4, True, 64),
     (torch.bfloat16, 200, 16, False, 64), (torch.float32, 200, 4, False, 64)],
    ids=["bf16_serving", "bf16_ragged_gqa", "f32", "bf16_s1", "bf16_s64", "bf16_s200_full",
         "bf16_gqa_full", "bf16_d64_gqa", "bf16_d64_s200_full", "f32_d64"],
)
def test_flash_kernel_matches_plain_on_card(dtype, sq, kv, causal, d):
    """The CUDA kernel against its plain version on the same card inputs.
    bf16: p is rounded to bf16 for the PV product and o is stored in bf16,
    so 2e-2 absolute; f32: 1e-4 (another summation order)."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((2, sq, 16, d), generator=g, device="cuda").to(dtype)
    k = torch.randn((2, sq, kv, d), generator=g, device="cuda").to(dtype)
    v = torch.randn((2, sq, kv, d), generator=g, device="cuda").to(dtype)
    before = _build.launch_counts()
    o, lse = flash.flash_attention_fwd(q, k, v, causal=causal)
    assert _launched_since(before) == {"flash_attn_fwd": 1}
    o_p, lse_p = flash.flash_attention_fwd_plain(q, k, v, causal=causal)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(o.float(), o_p.float(), atol=tol, rtol=0)
    torch.testing.assert_close(lse, lse_p, atol=tol, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "dtype,b,sq,h,kv,d,causal",
    [(torch.bfloat16, 2, 1024, 16, 4, 128, True), (torch.bfloat16, 2, 1000, 8, 8, 128, True),
     (torch.bfloat16, 1, 1000, 8, 2, 64, False), (torch.float32, 1, 200, 4, 2, 128, True),
     (torch.float32, 1, 77, 4, 4, 64, False), (torch.bfloat16, 2, 1, 16, 4, 128, True),
     (torch.bfloat16, 2, 64, 16, 4, 128, True), (torch.bfloat16, 2, 200, 16, 4, 128, False),
     (torch.bfloat16, 2, 1024, 16, 4, 128, False), (torch.bfloat16, 2, 1024, 16, 4, 64, True),
     (torch.bfloat16, 2, 1000, 16, 4, 128, True)],
    ids=["bf16_gqa", "bf16_ragged", "bf16_d64_ragged_full", "f32_gqa", "f32_d64_ragged_full",
         "bf16_s1", "bf16_s64", "bf16_s200_full", "bf16_gqa_full", "bf16_d64_gqa",
         "bf16_gqa_ragged"],
)
def test_flash_bwd_kernels_match_plain_on_card(dtype, b, sq, h, kv, d, causal):
    """B2 (dq) and B3 (dk, dv) against the plain backward computed in f32
    from the same inputs, each launched once."""
    _need_card()
    q, k, v, do = _qkv(b, sq, h, kv, d, dtype)
    o, lse = flash.flash_attention_fwd(q, k, v, causal=causal)
    before = _build.launch_counts()
    grads = flash.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert _launched_since(before) == {"flash_attn_bwd_dq": 1, "flash_attn_bwd_dkv": 1}
    plain = flash.flash_attention_bwd_plain(
        *(t.float() for t in (q, k, v, o)), lse, do.float(), causal=causal
    )
    floor = ZERO_GRAD_FLOOR * max(ref.abs().max().item() for ref in plain)
    for name, ours, ref in zip(("dq", "dk", "dv"), grads, plain):
        assert ours.dtype == dtype and ours.shape == ref.shape, name
        assert bool(torch.isfinite(ours).all()), name
        err = _rel_err(ours, ref, floor)
        assert err <= BWD_REL_TOL[dtype], (name, err)


@pytest.mark.gpu
def test_dq_kernel_is_deterministic_at_training_shape():
    """B2 sums each dq row over the kv tiles in one order inside one block
    (no atomics): two launches on the same inputs give bitwise-equal dq."""
    _need_card()
    q, k, v, do = _qkv(16, 1024, 16, 16, 128, torch.bfloat16, seed=4)
    o, lse = flash.flash_attention_fwd(q, k, v)
    call = flash._BwdLaunch(q, k, v, o, lse, do, True, 128 ** -0.5)
    call.dq()
    first = call.dq_out.clone()
    call.dq()
    torch.cuda.synchronize()
    assert torch.equal(first, call.dq_out)


@pytest.mark.gpu
def test_bwd_permuted_do_at_training_shape():
    """dO laid out [B, H, S, D] in memory at the training shape: the dq and
    dk/dv kernels' tensor maps read it by its strides (no copy), and all
    three gradients match the plain backward."""
    _need_card()
    q, k, v, do = _qkv(16, 1024, 16, 16, 128, torch.bfloat16, seed=2)
    do = do.transpose(1, 2).contiguous().transpose(1, 2)
    assert flash._kernel_readable(do)
    o, lse = flash.flash_attention_fwd(q, k, v)
    grads = flash.flash_attention_bwd(q, k, v, o, lse, do)
    plain = flash.flash_attention_bwd_plain(
        *(t.float() for t in (q, k, v, o)), lse, do.float()
    )
    for name, ours, ref in zip(("dq", "dk", "dv"), grads, plain):
        assert _rel_err(ours, ref) <= BWD_REL_TOL[torch.bfloat16], name


@pytest.mark.gpu
def test_bwd_reads_strided_and_copies_unreadable_grads():
    """dO with another layout gives the same gradients: a [B,H,S,D]
    transpose is read by its strides; a non-contiguous last dim, and
    contiguous rows off 16-byte alignment, are copied first."""
    _need_card()
    q, k, v, do = _qkv(1, 256, 4, 4, 128, torch.bfloat16)
    o, lse = flash.flash_attention_fwd(q, k, v)
    ref = flash.flash_attention_bwd(q, k, v, o, lse, do)
    strided = do.transpose(1, 2).contiguous().transpose(1, 2)
    stepped = torch.empty((*do.shape[:3], 2 * do.shape[3]), dtype=do.dtype, device="cuda")
    stepped[..., ::2] = do
    shifted = torch.empty(do.numel() + 1, dtype=do.dtype, device="cuda")[1:].view(do.shape)
    shifted.copy_(do)
    for layout in (strided, stepped[..., ::2], shifted):
        for ours, want in zip(flash.flash_attention_bwd(q, k, v, o, lse, layout), ref):
            # delta = rowsum(dO * o) may sum in another order for another
            # layout; a misread stride would be off by the whole gradient.
            assert _rel_err(ours, want.float()) <= 1e-2


@pytest.mark.gpu
def test_gradients_flow_through_the_kernel_path():
    """`flash_attention` on CUDA tensors records a gradient: autograd runs
    B2 and B3, and q, k and v get the plain backward's gradients."""
    _need_card()
    q, k, v, do = _qkv(2, 512, 8, 2, 128, torch.bfloat16, seed=1)
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    before = _build.launch_counts()
    o = flash.flash_attention(q, k, v, causal=True)
    dq, dk, dv = torch.autograd.grad(o, (q, k, v), do)
    assert _launched_since(before) == dict.fromkeys(FLASH, 1)
    with torch.no_grad():
        o_p, lse = flash.flash_attention_fwd_plain(q.float(), k.float(), v.float())
        plain = flash.flash_attention_bwd_plain(q.float(), k.float(), v.float(), o_p, lse, do.float())
    for ours, ref in zip((dq, dk, dv), plain):
        assert _rel_err(ours, ref) <= BWD_REL_TOL[torch.bfloat16]


@pytest.mark.gpu
def test_gradient_of_a_sum_over_s_is_copied_not_refused():
    """Autograd hands the gradient of o.sum(1) over broadcast along S
    (stride 0), which TMA cannot read: the wrapper copies it, and q, k and
    v get the plain backward's gradients."""
    _need_card()
    q, k, v, _ = _qkv(2, 256, 8, 2, 128, torch.bfloat16, seed=3)
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    o = flash.flash_attention(q, k, v, causal=True)
    ones = torch.ones((2, 8, 128), dtype=torch.bfloat16, device="cuda")
    dq, dk, dv = torch.autograd.grad(o.sum(1), (q, k, v), ones)
    with torch.no_grad():
        o_p, lse = flash.flash_attention_fwd_plain(q.float(), k.float(), v.float())
        do = torch.ones(q.shape, device="cuda")
        plain = flash.flash_attention_bwd_plain(q.float(), k.float(), v.float(), o_p, lse, do)
    for ours, ref in zip((dq, dk, dv), plain):
        assert _rel_err(ours, ref) <= BWD_REL_TOL[torch.bfloat16]


@pytest.mark.gpu
@pytest.mark.parametrize("sq,launched", [(1024, 1), (1000, 0)], ids=["aligned", "ragged"])
def test_dispatcher_takes_kernel_on_aligned_card_shapes(sq, launched):
    """On a CUDA device the dispatcher picks the kernel when seq % 128 and
    head_dim % 128 are 0, as the JAX package picks Pallas on a TPU."""
    _need_card()
    from ray_tpu_torch.ops.attention import dot_product_attention

    q = torch.randn((1, sq, 4, 128), device="cuda", dtype=torch.bfloat16)
    before = _build.launch_counts()
    dot_product_attention(q, q, q, causal=True)
    assert _launched_since(before).get("flash_attn_fwd", 0) == launched


# A small bf16 model whose attention takes the kernels: head_dim 128.
SMALL = TransformerConfig(
    vocab_size=256, d_model=512, n_layers=2, n_heads=4, n_kv_heads=4, d_ff=1024,
    max_seq_len=1024, param_dtype=torch.bfloat16, attention_impl="flash",
)


def _small_state(cfg):
    ctx = LMTrainContext(cfg)
    g = torch.Generator(device="cpu").manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (4, 1025), generator=g).cuda()
    return ctx, ctx.init_state(0), tokens[:, :-1], tokens[:, 1:]


@pytest.mark.gpu
@pytest.mark.parametrize(
    "remat,policy,fwd",
    [(False, None, 2), (True, "qkv_attn", 2), (True, "attn", 4), (True, None, 4)],
    ids=["no_remat", "qkv_attn", "attn", "full"],
)
def test_launch_counts_through_backward(remat, policy, fwd):
    """One loss.backward() of a 2-layer model: B2 and B3 once per layer; B1
    once per layer, twice where the policy reruns attention's forward."""
    _need_card()
    cfg = dataclasses.replace(SMALL, remat=remat, remat_policy=policy)
    _, state, tokens, targets = _small_state(cfg)
    before = _build.launch_counts()
    cross_entropy_loss(forward(state["params"], tokens, cfg), targets).backward()
    assert all(p.grad is not None for p in state["params"]["layers"]["attn"].values())
    assert _launched_since(before) == dict(zip(FLASH, (fwd, 2, 2)))


@pytest.mark.gpu
def test_remat_policies_keep_less_memory_in_order():
    """Device memory held from the forward to the backward: no remat keeps
    every activation; qkv_attn the layer input, q, k, v, the attention
    output and lse; attn the layer input and the attention output; None the
    layer input only."""
    _need_card()
    kept = {}
    for name, remat, policy in (("no_remat", False, None), ("qkv_attn", True, "qkv_attn"),
                                ("attn", True, "attn"), ("none", True, None)):
        cfg = dataclasses.replace(SMALL, n_layers=4, remat=remat, remat_policy=policy)
        _, state, tokens, targets = _small_state(cfg)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        loss = cross_entropy_loss(forward(state["params"], tokens, cfg), targets)
        torch.cuda.synchronize()
        kept[name] = torch.cuda.memory_allocated() - base
        loss.backward()
        del loss, state
    assert kept["no_remat"] > kept["qkv_attn"] > kept["attn"] > kept["none"], kept


# The ring's schedule against whole-sequence kernels, both bf16 from the
# same inputs: each ring output row merges up to 4 partials, each rounded to
# bf16 before an f32 merge, where whole-sequence B1 rounds once (2e-2, the
# kernels' own bound against the plain version); gradients sum 4 bf16
# partials per chunk in f32 and round the sum, against one rounding: up to
# one bf16 ulp of the largest |gradient| apart (2^-7 of it at worst; 0.55%
# measured on the H100), so 1e-2.
RING_O_TOL = 2e-2
RING_GRAD_REL_TOL = 1e-2


@pytest.mark.gpu
def test_ring_schedule_matches_whole_sequence_kernels():
    """The ring's chunk schedule for a ring of 4 in one process (10 B1, 10
    B2 and 10 B3 launches on 128-token chunks, GQA 4/2) against B1, B2 and
    B3 over the whole 512 tokens."""
    _need_card()
    q, k, v, do = _qkv(2, 512, 4, 2, 128, torch.bfloat16, seed=7)
    o, lse = flash.flash_attention_fwd(q, k, v, causal=True)
    whole = flash.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    before = _build.launch_counts()
    ring_o, ring_lse, *ring_grads = ring_schedule(q, k, v, do, n=4, causal=True)
    torch.cuda.synchronize()
    assert _launched_since(before) == dict.fromkeys(FLASH, 10)
    assert ring_o.dtype == torch.bfloat16
    assert (ring_o.float() - o.float()).abs().max().item() <= RING_O_TOL
    assert (ring_lse - lse).abs().max().item() <= 1e-3
    for name, ours, ref in zip(("dq", "dk", "dv"), ring_grads, whole):
        assert bool(torch.isfinite(ours).all()), name
        assert _rel_err(ours, ref.float()) <= RING_GRAD_REL_TOL, name


@pytest.mark.gpu
def test_bwd_with_supplied_delta_is_bitwise_the_same():
    """flash_attention_bwd with delta given (as ring attention gives it)
    against the same call computing it: bitwise-equal dq, dk and dv."""
    _need_card()
    q, k, v, do = _qkv(2, 1024, 16, 4, 128, torch.bfloat16, seed=8)
    o, lse = flash.flash_attention_fwd(q, k, v, causal=True)
    own = flash.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    given = flash.flash_attention_bwd(q, k, v, o, lse, do, causal=True,
                                      delta=flash._delta(do, o))
    torch.cuda.synchronize()
    for a, b in zip(own, given):
        assert torch.equal(a, b)


# The pipelined schedules through the kernels against the same schedules
# with the plain reference attention, both bf16 from one state: the loss, a
# mean over 4 x 1024 tokens, within 1e-2 and the stage gradients' norm
# within 3e-2 relative, the bounds chip_smoke.py holds a training step to
# against the reference attention (TRAIN_LOSS_TOL, TRAIN_GRAD_NORM_RTOL).
PIPE_LOSS_TOL = 1e-2
PIPE_GRAD_RTOL = 3e-2


def _pipeline_run(cfg, schedule, n_stages, m):
    """(loss, stage gradients) of one schedule of `cfg`'s layers in
    `n_stages` stages in one process, embedding and head outside it."""
    _, state, tokens, targets = _small_state(cfg)
    params = state["params"]
    stacked = transformer.stack_stages(params["layers"], n_stages)
    stage = transformer.pipeline_stage(cfg, torch.arange(tokens.shape[1], device="cuda"))
    x = transformer._embed(params, tokens, cfg, None).detach()

    def head(y, t):
        return cross_entropy_loss(transformer._logits(params, y, cfg, None), t)

    if schedule == "gpipe":
        loss = head(pipeline_apply(stage, stacked, x, n_microbatches=m), targets)
        leaves = tree_leaves(stacked)
        return loss.detach(), torch.autograd.grad(loss, leaves)
    loss, grads = pipeline_train_step_1f1b(stage, head, stacked, x, targets, n_microbatches=m)
    return loss, tree_leaves(grads)


@pytest.mark.gpu
@pytest.mark.parametrize("schedule,launches", [("gpipe", (16, 16, 16)), ("1f1b", (24, 16, 16))])
def test_pipeline_schedules_through_the_kernels(schedule, launches):
    """4 layers (qkv_attn) in 2 stages, 4 microbatches of one row: each
    kernel once per layer per microbatch in each direction; 1F1B runs
    stage 0's forward again in its backward slot (B1 4 x 2 x (1 + 2))."""
    _need_card()
    cfg = dataclasses.replace(SMALL, n_layers=4, remat=True, remat_policy="qkv_attn")
    before = _build.launch_counts()
    loss, grads = _pipeline_run(cfg, schedule, 2, 4)
    assert _launched_since(before) == dict(zip(FLASH, launches))
    ref_loss, ref_grads = _pipeline_run(dataclasses.replace(cfg, attention_impl="reference"),
                                        schedule, 2, 4)
    assert abs(float(loss) - float(ref_loss)) <= PIPE_LOSS_TOL
    norm = lambda gs: torch.linalg.vector_norm(torch.stack(  # noqa: E731
        [torch.linalg.vector_norm(g.float()) for g in gs])).item()
    assert abs(norm(grads) - norm(ref_grads)) <= PIPE_GRAD_RTOL * norm(ref_grads)
