"""The optimizer's clip + AdamW update: the CUDA kernel
(`ray_tpu_torch/ops/cuda/adamw.py`, `csrc/adamw.cu`) against its plain
version, the `_foreach` chain of `models/lm.py:_clip_adamw_plain`, on the
card; and on the CPU, the plain path, what the wrapper refuses, and the
optimizer state the benchmark reads.

These tests import torch, and jax only inside the one test that holds the
card tests' f64 yardstick against optax on the CPU; the card tests skip
themselves where there is no CUDA card. On the card:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_adamw.py
"""

import math

import pytest
import torch

from ray_tpu_torch.models import LMTrainContext, TransformerConfig, default_optimizer, forward
from ray_tpu_torch.models import lm
from ray_tpu_torch.models.lm import cross_entropy_loss
from ray_tpu_torch.ops.cuda import _build, adamw
from ray_tpu_torch.parallel.sharding import tree_leaves, tree_map

# default_optimizer()'s constants, as both paths take them.
HYPER = dict(learning_rate=3e-4, weight_decay=0.1, b1=0.9, b2=0.95, eps=1e-8, max_norm=1.0)
# The kernel against the chain after each of three steps, as a share of the
# largest |value| the tensor has held so far: a rounding error scales with
# the terms it rounds, which are the tensor's earlier values where a sum
# cancels (a moment whose new gradient has the other sign). f32: both
# compute the same formulas in f32, the chain rounding each pass's result to
# memory and the kernel contracting products and sums into fused
# multiply-adds, a few ulps apart: 8 ulps of the largest value (2^-20).
# bf16: the kernel rounds each stored value once, the chain after every pass
# (the clipped gradient, mu * b1 and the sum, and six times in the update),
# so a moment differs by up to about two bf16 ulps and a parameter by one
# where its update lies near a rounding boundary: two ulps of the largest
# value (2^-6; a bf16 ulp is 2^-7 of a value at the top of its binade). That
# is above a bf16 parameter's change a step; the element-by-element test
# against the chain in f64 (TERM_SHARE) holds the change itself.
KERNEL_TOL = {torch.float32: 2.0 ** -20, torch.bfloat16: 2.0 ** -6}
# The kernel against the plain chain run in f64 on the same inputs, element
# by element (`_update_in_f64`). An f32 output lies within 2^-20 of the
# magnitude of the terms of the sum that forms it: the kernel rounds a few
# times in f32, each time by at most 2^-24 of what it rounds, and a sum may
# cancel down to those errors. A bf16 output may lie one bf16 ulp of the f64
# value further off: the kernel rounds each stored value once, by half an
# ulp, and its f32 error may carry it over a rounding boundary. The bound
# chip_smoke.py holds the kernel to at InternLM2-1.8B's leaves.
TERM_SHARE = 2.0 ** -20
# Leaf shapes: one element, fewer than a vector, a count that is no multiple
# of either vector width (4 f32, 8 bf16), a stacked [L, ...] leaf of
# InternLM2-1.8B's and its [d, vocab] head.
SHAPES = {"one": (1,), "seven": (7,), "ragged": (4099,), "stacked": (24, 2048, 1024),
          "head": (2048, 92544)}
# Each element's gradient scale: norms of 0.5 (under the clip) and 10 (over
# it) whatever the size, and entries near eps, where eps sets the update.
CLIPS = {"under_clip": lambda n: 0.5 / math.sqrt(n), "over_clip": lambda n: 10.0 / math.sqrt(n),
         "near_eps": lambda n: 1e-8}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _parent_chain(grads, mu, nu, params, grad_norm, count, *, learning_rate, weight_decay, b1,
                  b2, eps, max_norm):
    """The update as default_optimizer ran it for every leaf before the
    kernel, line for line."""
    torch._foreach_mul_(grads, max_norm / torch.clamp(grad_norm, min=max_norm))
    upd = lm._scale_by_adam(grads, mu, nu, count, b1, b2, eps)
    torch._foreach_add_(upd, params, alpha=weight_decay)
    torch._foreach_add_(params, upd, alpha=-learning_rate)


def _leaves(shapes, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(s, generator=g, device=device).to(dtype) for s in shapes]


def _grads(shapes, dtype, device, seed, clip):
    g = torch.Generator(device=device).manual_seed(seed)
    return [(torch.randn(s, generator=g, device=device) * CLIPS[clip](math.prod(s))).to(dtype)
            for s in shapes]


def _bf16_ulp(x):
    """One bf16 ulp of each element of `x`: 2^(e-8) where |x| lies in
    [2^(e-1), 2^e), the subnormal step 2^-133 at least."""
    _, e = torch.frexp(x)
    ulp = torch.ldexp(torch.ones_like(x), (e - 8).clamp(min=-133))
    return torch.where(x == 0, 2.0 ** -133, ulp)


def _update_in_f64(p, g, mu, nu, grad_norm, count):
    """One leaf's update by the plain chain in f64 from the same inputs
    (read, not changed): (p, mu, nu) and each one's tolerance, TERM_SHARE
    of the magnitude of its terms (mu's |b1 mu| + |(1 - b1) g'|, nu's own
    value, p's |p| (1 + lr wd) + lr (mu's magnitude) / (bc1 (sqrt(nu_hat) +
    eps)), which also bounds what mu's error moves p by), one bf16 ulp of
    the f64 value more for bf16 leaves, the least f32 step at least."""
    lr, wd, b1, b2, eps = (HYPER[k] for k in ("learning_rate", "weight_decay", "b1", "b2", "eps"))
    p64, g64, m64, v64 = (t.double() for t in (p, g, mu, nu))
    lm._clip_adamw_plain([g64], [m64], [v64], [p64], grad_norm, count, **HYPER)
    mu_mag = b1 * mu.double().abs() + (1 - b1) * g64.abs()
    p_mag = (p.double().abs() * (1 + lr * wd)
             + lr * mu_mag / ((1 - b1 ** count) * ((v64 / (1 - b2 ** count)).sqrt() + eps)))
    refs = (p64, m64, v64)
    floor = _bf16_ulp if p.dtype == torch.bfloat16 else lambda r: 2.0 ** -149
    return refs, [TERM_SHARE * mag + floor(r) for mag, r in zip((p_mag, mu_mag, v64), refs)]


def _launched_since(before):
    """Each kernel's launches since `before`, a `_build.launch_counts()`;
    kernels not launched since are left out."""
    return {k: n - before.get(k, 0) for k, n in _build.launch_counts().items()
            if n != before.get(k, 0)}


# -- on the CPU ---------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("clip", ["under_clip", "over_clip"])
def test_cpu_leaves_take_the_plain_chain_bit_for_bit(dtype, clip):
    """Three updates of CPU leaves equal the chain the optimizer ran before
    the kernel, bit for bit: parameters, moments and the clipped gradients."""
    shapes = [(8, 4), (4,), (3, 5, 2)]
    opt = default_optimizer()
    ours = _leaves(shapes, dtype, "cpu", 0)
    theirs = [p.clone() for p in ours]
    state = opt.init(ours)
    mu, nu = [torch.zeros_like(p) for p in ours], [torch.zeros_like(p) for p in ours]
    for step in range(3):
        grads = _grads(shapes, dtype, "cpu", step + 1, clip)
        mine = [g.clone() for g in grads]
        state = opt.update(mine, state, ours)
        _parent_chain(grads, mu, nu, theirs, lm._global_norm(grads), step + 1, **HYPER)
        for a, b in zip(ours + state["mu"] + state["nu"] + mine, theirs + mu + nu + grads):
            assert torch.equal(a, b)
    assert state["count"] == 3


def test_plain_leaves_are_counted():
    """Updates off the card take the plain chain: two of them leave every
    cuda_kernel_launches series as it was."""
    params = _leaves([(3, 2), (5,)], torch.float32, "cpu", 0)
    opt = default_optimizer()
    state = opt.init(params)
    before = _build.launch_counts()
    for step in range(2):
        state = opt.update(_grads([(3, 2), (5,)], torch.float32, "cpu", step, "over_clip"),
                           state, params)
    assert state["count"] == 2
    assert _build.launch_counts() == before


def test_kernel_module_imports_without_nvcc_or_a_card():
    """Importing the wrapper and updating CPU leaves builds nothing and
    launches nothing: the library is built at the first CUDA update."""
    params = _leaves([(4,)], torch.float32, "cpu", 0)
    opt = default_optimizer()
    opt.update(_grads([(4,)], torch.float32, "cpu", 1, "under_clip"), opt.init(params), params)
    assert "adamw" not in _build.loads and adamw._function.cache_info().currsize == 0
    assert "adamw_update" not in _build.launch_counts()
    with pytest.raises(ValueError, match="CUDA device"):
        adamw.clip_adamw(params, params, params, params, torch.ones(()), 1, **HYPER)
    with pytest.raises(ValueError, match="one of each a leaf"):
        adamw.clip_adamw(params, params, params, params + params, torch.ones(()), 1, **HYPER)


@pytest.mark.parametrize("clip", ["under_clip", "over_clip"])
def test_update_in_f64_matches_optax(clip):
    """The card tests' yardstick, the plain chain in f64 (`_update_in_f64`),
    against optax's chain (the JAX package's default_optimizer) on the same
    f32 inputs for three steps, both given the f32 global norm: within 1e-6
    of each value's scale, a few f32 roundings of optax's."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    import numpy as np
    import optax

    from ray_tpu.models import lm as jax_lm

    shapes = [(8, 4), (4,), (3, 5, 2)]
    params = _leaves(shapes, torch.float32, "cpu", 0)
    tx = jax_lm.default_optimizer()
    jp = [jnp.asarray(p.numpy()) for p in params]
    js = tx.init(jp)
    ours = [(p, torch.zeros_like(p), torch.zeros_like(p)) for p in params]
    for step in range(1, 4):
        grads = _grads(shapes, torch.float32, "cpu", step, clip)
        norm = lm._global_norm(grads)
        ours = [_update_in_f64(p, g, m, v, norm, step)[0] for (p, m, v), g in zip(ours, grads)]
        updates, js = tx.update([jnp.asarray(g.numpy()) for g in grads], js, jp)
        jp = optax.apply_updates(jp, updates)
    adam = [s for s in jax.tree_util.tree_leaves(
        js, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]
    for i, theirs in enumerate(zip(jp, adam.mu, adam.nu)):
        for a, b in zip(ours[i], theirs):
            b = np.asarray(b, dtype=np.float64)
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-6 * np.abs(b).max())


def _four(p, g=None):
    return p, p.clone() if g is None else g, torch.zeros_like(p), torch.zeros_like(p)


@pytest.mark.parametrize("case,refused", [
    ("f32", None), ("bf16", None), ("f16", "f32 or all bf16"), ("mixed_dtypes", "f32 or all bf16"),
    ("shapes", "differ in shape"), ("transposed_grad", "contiguous"), ("strided", "contiguous"),
    ("permuted_shared", "contiguous"),
])
def test_refusal_reads_only_the_layout(case, refused):
    """What the kernel takes: p, g, mu and nu of one type (f32 or bf16),
    one shape, each contiguous; a permuted layout is refused even where
    all four share it. Checked from types, shapes and strides alone, so
    here on the CPU."""
    p = torch.randn(6, 5)
    four = {
        "f32": lambda: _four(p),
        "bf16": lambda: _four(p.bfloat16()),
        "f16": lambda: _four(p.half()),
        "mixed_dtypes": lambda: _four(p, p.bfloat16()),
        "shapes": lambda: _four(p, torch.randn(5, 6)),
        "transposed_grad": lambda: _four(p, torch.randn(5, 6).t()),
        "strided": lambda: _four(torch.randn(6, 10)[:, ::2]),
        "permuted_shared": lambda: tuple(t.t() for t in _four(torch.randn(5, 6))),
    }[case]()
    why = adamw.refusal(*four)
    assert (why is None) if refused is None else (refused in why)


def _tiny_step():
    """One step of LMTrainContext on tiny at f32 on the CPU, and the same
    first step's gradients clipped by hand from a copy of the weights."""
    ctx = LMTrainContext(TransformerConfig.tiny(), device="cpu")
    state = ctx.init_state(0)
    copy = tree_map(lambda p: p.detach().clone().requires_grad_(True), state["params"])
    toks = torch.randint(0, ctx.config.vocab_size, (2, 17),
                         generator=torch.Generator().manual_seed(3))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    loss = cross_entropy_loss(forward(copy, batch["tokens"], ctx.config), batch["targets"])
    grads = torch.autograd.grad(loss, tree_leaves(copy))
    norm = lm._global_norm(list(grads))
    clipped = [g * (HYPER["max_norm"] / torch.clamp(norm, min=HYPER["max_norm"])) for g in grads]
    leaves = tree_leaves(state["params"])
    state, _ = ctx.train_step(state, batch)
    return leaves, state, clipped


def test_train_context_keeps_the_moments_as_lists_in_leaf_order():
    """LMTrainContext's optimizer state keeps mu and nu as lists in the
    leaves' order (`state_placements`, the checkpoint and the benchmark
    read them so), raw moments of each leaf's shape and type."""
    leaves, state, _ = _tiny_step()
    opt = state["opt_state"]
    assert opt["count"] == 1
    for name in ("mu", "nu"):
        assert isinstance(opt[name], list) and len(opt[name]) == len(leaves) == 12
        for m, p in zip(opt[name], leaves):
            assert m.shape == p.shape and m.dtype == p.dtype and not m.requires_grad


def test_first_step_mu_is_the_clipped_gradient():
    """After the first step mu = (1 - b1) g', so mu / (1 - b1) is each
    leaf's clipped gradient: what the benchmark's grad_gap reads."""
    _, state, clipped = _tiny_step()
    for m, g in zip(state["opt_state"]["mu"], clipped):
        torch.testing.assert_close(m / (1 - HYPER["b1"]), g, rtol=1e-6, atol=1e-9)


# -- on the card --------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("clip", list(CLIPS))
@pytest.mark.parametrize("shape", list(SHAPES) + ["unaligned"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_kernel_matches_the_plain_chain_on_card(dtype, shape, clip):
    """Three updates of one leaf by the kernel and by the plain chain from
    the same card tensors and gradients, each path on its own state:
    parameters and moments within KERNEL_TOL after every step; one launch
    an update. `unaligned` leaves start 4 bytes past a 16-byte boundary, so
    the kernel takes its element-at-a-time loop."""
    _need_card()
    dims = (4099,) if shape == "unaligned" else SHAPES[shape]
    n = math.prod(dims)
    offset = 4 // torch.empty((), dtype=dtype).element_size() if shape == "unaligned" else 0

    def place(t):
        return torch.empty(n + offset, dtype=dtype, device="cuda")[offset:].view(dims).copy_(t)

    p0 = place(_leaves([dims], dtype, "cuda", 0)[0])
    ours = [p0, place(torch.zeros_like(p0)), place(torch.zeros_like(p0))]
    assert shape != "unaligned" or p0.data_ptr() % 16
    plain = [t.clone() for t in ours]
    held = [t.float().abs().max().item() for t in plain]
    for step in range(3):
        g = place(_grads([dims], dtype, "cuda", step + 1, clip)[0])
        norm = lm._global_norm([g])
        before = _build.launch_counts()
        adamw.clip_adamw([g], [ours[1]], [ours[2]], [ours[0]], norm, step + 1, **HYPER)
        assert _launched_since(before) == {"adamw_update": 1}
        lm._clip_adamw_plain([g.clone()], [plain[1]], [plain[2]], [plain[0]], norm, step + 1,
                             **HYPER)
        for i, (name, a, b) in enumerate(zip(("p", "mu", "nu"), ours, plain)):
            held[i] = max(held[i], b.float().abs().max().item())
            err = (a.float() - b.float()).abs().max().item()
            assert err <= KERNEL_TOL[dtype] * held[i], (step, name, err, held[i])


@pytest.mark.gpu
@pytest.mark.parametrize("clip", list(CLIPS))
@pytest.mark.parametrize("shape", ["seven", "ragged", "stacked", "head"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_kernel_matches_the_update_in_f64_element_by_element(dtype, shape, clip):
    """Three updates of one leaf by the kernel, each output element against
    the plain chain run in f64 on the same inputs (`_update_in_f64`): the
    parameter too, whose change in bf16 is a few ulps at the init's scale
    (0.02) and below one at 1. The values the kernel overwrote lie outside
    that tolerance at some element and step, so a value left unwritten
    fails."""
    _need_card()
    dims = SHAPES[shape]
    p = (_leaves([dims], torch.float32, "cuda", 0)[0] * 0.02).to(dtype)
    mu, nu = torch.zeros_like(p), torch.zeros_like(p)
    seen = dict.fromkeys(("p", "mu", "nu"), 0.0)
    for step in range(1, 4):
        g = _grads([dims], dtype, "cuda", step, clip)[0]
        norm = lm._global_norm([g])
        refs, tols = _update_in_f64(p, g, mu, nu, norm, step)
        olds = (p.clone(), mu.clone(), nu.clone())
        adamw.clip_adamw([g], [mu], [nu], [p], norm, step, **HYPER)
        for name, ours, old, ref, tol in zip(("p", "mu", "nu"), (p, mu, nu), olds, refs, tols):
            worst = ((ours.double() - ref).abs() / tol).max().item()
            assert worst <= 1, (step, name, worst)
            seen[name] = max(seen[name], ((old.double() - ref).abs() / tol).max().item())
    assert all(v > 1 for v in seen.values()), seen


@pytest.mark.gpu
def test_a_leaf_the_kernel_cannot_take_raises_on_card():
    """A CUDA leaf of another type, or whose gradient is laid out apart
    from it, raises naming the leaf, and nothing is launched."""
    _need_card()
    ok = torch.randn(4, 6, device="cuda")
    half = ok.half()
    norm = torch.ones((), device="cuda")
    before = _build.launch_counts()
    with pytest.raises(ValueError, match=r"leaf 1 \(4, 6\).*f32 or all bf16"):
        adamw.clip_adamw([ok, half], [ok.clone(), half.clone()], [ok.clone(), half.clone()],
                         [ok.clone(), half.clone()], norm, 1, **HYPER)
    with pytest.raises(ValueError, match=r"leaf 0 \(4, 6\).*contiguous"):
        adamw.clip_adamw([torch.randn(6, 4, device="cuda").t()], [ok.clone()], [ok.clone()],
                         [ok.clone()], norm, 1, **HYPER)
    assert _build.launch_counts() == before


@pytest.mark.gpu
def test_train_step_on_card_takes_the_kernel():
    """A step of LMTrainContext on the card updates each of its 12 leaves
    by one launch of adamw_update, and launches no other kernel but the
    RMSNorm's, five of each (two norms a layer and the final one; the tiny
    configuration's attention is not the flash kernels')."""
    _need_card()
    ctx = LMTrainContext(TransformerConfig.tiny())
    state = ctx.init_state(0)
    toks = torch.randint(0, ctx.config.vocab_size, (2, 17), device="cuda")
    before = _build.launch_counts()
    state, m = ctx.train_step(state, {"tokens": toks[:, :-1], "targets": toks[:, 1:]})
    assert math.isfinite(float(m["loss"]))
    assert _launched_since(before) == {"adamw_update": 12, "rms_norm_fwd": 5,
                                       "rms_norm_bwd": 5, "rms_norm_dw": 5}
