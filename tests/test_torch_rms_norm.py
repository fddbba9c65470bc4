"""RMSNorm: the CUDA kernels (`ray_tpu_torch/ops/cuda/rms_norm.py`,
`csrc/rms_norm.cu`) against the plain expression and against f64 on the
card; and on the CPU, the plain path bit for bit and what the wrapper
refuses.

These tests import torch and nothing of jax, and the card tests skip
themselves where there is no CUDA card. On the card:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_rms_norm.py
"""

import pytest
import torch

from ray_tpu_torch.models import LMTrainContext, TransformerConfig
from ray_tpu_torch.models import transformer
from ray_tpu_torch.ops.cuda import _build
from ray_tpu_torch.ops.cuda import rms_norm as norm

EPS = 1e-5
KERNELS = ("rms_norm_fwd", "rms_norm_bwd", "rms_norm_dw")
# (x's type, the weight's): the decoder's training (bf16 activations, f32
# masters), its serving (weights cast to bf16 at load) and f32 models.
DTYPES = {"bf16_f32": (torch.bfloat16, torch.float32),
          "bf16_bf16": (torch.bfloat16, torch.bfloat16),
          "f32_f32": (torch.float32, torch.float32),
          "f32_bf16": (torch.float32, torch.bfloat16)}
# The kernels' r against the plain expression's, relative: both sum d f32
# squares (in different orders, each addition within 2^-24 of the running
# sum, some 20 deep in either) and take an f32 rsqrt (2 ulps): 2^-18.
RSTD_RTOL = 2.0 ** -18
# The kernels' y against the plain expression's: r's difference, which y
# carries (RSTD_RTOL of |y|), and Y_ULPS ulps of x's type at the plain
# value: in bf16, where r's difference moves x r across a rounding boundary
# of T(n), one ulp of n, which the product with T(w) (|w| < 2 here)
# carries into at most two ulps of y after its own rounding.
Y_ULPS = 2
# The backward is held against f64 autograd of the same function within
# the tolerances of `norm.f64_reference` (`norm.TERM_SHARE` says why).


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _launched_since(before):
    """Each kernel's launches since `before`, a `_build.launch_counts()`;
    kernels not launched since are left out."""
    return {k: n - before.get(k, 0) for k, n in _build.launch_counts().items()
            if n != before.get(k, 0)}


def _old_expression(x, weight, eps):
    """models/transformer.py:rms_norm as it stood before the kernels."""
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * weight.to(x.dtype)


def _inputs(rows, d, x_dtype, w_dtype, device, seed=0):
    """x and dy [rows, d] of x_dtype, weight [d] of w_dtype near 1."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((rows, d), generator=g, device=device).to(x_dtype)
    w = (1 + 0.1 * torch.randn((d,), generator=g, device=device)).to(w_dtype)
    dy = torch.randn((rows, d), generator=g, device=device).to(x_dtype)
    return x, w, dy


# -- on the CPU ---------------------------------------------------------------


@pytest.mark.parametrize("dtypes", list(DTYPES))
def test_cpu_rms_norm_is_the_old_expression_bit_for_bit(dtypes):
    """On the CPU `rms_norm` is the expression it was before the kernels:
    the same output and the same gradients of x and weight, bit for bit,
    and nothing built or launched."""
    x_dtype, w_dtype = DTYPES[dtypes]
    x, w, dy = _inputs(5, 64, x_dtype, w_dtype, "cpu")
    before = _build.launch_counts()
    outs = []
    for fn in (transformer.rms_norm, _old_expression):
        xs, ws = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        y = fn(xs, ws, EPS)
        outs.append((y, *torch.autograd.grad(y, (xs, ws), dy)))
    for ours, theirs in zip(*outs):
        assert ours.dtype == theirs.dtype and torch.equal(ours, theirs)
    assert _build.launch_counts() == before


def test_kernel_module_imports_without_nvcc_or_a_card():
    """Importing the wrapper and norming CPU tensors builds nothing and
    launches nothing; the wrapper itself takes only CUDA tensors."""
    x, w, _ = _inputs(3, 64, torch.float32, torch.float32, "cpu")
    transformer.rms_norm(x, w, EPS)
    assert "rms_norm" not in _build.loads and norm._library.cache_info().currsize == 0
    assert not set(KERNELS) & set(_build.launch_counts())
    with pytest.raises(ValueError, match="CUDA device"):
        norm.rms_norm(x, w, EPS)


@pytest.mark.parametrize("case,refused", [
    ("bf16_f32", None), ("bf16_bf16", None), ("f32_f32", None), ("f32_bf16", None),
    ("d_8", None), ("d_4096", None), ("d_4104", None), ("d_8192", None),
    ("leading_dims", None), ("stacked_slice", None),
    ("f16", "bf16 or f32"), ("weight_shape", "shape [d]"), ("odd_width", "multiple of 8"),
    ("too_wide", "multiple of 8"), ("transposed", "contiguous"), ("strided", "contiguous"),
    ("weight_strided", "contiguous"), ("unaligned", "aligned"),
])
def test_refusal_reads_only_the_layout(case, refused):
    """What the kernels take: x bf16 or f32, contiguous, d a multiple of 8
    up to 8192 (the decoders' widths: 64 to 4096 here, 8192 at 70B); weight
    f32 or bf16 of shape [d], contiguous (a slice of a stacked [L, d] leaf
    is); both 16-byte aligned. Checked from types, shapes, strides and
    addresses alone, so here on the CPU."""
    def pair(x_dtype=torch.bfloat16, w_dtype=torch.float32, rows=4, d=64):
        return torch.zeros((rows, d), dtype=x_dtype), torch.ones(d, dtype=w_dtype)

    x, w = pair()
    args = {
        "bf16_f32": lambda: (x, w),
        "bf16_bf16": lambda: pair(w_dtype=torch.bfloat16),
        "f32_f32": lambda: pair(torch.float32),
        "f32_bf16": lambda: pair(torch.float32, torch.bfloat16),
        "d_8": lambda: pair(d=8),
        "d_4096": lambda: pair(d=4096),
        "d_4104": lambda: pair(d=4104),
        "d_8192": lambda: pair(d=8192),
        "leading_dims": lambda: (torch.zeros((2, 3, 64), dtype=torch.bfloat16), w),
        "stacked_slice": lambda: (x, torch.ones((24, 64)).unbind(0)[5]),
        "f16": lambda: pair(torch.float16),
        "weight_shape": lambda: (x, torch.ones(32)),
        "odd_width": lambda: pair(d=12),
        "too_wide": lambda: pair(d=8200),
        "transposed": lambda: (torch.zeros((64, 4), dtype=torch.bfloat16).t(), w),
        "strided": lambda: (torch.zeros((4, 128), dtype=torch.bfloat16)[:, ::2], w),
        "weight_strided": lambda: (x, torch.ones(128)[::2]),
        "unaligned": lambda: (torch.zeros(4 * 64 + 1, dtype=torch.bfloat16)[1:].view(4, 64), w),
    }[case]()
    why = norm.refusal(*args)
    assert (why is None) if refused is None else (refused in why), why


# -- on the card --------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 7, 16384])
@pytest.mark.parametrize("d", [8, 24, 64, 512, 1000, 1536, 2048, 4096, 4104, 8192])
@pytest.mark.parametrize("dtypes", list(DTYPES))
def test_forward_matches_the_plain_expression_on_card(dtypes, d, rows):
    """The forward against the plain expression on the same card tensors:
    its r within RSTD_RTOL of the plain one; its y bit for bit the plain
    expression's rounding at its own r, and within r's difference and
    Y_ULPS of the plain y; one launch."""
    _need_card()
    x_dtype, w_dtype = DTYPES[dtypes]
    x, w, _ = _inputs(rows, d, x_dtype, w_dtype, "cuda", seed=d + rows)
    before = _build.launch_counts()
    y, rstd = norm._forward(x, w, EPS, save=True)
    assert _launched_since(before) == {"rms_norm_fwd": 1}
    xf = x.float()
    r_plain = torch.rsqrt(torch.mean(torch.square(xf), dim=-1) + EPS)
    assert ((rstd - r_plain).abs() <= RSTD_RTOL * r_plain).all()
    at_own_r = (xf * rstd[:, None]).to(x_dtype) * w.to(x_dtype)
    assert y.dtype == x_dtype and torch.equal(y, at_own_r)
    plain = transformer.rms_norm_plain(x, w, EPS)
    tol = RSTD_RTOL * plain.double().abs() + Y_ULPS * norm.ulp(plain, x_dtype)
    worst = ((y.double() - plain.double()).abs() / tol).max().item()
    assert worst <= 1, worst
    assert torch.equal(transformer.rms_norm(x, w, EPS), y)  # the decoder's call, no grad


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 7, 16384])
@pytest.mark.parametrize("d", [24, 64, 1000, 2048, 4096, 4104, 8192])
@pytest.mark.parametrize("dtypes", ["bf16_f32", "bf16_bf16", "f32_f32"])
def test_backward_matches_f64_autograd_on_card(dtypes, d, rows):
    """dx and dw through autograd against f64 autograd of the same
    function (`norm.f64_reference`), element by element within their
    tolerance; the mean's term of dx is seen (dx without it lies outside);
    one launch each of rms_norm_fwd, rms_norm_bwd and rms_norm_dw."""
    _need_card()
    x_dtype, w_dtype = DTYPES[dtypes]
    x, w, dy = _inputs(rows, d, x_dtype, w_dtype, "cuda", seed=d + rows)
    xs, ws = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    before = _build.launch_counts()
    y = transformer.rms_norm(xs, ws, EPS)
    dx, dw = torch.autograd.grad(y, (xs, ws), dy)
    assert _launched_since(before) == dict.fromkeys(KERNELS, 1)
    assert dx.dtype == x_dtype and dw.dtype == w_dtype
    ref = norm.f64_reference(x, w, dy, EPS)
    (dx_ref, dx_tol), (dw_ref, dw_tol) = ref["dx"], ref["dw"]
    assert ((dx.double() - dx_ref).abs() / dx_tol).max().item() <= 1
    assert ((dw.double() - dw_ref).abs() / dw_tol).max().item() <= 1
    no_mean_term = ref["r"] * dy.double() * w.to(x_dtype).double()
    assert ((no_mean_term - dx_ref).abs() / dx_tol).max().item() > 1


@pytest.mark.gpu
def test_backward_is_the_same_from_run_to_run_on_card():
    """Two backward passes at the benchmark's shape give bitwise-equal dx
    and dw: dw's partial sums are reduced in a fixed order, no atomics."""
    _need_card()
    x, w, dy = _inputs(16384, 2048, torch.bfloat16, torch.float32, "cuda")
    _, rstd = norm._forward(x, w, EPS, save=True)
    first = norm._backward(x, w, dy, rstd, True, True)
    for _ in range(3):
        again = norm._backward(x, w, dy, rstd, True, True)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(0, 64), (2, 0, 2048)])
def test_no_rows_launch_nothing_on_card(shape):
    """An input of no rows launches nothing and counts no launch: an empty
    y, an empty dx and a zero dw."""
    _need_card()
    _, w, _ = _inputs(1, shape[-1], torch.bfloat16, torch.float32, "cuda")
    xs = torch.empty(shape, dtype=torch.bfloat16, device="cuda", requires_grad=True)
    ws = w.clone().requires_grad_(True)
    before = _build.launch_counts()
    y = transformer.rms_norm(xs, ws, EPS)
    dx, dw = torch.autograd.grad(y, (xs, ws), torch.empty_like(y))
    assert _build.launch_counts() == before
    assert y.shape == dx.shape == shape and torch.equal(dw, torch.zeros_like(w))


@pytest.mark.gpu
def test_gradients_only_where_asked_on_card():
    """A weight that needs no gradient costs no dw launch; no autograd
    (serving) costs one forward launch and saves nothing, with the same y."""
    _need_card()
    x, w, dy = _inputs(64, 512, torch.bfloat16, torch.float32, "cuda")
    xs = x.clone().requires_grad_(True)
    before = _build.launch_counts()
    y = transformer.rms_norm(xs, w, EPS)
    (dx,) = torch.autograd.grad(y, (xs,), dy)
    assert _launched_since(before) == {"rms_norm_fwd": 1, "rms_norm_bwd": 1}
    before = _build.launch_counts()
    with torch.no_grad():
        y_served = transformer.rms_norm(xs, w, EPS)
    assert _launched_since(before) == {"rms_norm_fwd": 1}
    assert y_served.grad_fn is None and torch.equal(y_served, y.detach())


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["transposed", "odd_width", "f16", "weight_on_cpu"])
def test_a_layout_the_kernels_cannot_take_raises_on_card(case):
    """A CUDA input the kernels cannot take raises naming why, and nothing
    is launched: no fallback to the plain expression."""
    _need_card()
    w = torch.ones(64, device="cuda")
    x, w, match = {
        "transposed": (torch.zeros((64, 4), device="cuda", dtype=torch.bfloat16).t(), w,
                       "contiguous"),
        "odd_width": (torch.zeros((4, 12), device="cuda"), torch.ones(12, device="cuda"),
                      "multiple of 8"),
        "f16": (torch.zeros((4, 64), device="cuda", dtype=torch.float16), w, "bf16 or f32"),
        "weight_on_cpu": (torch.zeros((4, 64), device="cuda"), torch.ones(64), "one CUDA device"),
    }[case]
    before = _build.launch_counts()
    with pytest.raises(ValueError, match=match):
        transformer.rms_norm(x, w, EPS)
    assert _build.launch_counts() == before


@pytest.mark.gpu
@pytest.mark.parametrize("remat,policy,fwd", [(False, None, 5), (True, "qkv_attn", 9)],
                         ids=["no_remat", "qkv_attn"])
def test_train_step_launches_the_norm_kernels_on_card(remat, policy, fwd):
    """A card train_step of a 2-layer model: rms_norm_fwd 2L + 1 times (two
    norms a layer and the final one), 4L + 1 where remat reruns both of a
    layer's segments; rms_norm_bwd and rms_norm_dw 2L + 1 times."""
    _need_card()
    cfg = TransformerConfig.tiny(dtype=torch.bfloat16, remat=remat, remat_policy=policy)
    ctx = LMTrainContext(cfg)
    state = ctx.init_state(0)
    toks = torch.randint(0, cfg.vocab_size, (2, 17), device="cuda")
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    L = cfg.n_layers
    for _ in range(2):
        before = _build.launch_counts()
        state, m = ctx.train_step(state, batch)
        got = _launched_since(before)
        assert {k: got.get(k, 0) for k in KERNELS} == {
            "rms_norm_fwd": fwd, "rms_norm_bwd": 2 * L + 1, "rms_norm_dw": 2 * L + 1}
        assert torch.isfinite(m["loss"]).item()


@pytest.mark.gpu
def test_train_step_matches_the_plain_norm_on_card():
    """A card train_step with the kernels against the same step with the
    plain expression patched in, from one state and batch: the same loss
    and gradient norm within bf16's rounding of the norm's outputs."""
    _need_card()
    cfg = TransformerConfig.tiny(dtype=torch.bfloat16, remat=True, remat_policy="qkv_attn")
    toks = torch.randint(0, cfg.vocab_size, (2, 65), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(1))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    out = []
    for fn in (transformer.rms_norm, transformer.rms_norm_plain):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(transformer, "rms_norm", fn)
            ctx = LMTrainContext(cfg)
            _, m = ctx.train_step(ctx.init_state(0), batch)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    (loss, gnorm), (loss_p, gnorm_p) = out
    assert abs(loss - loss_p) <= 1e-2 * abs(loss_p)
    assert abs(gnorm - gnorm_p) <= 3e-2 * gnorm_p

