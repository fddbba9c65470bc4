"""Parity of the port's flash-attention backward (`flash_attention_bwd_plain`
and the `_FlashAttention` autograd wiring) with the JAX package's on the CPU.

The same inputs, drawn from a seeded numpy generator, go through both. The
JAX Pallas kernels run in interpret mode, as tests/test_ops_attention.py
runs them. On CPU tensors the port's Function runs the plain versions of its
kernels, so these tests hold the formulas and the wiring; the kernels
themselves are held to the plain versions on the card
(tests/test_torch_kernels.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import attention as jax_attention
from ray_tpu.ops.pallas import flash_attention as jax_flash
from ray_tpu_torch.ops import attention
from ray_tpu_torch.ops.cuda import flash_attention as flash

# f32, the bound tests/test_ops_attention.py holds the JAX kernels to: the
# two frameworks sum the same products in other orders.
BWD_TOL = 2e-5
# Gradients through the whole op, the bound tests/test_ops_attention.py
# holds the JAX kernel's gradients to against autodiff of the reference.
GRAD_TOL = 1e-4


def _arrays(seed, b, s, h, d, kv=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d), dtype=np.float32)
    k = rng.standard_normal((b, s, kv or h, d), dtype=np.float32)
    v = rng.standard_normal((b, s, kv or h, d), dtype=np.float32)
    do = rng.standard_normal((b, s, h, d), dtype=np.float32)
    return q, k, v, do


def _close(ours, theirs, tol):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs), atol=tol, rtol=tol)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_plain_matches_jax_kernels(causal):
    """(dq, dk, dv) of the port's plain backward against the JAX Pallas
    backward kernels, from the same q, k, v, o, lse and dO (o and lse from
    the JAX forward kernel)."""
    q, k, v, do = _arrays(0, 2, 256, 4, 64)
    scale = 64 ** -0.5
    kw = dict(causal=causal, scale=scale, block_q=64, block_k=64, interpret=True)
    o, lse = jax_flash._flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    theirs = jax_flash._flash_bwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), o, lse, jnp.asarray(do), **kw
    )
    t = [torch.from_numpy(np.array(a)) for a in (q, k, v, o, lse, do)]
    ours = flash.flash_attention_bwd(*t, causal=causal, scale=scale)
    for a, b in zip(ours, theirs):
        _close(a, b, BWD_TOL)


def _grads_jax(q, k, v, g, causal, **blocks):
    def loss(q, k, v):
        out = jax_flash.flash_attention(q, k, v, causal=causal, **blocks)
        return (out * g).sum() if g is not None else out.sum()

    return jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))


def _grads_port(q, k, v, g, causal):
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = flash.flash_attention(q, k, v, causal=causal)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    loss = (out * torch.from_numpy(g)).sum() if g is not None else out.sum()
    return torch.autograd.grad(loss, (q, k, v))


@pytest.mark.parametrize(
    "s,h,kv,causal,cotangent,blocks",
    [
        (128, 2, None, True, False, dict(block_q=64, block_k=64)),
        (256, 2, None, False, True,
         dict(block_q=128, block_k=128, bwd_block_q=64, bwd_block_k=128)),
        (256, 2, None, True, True,
         dict(block_q=128, block_k=128, bwd_block_q=64, bwd_block_k=128)),
        (128, 4, 2, True, False, dict(block_q=64, block_k=64)),
        (200, 2, None, True, True, dict(block_q=64, block_k=64)),
    ],
    ids=["causal", "full_cotangent", "causal_cotangent", "gqa_4_2", "ragged_200"],
)
def test_flash_attention_grad_matches_jax(s, h, kv, causal, cotangent, blocks):
    """torch.autograd.grad through the port's `flash_attention` (its
    autograd Function on CPU tensors) against jax.grad of the JAX
    `flash_attention`, as tests/test_ops_attention.py:53-108 holds the JAX
    kernels. At S=200 no 128-multiple tile divides the length and the JAX
    wrapper takes its blockwise scan; the port's kernels mask the edge."""
    q, k, v, g = _arrays(1, 1, s, h, 32, kv)
    g = g if cotangent else None
    theirs = _grads_jax(q, k, v, g, causal, **blocks)
    ours = _grads_port(q, k, v, g, causal)
    for a, b in zip(ours, theirs):
        _close(a, b, GRAD_TOL)


def test_no_graph_is_recorded_without_grad():
    """Serving runs under no_grad: the Function saves nothing and the
    output carries no gradient function."""
    q = torch.from_numpy(_arrays(2, 1, 64, 2, 32)[0]).requires_grad_(True)
    with torch.no_grad():
        out = flash.flash_attention(q, q, q)
    assert out.grad_fn is None and not out.requires_grad


@pytest.mark.parametrize("impl", ["pallas", "flash"])
def test_dispatcher_takes_the_kernel_path_by_either_name(impl):
    """"pallas", the JAX package's name for its kernel path, selects the
    port's kernels as "flash" does, and agrees with the JAX dispatcher."""
    q, k, v, _ = _arrays(3, 1, 128, 2, 32)
    out = attention.dot_product_attention(
        *(torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)), impl=impl
    )
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    theirs = jax_attention.dot_product_attention(q, k, v, impl="pallas")
    _close(out, theirs, BWD_TOL)
    with pytest.raises(ValueError, match="unknown attention impl"):
        attention.dot_product_attention(torch.from_numpy(q), torch.from_numpy(k),
                                        torch.from_numpy(v), impl="triton")
