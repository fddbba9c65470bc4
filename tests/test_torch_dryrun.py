"""The port's twin of the entry points of `__graft_entry__.py`
(`ray_tpu_torch.dryrun`): `entry()`'s configuration and forward against
`__graft_entry__.entry`'s, the multi-rank dry run on 4 CPU processes joined
in a gloo group, and the 7B state accounting against a count by hand."""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import transformer as jax_tf
from ray_tpu_torch import dryrun
from ray_tpu_torch.models import params_from_numpy
from ray_tpu_torch.parallel import MeshSpec

REPO = Path(__file__).resolve().parents[1]
# As tests/test_torch_transformer.py: f32 sums in other orders; bf16 rounds
# at other points (~5 bf16 ulps at |logits| < 8).
TOL = {"float32": 5e-5, "bfloat16": 0.15}


def _graft_entry_config() -> dict:
    """The keywords of the TransformerConfig call in __graft_entry__.entry."""
    tree = ast.parse((REPO / "__graft_entry__.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "entry")
    call = next(n for n in ast.walk(fn) if isinstance(n, ast.Call)
                and getattr(n.func, "id", None) == "TransformerConfig")
    return {k.arg: ast.literal_eval(k.value) for k in call.keywords}


def test_entry_config_is_the_graft_entry_config():
    assert dryrun.ENTRY_CONFIG == _graft_entry_config()
    assert dryrun.ENTRY_TOKENS == (4, 512)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_entry_forward_matches_jax_at_reduced_width(dtype):
    """The entry configuration with its 8 layers and 8/8 heads at width 128
    (head_dim 16), d_ff 352, vocabulary 512, on its [4, 512] zero tokens."""
    narrow = dict(d_model=128, d_ff=352, vocab_size=512)
    jcfg = jax_tf.TransformerConfig(**{**_graft_entry_config(), **narrow},
                                    dtype=getattr(jnp, dtype))
    jparams = jax_tf.init_params(jcfg, jax.random.PRNGKey(0))
    tokens = jnp.zeros((4, 512), jnp.int32)
    ref = np.asarray(jax_tf.forward(jparams, tokens, jcfg))
    fn, (params, toks) = dryrun.entry(device="cpu", dtype=getattr(torch, dtype), **narrow)
    assert tuple(toks.shape) == (4, 512) and not toks.any()
    ours = fn(params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu"), toks)
    assert ours.dtype == torch.float32 and tuple(ours.shape) == (4, 512, 512)
    np.testing.assert_allclose(ours.numpy(), ref, atol=TOL[dtype], rtol=0)
    # The seeded weights entry() draws have the tree's shapes.
    assert {k: tuple(v.shape) for k, v in params["layers"]["mlp"].items()} == {
        k: v.shape for k, v in jparams["layers"]["mlp"].items()}


def test_7b_state_accounting_matches_a_count_by_hand():
    """fsdp=8: every leaf with an `embed` dim splits it 8 ways; the norms
    (ln1, ln2 [32, 4096], final_norm [4096]) stay whole. f32 parameters,
    gradients and two AdamW moments: 4 copies of 4 bytes."""
    cfg = dryrun.llama_7b_train_config()
    norms = 2 * 32 * 4096 + 4096
    split = cfg.num_params() - norms
    per_copy = (split // 8 + norms) * 4
    counted = dryrun.state_bytes_per_rank(cfg, "fsdp", MeshSpec(data=1, fsdp=8))
    assert counted == {"params": per_copy, "grads": per_copy, "moments": 2 * per_copy,
                       "total": 4 * per_copy}
    assert dryrun.check_7b_state_fits() == counted
    assert counted["total"] < dryrun.H100_MEMORY_BYTES
    # One rank would hold the whole state: 108 GB, past one card.
    whole = dryrun.state_bytes_per_rank(cfg, "fsdp", MeshSpec(data=1))
    assert whole["total"] == 16 * cfg.num_params() > dryrun.H100_MEMORY_BYTES


def test_dryrun_multichip_on_four_cpu_ranks():
    dryrun.dryrun_multichip(4, device_type="cpu")


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.entry()
    with pytest.raises(RuntimeError, match="device_type='cpu'"):
        dryrun.dryrun_multichip(4)
