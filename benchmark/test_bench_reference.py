"""The plain reference agrees with the port at a tiny size on the CPU: the
forward in float32 to rounding, the bf16 forward to bf16's error, and three
training steps (loss, clipped gradient, AdamW) in float32. The test imports
both; reference.py imports neither the port nor JAX."""

import dataclasses

import pytest
import torch

from benchmark import inputs, tiny
from benchmark.families import dense
from benchmark.kinds import train

CELL = "internlm2-1.8b.train-4k"


def _port_config(m, dtype, param_dtype):
    cfg = dense.program_config(m, tiny.cell(CELL))
    return dataclasses.replace(cfg, dtype=dtype, param_dtype=param_dtype)


def test_forward_float32_agrees():
    from ray_tpu_torch.models.transformer import forward

    m = tiny.model()
    params = inputs.make_params(dense, m, 11, torch.float32, "cpu")
    toks = torch.randint(0, m["vocab_size"], (2, 48), generator=torch.Generator().manual_seed(0))
    ours = forward(params, toks, _port_config(m, torch.float32, torch.float32))
    ref = dense.forward(params, toks, m)
    assert torch.allclose(ours, ref, atol=2e-5, rtol=1e-5), (ours - ref).abs().max()


def test_bf16_forward_agrees_to_bf16_error():
    from ray_tpu_torch.models.transformer import forward

    m = tiny.model()
    params = inputs.make_params(dense, m, 12, torch.bfloat16, "cpu")
    toks = torch.randint(0, m["vocab_size"], (1, 40), generator=torch.Generator().manual_seed(1))
    ours = forward(params, toks, _port_config(m, torch.bfloat16, torch.bfloat16)).float()
    ref = dense.forward(params, toks, m)
    err = (ours - ref).abs().max().item()
    assert err < 0.05 * ref.abs().max().item()
    assert err > 0  # bf16 compute against float32


def test_three_training_steps_agree_in_float32():
    m = tiny.model()
    cell = tiny.cell(CELL)
    m["train"] = dict(m["train"], dtype="float32")
    _, _, ours = train.build(cell, m, 13, device="cpu")
    ref = train.reference_readings(cell, m, 13, device="cpu")
    for a, r in zip(ours["losses"], ref["losses"]):
        assert a == pytest.approx(r, rel=1e-5)
    for p, _, _ in dense.leaves(m):
        assert ours["first_grad"][p] == pytest.approx(ref["first_grad"][p], rel=1e-4), p
        assert ours["change"][p] == pytest.approx(ref["change"][p], rel=1e-3), p
    gaps = train.gaps(ours, ref)
    assert max(gaps.values()) < 1e-3
