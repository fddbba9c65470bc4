"""The dense family is the parent's code moved: its weights are the same
draws in the same order, and the reference's three steps give the same
losses and first gradient norms, bit for bit, at the tiny InternLM2 size on
the CPU (one thread, so that the reductions keep one order). The numbers
below were read from the tree before the families existed."""

import hashlib

import pytest
import torch

from benchmark import inputs, manifest, tiny
from benchmark.kinds import train

CELL = "internlm2-1.8b.train-4k"
SEED = 2**31 + 41
DIGESTS = {
    torch.float32: "efb8b7052cefdfc05d0d738dd2b765db8d0ebbbc53c3865d25496441ae4d18f7",
    torch.bfloat16: "68df0b609ec694a814dc85f75ba0269c89fdef2d3bdd9874308cfe244ab3ab30",
}
LOSSES = ["0x1.0198b50000000p+3", "0x1.04320f8000000p+3", "0x1.035dcf8000000p+3"]
FIRST_GRAD = {
    "embed/tokens": "0x1.b1eb760000000p-2", "layers/attn/wq": "0x1.ae7f8a0000000p-3",
    "layers/attn/wk": "0x1.c14f860000000p-3", "layers/attn/wv": "0x1.073c1a0000000p-2",
    "layers/attn/wo": "0x1.04cf8c0000000p-1", "layers/mlp/w_gate": "0x1.0002780000000p-2",
    "layers/mlp/w_up": "0x1.fb67a80000000p-3", "layers/mlp/w_down": "0x1.f9f9ec0000000p-2",
    "layers/ln1": "0x1.5e7f460000000p-5", "layers/ln2": "0x1.fedc240000000p-6",
    "final_norm": "0x1.0873700000000p-5", "lm_head": "0x1.66a56e0000000p-3",
}


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def test_a_file_without_a_family_is_dense():
    m = manifest.config("internlm2-1.8b")
    assert "family" not in m
    assert manifest.family(m).__name__ == "benchmark.families.dense"


@pytest.mark.parametrize("dtype", list(DIGESTS), ids=str)
def test_dense_weights_are_the_parent_s_draws(dtype):
    m = tiny.model()
    h = hashlib.sha256()
    tree = inputs.make_params(manifest.family(m), m, SEED, dtype, "cpu")
    for path, _, _ in manifest.family(m).leaves(m):
        h.update("/".join(path).encode())
        h.update(inputs.get_leaf(tree, path).contiguous().view(torch.uint8).numpy().tobytes())
    assert h.hexdigest() == DIGESTS[dtype]


def test_dense_reference_steps_are_the_parent_s(one_thread):
    ref = train.reference_readings(tiny.cell(CELL), tiny.model(), SEED, "cpu")
    assert [x.hex() for x in ref["losses"]] == LOSSES
    assert {"/".join(k): v.hex() for k, v in ref["first_grad"].items()} == FIRST_GRAD
