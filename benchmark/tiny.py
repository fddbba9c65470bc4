"""Tiny stand-ins for the benchmark's configurations and cells, for the
tests on the CPU: every width cut, the layout and the code paths kept."""

import copy

from benchmark import manifest


# Per configuration: wide enough that bf16's error in the compared numbers
# stays as far below the cells' limits, and fp8's as far above, as at full
# size; small enough for the CPU.
SIZES = {
    "internlm2-1.8b": dict(hidden_size=128, num_hidden_layers=2, num_attention_heads=4,
                           num_key_value_heads=2, head_dim=32, intermediate_size=512,
                           vocab_size=2048),
}


def model(name: str = "internlm2-1.8b") -> dict:
    m = manifest.config(name)
    m.update(SIZES[name])
    return m


def cell(name: str) -> dict:
    """A training cell's file as a run reads it, at a tiny batch."""
    c = copy.deepcopy(manifest.workload(name, manifest.manifest()))
    c["traffic"] = {"batch": 4, "seq": 128}
    return c
