"""Inputs made from the seed: a model's weights (the leaves its family
lists, `benchmark/families/`) and a training cell's token batches, on the
device, in a fixed order of large draws.

The program and the plain reference are both handed what these functions
make; neither makes its own. The same seed on the same device gives the
same numbers, so the reference draws them again after the program's state
is freed.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Iterator, Tuple

import torch


def derive(seed: int, *tags) -> int:
    """A 63-bit seed of its own for each use of the run's seed."""
    h = hashlib.sha256(repr((int(seed),) + tags).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def iter_params(family, m: dict, seed: int, dtype: torch.dtype,
                device) -> Iterator[Tuple[Tuple[str, ...], torch.Tensor]]:
    """The weights of `family.leaves(m)` one leaf at a time, each drawn in
    `dtype` in one call from a generator on `device` seeded from `seed`."""
    g = torch.Generator(device=device).manual_seed(derive(seed, "weights"))
    for path, shape, scale in family.leaves(m):
        if scale is None:
            yield path, torch.ones(shape, dtype=dtype, device=device)
        else:
            yield path, torch.randn(shape, generator=g, dtype=dtype, device=device).mul_(scale)


def make_params(family, m: dict, seed: int, dtype: torch.dtype, device) -> Dict:
    """The whole weight tree, nested dicts in the port's layout."""
    tree: Dict = {}
    for path, t in iter_params(family, m, seed, dtype, device):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return tree


def get_leaf(tree: Dict, path) -> torch.Tensor:
    for k in path:
        tree = tree[k]
    return tree


def train_batch(m: dict, seed: int, step: int, batch: int, seq: int, device) -> Dict:
    """Step `step`'s batch: [batch, seq + 1] uniform token ids from a
    generator of its own, as tokens and next-token targets. Every step's rows
    differ."""
    g = torch.Generator(device=device).manual_seed(derive(seed, "train", step))
    ids = torch.randint(0, m["vocab_size"], (batch, seq + 1), generator=g, device=device)
    return {"tokens": ids[:, :-1], "targets": ids[:, 1:]}
