"""Tiny stand-ins for the benchmark's configurations and cells, for the
tests on the CPU: every width cut to its family's `TINY` sizes, the layout
and the code paths kept."""

import copy

from benchmark import manifest


def model(name: str = "internlm2-1.8b") -> dict:
    m = manifest.config(name)
    m.update(manifest.family(m).TINY)
    return m


def cell(name: str) -> dict:
    """A training cell's file as a run reads it, at a tiny batch."""
    c = copy.deepcopy(manifest.workload(name, manifest.manifest()))
    c["traffic"] = {"batch": 4, "seq": 128}
    return c
