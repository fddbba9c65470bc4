"""The control comes out not correct: the plain reference in the program's
place, computed from float8 e4m3 operands (one precision below the bf16
compute that the configuration states), judged by the cell's own limits.
Here at a tiny size on the CPU, beside the program, which passes; the
readings at the cell's own size on the card are in PERF.md
(`benchmark/calibrate.py`, and the `gpu` test below)."""

import json
import subprocess
import sys

import pytest

from benchmark import manifest, tiny

CELL = "internlm2-1.8b.train-4k"


def _fails(readings: dict, limits: dict) -> bool:
    return any(readings[k] > limit for k, limit in limits.items())


@pytest.mark.parametrize("seed", [2**31 + 31, 2**31 + 32, 2**31 + 33])
def test_training_control_fails_and_program_passes(seed):
    kind = manifest.kind("train")
    m, cell = tiny.model(), tiny.cell(CELL)
    limits = cell["check"]["limits"]
    _, _, ours = kind.build(cell, m, seed, "cpu")
    ref = kind.reference_readings(cell, m, seed, "cpu")
    fp8 = kind.reference_readings(cell, m, seed, "cpu", quant="fp8")
    assert not _fails(kind.gaps(ours, ref), limits)
    assert _fails(kind.gaps(fp8, ref), limits)


@pytest.mark.gpu
def test_train_4k_control_fails_at_the_cell_size(card):
    """On the card at the cell's own size: one seed of the control."""
    cell = manifest.workload(CELL, manifest.manifest())
    out = subprocess.run([sys.executable, str(manifest.BENCH_DIR / "calibrate.py"),
                          "--workload", CELL, "--control-seeds", "3000000099"],
                         capture_output=True, text=True, cwd=manifest.ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert _fails(line["control_fp8"], cell["check"]["limits"])
