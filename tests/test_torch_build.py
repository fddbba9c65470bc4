"""The kernel builder (`ray_tpu_torch/ops/cuda/_build.py`) on the CPU, with a
stand-in for nvcc: what the compiler printed (ptxas registers, shared memory
and spills, which `chip_smoke.py` checks) stays readable when a later
process finds the library already built and compiles nothing."""

import sys

from ray_tpu_torch.ops.cuda import _build


def test_compiler_output_is_kept_beside_the_library(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// a kernel\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        "open(sys.argv[sys.argv.index('-o') + 1], 'w').write('library')\n"
        "print('ptxas info    : Used 42 registers', file=sys.stderr)\n"
    )
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: path)
    for table in ("_loaded", "build_seconds", "build_logs", "library_paths"):
        monkeypatch.setattr(_build, table, {})

    first = _build.load_library("k", ["k.cu"])
    assert "Used 42 registers" in _build.build_logs["k"]
    assert _build.build_seconds["k"] > 0.0

    # A later process: the library is found built and nvcc must not run.
    _build._loaded.clear()
    nvcc.write_text("#!/bin/sh\nexit 1\n")
    assert _build.load_library("k", ["k.cu"]) == first
    assert _build.build_seconds["k"] == 0.0
    assert "Used 42 registers" in _build.build_logs["k"]
    assert str(_build.library_paths["k"]) == first
