"""The kernel builder (`ray_tpu_torch/ops/cuda/_build.py`) on the CPU, with a
stand-in for nvcc: what the compiler printed (ptxas registers, shared memory
and spills, which `chip_smoke.py` checks) stays readable when a later
process finds the library already built and compiles nothing, and each
library's first load in a process is one record and, with tracing on, one
span; a kernel launch is one count of the loader's counter."""

import os
import sys
import types
from pathlib import Path

import pytest

from ray_tpu_torch.ops.cuda import _build
from ray_tpu_torch.util import metrics, tracing


@pytest.fixture
def nvcc(tmp_path, monkeypatch):
    """A source `k.cu`, an empty build directory and a stand-in nvcc that
    writes the library and prints a ptxas line; libraries load as their
    path."""
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
    for table in ("_loaded", "loads"):
        monkeypatch.setattr(_build, table, {})
    return nvcc


def test_compiler_output_is_kept_beside_the_library(nvcc):
    first = _build.load_library("k", ["k.cu"])
    rec = _build.loads["k"]
    assert rec["built"] and rec["path"] == first
    assert 0.0 < rec["compile_s"] <= rec["load_s"]
    assert "Used 42 registers" in Path(rec["log"]).read_text()

    # A later process: the library is found built and nvcc must not run.
    _build._loaded.clear()
    nvcc.write_text("#!/bin/sh\nexit 1\n")
    assert _build.load_library("k", ["k.cu"]) == first
    rec = _build.loads["k"]
    assert not rec["built"] and rec["compile_s"] == 0.0 and rec["load_s"] > 0.0
    assert rec["path"] == first
    assert "Used 42 registers" in Path(rec["log"]).read_text()


def test_a_first_load_is_one_span(nvcc):
    """One `cuda::load_library` span per first load, saying whether nvcc
    built the library; a call for a library already loaded opens none."""
    tracing.drain_spans()
    tracing.enable_tracing()
    try:
        _build.load_library("k", ["k.cu"])
        compile_s = _build.loads["k"]["compile_s"]
        _build.load_library("k", ["k.cu"])  # loaded: no span
        _build._loaded.clear()  # a later process: found built
        _build.load_library("k", ["k.cu"])
        spans = tracing.drain_spans()
    finally:
        tracing.disable_tracing()
    assert [(s["name"], s["attrs"]) for s in spans] == [
        ("cuda::load_library", {"name": "k", "built": True}),
        ("cuda::load_library", {"name": "k", "built": False}),
    ]
    assert spans[0]["end"] - spans[0]["start"] >= compile_s > 0.0


def test_launches_are_one_counter_read_by_entry_point():
    """A launch is one `inc` of the counter `cuda_kernel_launches`, tagged
    by the kernel's C entry point: `launch_counts()` reads each series by
    that name, the other series stay as they were, and the series is in
    `util.metrics.collect()`, whose deltas the benchmark reads."""
    before = _build.launch_counts()
    for _ in range(3):
        _build.kernel_launches.inc(tags={"kernel": "a_test_entry_point"})
    after = _build.launch_counts()
    assert after.pop("a_test_entry_point") - before.pop("a_test_entry_point", 0) == 3
    assert after == before
    rec = metrics.collect()["cuda_kernel_launches"]
    assert rec["type"] == "Counter"
    assert rec["data"][(("kernel", "a_test_entry_point"),)] >= 3


# What ptxas prints of one kernel (-Xptxas -v), the nvcc stand-in below
# printing it for every kernel a source names, and the SASS line of a
# wgmma that cuobjdump shows.
PTXAS = ("ptxas info    : Compiling entry function '{sym}' for 'sm_90a'\n"
         "ptxas info    : Function properties for {sym}\n"
         "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
         "ptxas info    : Used 168 registers, 64 bytes smem, 400 bytes cmem[0]\n")
HGMMA = "        /*0100*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ ;\n"


@pytest.mark.parametrize("found_built", [False, True], ids=["built", "found_built"])
def test_chip_smoke_reads_the_load_records(nvcc, tmp_path, monkeypatch, found_built):
    """chip_smoke.py's phase 1 (`build_kernels`) reads each library's
    record: nvcc's seconds (`kernel_builds`, the `build_s` that the replica,
    the cluster job and the cluster batch report), ptxas's registers,
    shared memory and spills from the log beside the library, and the
    tensor-core instructions in the SASS of the library file loaded, for
    the attention kernels at both head dims, the clip + AdamW kernel in f32
    and bf16 and the RMSNorm kernels at each pair of types and vector count
    (labels read from templates of several arguments); a later process that
    finds the libraries built reports the same."""
    import chip_smoke
    from ray_tpu_torch.ops.cuda import adamw
    from ray_tpu_torch.ops.cuda import flash_attention as flash
    from ray_tpu_torch.ops.cuda import rms_norm

    # Each source's kernels and the mangled template arguments of each of
    # their instantiations, one line a kernel.
    dims = ("Li64", "Li128")
    floats = ("13__nv_bfloat16", "f")
    # <bf16, bf16, V> mangles its second bf16 as a substitution, S1_.
    norm = tuple(f"{types}Li{v}E" for types in ("13__nv_bfloat16S1_", "13__nv_bfloat16f",
                                                 "f13__nv_bfloat16", "ff") for v in (1, 2))
    kernels = {flash.SOURCE: {"fwd_wgmma_kernel": dims},
               flash.BWD_SOURCE: {"dq_wgmma_kernel": dims, "dkv_wgmma_kernel": dims},
               adamw.SOURCE: {"adamw_kernel": ("f", "13__nv_bfloat16")},
               rms_norm.SOURCE: {"rms_norm_fwd_kernel": norm, "rms_norm_bwd_kernel": norm,
                                 "rms_norm_dw_kernel": floats}}
    for source, names in kernels.items():
        (_build.CSRC_DIR / source).write_text(
            "".join(f"{n} {' '.join(args)}\n" for n, args in names.items()))
    stand_in = (
        f"#!{sys.executable}\n"
        "import sys\n"
        f"PTXAS = {PTXAS!r}\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "syms = [f'_Z{len(n)}{n}I{a}EEvv' for src in sys.argv if src.endswith('.cu')\n"
        "        for n, *args in map(str.split, open(src)) for a in args]\n"
        "open(out, 'w').write(''.join(s + '\\n' for s in syms))\n"
        "sys.stderr.write(''.join(PTXAS.format(sym=s) for s in syms))\n"
    )
    nvcc.write_text(stand_in)
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    cuobjdump = bin_dir / "cuobjdump"
    cuobjdump.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        f"HGMMA = {HGMMA!r}\n"
        "for sym in open(sys.argv[2]).read().split():\n"
        "    print(f'\\t\\tFunction : {sym}')\n"
        "    print(HGMMA, end='')\n"
    )
    cuobjdump.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bin_dir}:{os.environ['PATH']}")
    smem = {"flash_attn_fwd_smem_bytes": lambda d: 1000 * d,
            "flash_attn_bwd_dq_smem_bytes": lambda d: 2000 * d,
            "flash_attn_bwd_dkv_smem_bytes": lambda d: 3000 * d}
    monkeypatch.setattr(_build.ctypes, "CDLL",
                        lambda path: types.SimpleNamespace(path=path, **smem))

    report = chip_smoke.build_kernels()
    if found_built:
        _build._loaded.clear()  # a later process: nvcc must not run
        _build.loads.clear()
        nvcc.write_text("#!/bin/sh\nexit 1\n")
        assert chip_smoke.build_kernels() == report

    builds = chip_smoke.kernel_builds()
    assert set(builds) == set(chip_smoke.LIBRARIES)
    assert all((s == 0.0) if found_built else (s > 0.0) for s in builds.values())
    labels = ({f"{n}<{d}>" for n in chip_smoke.KERNEL_MARKERS.values() for d in (64, 128)}
              | set(chip_smoke.ADAMW_LABELS) | set(chip_smoke.NORM_LABELS))
    assert set(report["ptxas"]) == set(report["sass"]) == labels
    for d in (64, 128):
        assert report["ptxas"][f"fwd_wgmma_kernel<{d}>"] == {
            "spill_stores": 0, "spill_loads": 0, "registers": 168, "static_smem": 64,
            "dynamic_smem": 1000 * d}
    assert report["ptxas"]["dkv_wgmma_kernel<128>"]["dynamic_smem"] == 3000 * 128
    assert all(v == {"HGMMA": 1, "HMMA": 0} for v in report["sass"].values())
