"""Build the port's CUDA sources into shared libraries at first use.

Each library is compiled by `nvcc` from sources in this checkout into
`ray_tpu_torch/_build/` (git-ignored), named by a hash of its sources, the
shared headers (`csrc/*.cuh`) and the flags, so a changed source rebuilds and
an unchanged one is reused. Different libraries build in parallel when
loaded from several threads. The libraries expose a plain C interface and
are loaded with `ctypes`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills per kernel
)

_lock = threading.Lock()  # guards _locks
_locks: Dict[str, threading.Lock] = {}  # one per library
_loaded: Dict[str, ctypes.CDLL] = {}
# Seconds each library took to compile in this process (0.0 when it was
# found already built), what the compiler printed (kept beside the library
# as lib<name>-<hash>.log, and read back when the library is reused), and
# the file loaded.
build_seconds: Dict[str, float] = {}
build_logs: Dict[str, str] = {}
library_paths: Dict[str, Path] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin); the CUDA "
        "kernels are built on the machine that has the card"
    )


def load_library(name: str, sources: Sequence[str]) -> ctypes.CDLL:
    """Compile `sources` (file names under csrc/) into lib<name>-<hash>.so
    if that file does not exist yet, then load it."""
    with _lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if name in _loaded:
            return _loaded[name]
        paths = [CSRC_DIR / s for s in sources]
        digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for p in paths + sorted(CSRC_DIR.glob("*.cuh")):
            digest.update(p.name.encode())
            digest.update(p.read_bytes())
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        target = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
        log = target.with_suffix(".log")
        build_seconds[name] = 0.0
        build_logs[name] = log.read_text() if log.exists() else ""
        if not target.exists():
            t0 = time.perf_counter()
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, paths)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(
                    f"nvcc failed building {name} ({proc.returncode}):\n"
                    f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
                )
            build_logs[name] = proc.stdout + proc.stderr
            log.write_text(build_logs[name])  # before the library, which marks it built
            os.replace(tmp, target)  # atomic: a reader never sees half a file
            build_seconds[name] = time.perf_counter() - t0
        lib = ctypes.CDLL(str(target))
        _loaded[name] = lib
        library_paths[name] = target
        return lib
