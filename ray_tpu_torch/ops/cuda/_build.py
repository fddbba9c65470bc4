"""Build the port's CUDA sources into shared libraries at first use.

Each library is compiled by `nvcc` from sources in this checkout into
`ray_tpu_torch/_build/` (git-ignored), named by a hash of its sources, the
shared headers (`csrc/*.cuh`) and the flags, so a changed source rebuilds and
an unchanged one is reused. Different libraries build in parallel when
loaded from several threads. The libraries expose a plain C interface and
are loaded with `ctypes`. Each successful kernel launch adds one to the
counter `cuda_kernel_launches`, tagged by the kernel's C entry point.
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
from typing import Any, Dict, Sequence

from ray_tpu_torch.util import tracing
from ray_tpu_torch.util.metrics import Counter

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
# One record per library loaded in this process: the file loaded (`path`),
# what the compiler printed for it (`log`, kept beside the library and read
# again when it is reused), whether nvcc built it here (`built`), the
# compile's seconds (`compile_s`, 0.0 when it was found built) and the whole
# load's (`load_s`, the compile included).
loads: Dict[str, Dict[str, Any]] = {}
# Successful launches in this process, by the C entry point launched. It only
# goes up: a reader takes `launch_counts()` before the work and subtracts.
kernel_launches = Counter("cuda_kernel_launches", "kernel launches, by C entry point",
                          tag_keys=("kernel",))


def launch_counts() -> Dict[str, int]:
    """Launches of each kernel entry point in this process so far."""
    return {dict(tags)["kernel"]: int(n) for tags, n in kernel_launches.snapshot().items()}


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
    if that file does not exist yet, then load it. The first load in the
    process is the span `cuda::load_library` (attrs `name`, `built`) and
    leaves its record in `loads`."""
    with _lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if name in _loaded:
            return _loaded[name]
        t0 = time.perf_counter()
        paths = [CSRC_DIR / s for s in sources]
        digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for p in paths + sorted(CSRC_DIR.glob("*.cuh")):
            digest.update(p.name.encode())
            digest.update(p.read_bytes())
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        target = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
        log = target.with_suffix(".log")
        built, compile_s = not target.exists(), 0.0
        with tracing.span("cuda::load_library", attrs={"name": name, "built": built}):
            if built:
                t1 = time.perf_counter()
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
                # The log before the library, whose file marks it built; the
                # rename is atomic, so a reader never sees half a library.
                log.write_text(proc.stdout + proc.stderr)
                os.replace(tmp, target)
                compile_s = time.perf_counter() - t1
            lib = ctypes.CDLL(str(target))
        _loaded[name] = lib
        loads[name] = {"path": str(target), "log": str(log), "built": built,
                       "compile_s": compile_s, "load_s": time.perf_counter() - t0}
        return lib
