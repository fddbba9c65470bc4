"""Pass 9: bytes-per-copy counter coverage of the object plane.

The bytes-per-copy counters (telemetry.count_copy — object_copies /
object_copy_bytes{path=put|seal|pull|relay|spill|restore|promote|
arena_map}) are the object plane's HONESTY CHECK: ray_perf and the tier-1
broadcast tests assert "exactly one sealed copy per receiving node" off
their deltas.  That claim only holds while every byte-moving path in the
store / transfer-plane / arena modules ticks the counters — a future PR
adding a new transfer or staging path that skips count_copy silently
un-counts real copies, and the one-copy proofs keep passing while the
system does more work than they attest.

This pass catalogs every function in the object-plane modules that MOVES
BYTES — calls to recv_into / pack_into / os.write / sendfile /
copyfileobj, or a slice-assignment into a buffer (`view[a:b] = ...`, the
mmap/memoryview fill idiom) — and requires each to either call
telemetry.count_copy itself or be a REVIEWED allowlist entry whose
justification names the site that counts it (usually the single
fetch-side or OwnerStore-level counter).  Keys carry module + enclosing
function only, so unrelated edits don't churn the allowlist.
"""

from __future__ import annotations

import ast
from typing import List

from ray_tpu_torch._private.analysis.common import (
    Violation,
    parse_file,
    terminal_name,
)

PASS = "copy-coverage"

# The object-plane modules: every byte a user object moves through the
# runtime moves through one of these files.
COPY_MODULES = frozenset(
    {
        "ray_tpu_torch/_private/store.py",
        "ray_tpu_torch/_private/object_plane.py",
        "ray_tpu_torch/_private/spill_storage.py",
        "ray_tpu_torch/_native/arena.py",
    }
)

# Call attributes that move object bytes when invoked on anything.
_MOVER_ATTRS = frozenset(
    {"recv_into", "pack_into", "sendfile", "copyfileobj", "readinto"}
)


def _is_mover_call(node: ast.Call) -> bool:
    func = node.func
    if isinstance(func, ast.Attribute):
        if func.attr in _MOVER_ATTRS:
            # struct.pack_into writes fixed-width header METADATA (board
            # watermarks), not object bytes.
            return not (
                func.attr == "pack_into"
                and terminal_name(func.value) == "struct"
            )
        # os.write(fd, buf) — the transfer plane's send syscall.
        if func.attr == "write" and terminal_name(func.value) == "os":
            return True
    elif isinstance(func, ast.Name) and func.id in ("pack_into",):
        return True
    return False


def _is_buffer_fill(node: ast.Assign) -> bool:
    """`view[a:b] = data` — the mmap/memoryview fill idiom (arena slot or
    tmpfs segment writes).  Plain index stores (`d[k] = v`) don't match:
    only slice targets."""
    for tgt in node.targets:
        if isinstance(tgt, ast.Subscript) and isinstance(tgt.slice, ast.Slice):
            return True
    return False


def _counts_copies(fn: ast.AST) -> bool:
    for sub in ast.walk(fn):
        if isinstance(sub, ast.Call):
            f = sub.func
            if isinstance(f, ast.Attribute) and f.attr == "count_copy":
                return True
            if isinstance(f, ast.Name) and f.id == "count_copy":
                return True
    return False


class _Scanner(ast.NodeVisitor):
    def __init__(self, rel: str):
        self.rel = rel
        self.scope: List[str] = []
        self.violations: List[Violation] = []

    def qualname(self) -> str:
        return ".".join(self.scope) or "<module>"

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.scope.append(node.name)
        self.generic_visit(node)
        self.scope.pop()

    def _visit_fn(self, node) -> None:
        self.scope.append(node.name)
        # Walk this function's OWN body only (nested defs get their own
        # verdicts — double-charging the parent would churn two allowlist
        # entries per site).
        moves = False
        stack = list(ast.iter_child_nodes(node))
        while stack:
            sub = stack.pop()
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if isinstance(sub, ast.Call) and _is_mover_call(sub):
                moves = True
            elif isinstance(sub, ast.Assign) and _is_buffer_fill(sub):
                moves = True
            stack.extend(ast.iter_child_nodes(sub))
        if moves and not _counts_copies(node):
            key = f"{PASS}:{self.rel}:{self.qualname()}"
            self.violations.append(
                Violation(
                    PASS,
                    self.rel,
                    node.lineno,
                    key,
                    f"{self.rel}:{node.lineno}: {self.qualname()} moves "
                    "object bytes (recv_into/pack_into/os.write/buffer "
                    "fill) without ticking telemetry.count_copy — tick "
                    "the bytes-per-copy counters here, or allowlist with "
                    "a justification naming the site that counts this "
                    "path",
                )
            )
        self.generic_visit(node)
        self.scope.pop()

    visit_FunctionDef = _visit_fn  # type: ignore[assignment]
    visit_AsyncFunctionDef = _visit_fn  # type: ignore[assignment]


def scan_file(path: str, rel: str) -> List[Violation]:
    if rel not in COPY_MODULES:
        return []
    tree = parse_file(path)
    if tree is None:
        return []
    s = _Scanner(rel)
    s.visit(tree)
    return s.violations
