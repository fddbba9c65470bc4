"""Shared plumbing for the concurrency analysis passes."""

from __future__ import annotations

import ast
import os
import re
from typing import Iterable, List, Optional, Tuple

# A `with` item (or acquire()/release() receiver) counts as a lock when its
# terminal name looks lock-ish.  Conditions constructed around a lock keep
# "lock" out of their names in this codebase (_available, _not_empty), so
# condition-wait idioms don't register as lock regions.
_LOCKISH = re.compile(r"lock|mutex", re.IGNORECASE)

# Dedicated wire-serialization locks: their entire purpose is wrapping one
# send/recv so concurrent frames don't interleave on a shared connection.
# A send under ONLY such a lock is the idiom working as designed, not a
# blocking-under-lock hazard (it still participates in lock-order).
IO_SERIALIZATION_LOCKS = frozenset(
    {"send_lock", "_send_lock", "conn_lock", "_conn_lock"}
)


class Violation:
    """One finding.  `key` is the stable allowlist identity: it contains
    no line numbers, so unrelated edits don't churn the allowlist."""

    __slots__ = ("pass_name", "rel", "line", "key", "message")

    def __init__(self, pass_name: str, rel: str, line: int, key: str, message: str):
        self.pass_name = pass_name
        self.rel = rel
        self.line = line
        self.key = key
        self.message = message

    def __repr__(self) -> str:
        return f"<Violation {self.key} @{self.rel}:{self.line}>"


def iter_py_files(root: str) -> List[Tuple[str, str]]:
    """(abspath, display-relpath) for every .py under root (or root itself).

    The display path is relative to root's PARENT (so scanning `ray_tpu_torch/`
    yields `ray_tpu_torch/_private/store.py`) — allowlist keys stay stable no
    matter the CWD the lint runs from."""
    root = os.path.abspath(root)
    parent = os.path.dirname(root)
    out: List[Tuple[str, str]] = []
    if os.path.isfile(root):
        return [(root, os.path.relpath(root, parent).replace(os.sep, "/"))]
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                p = os.path.join(dirpath, fn)
                out.append((p, os.path.relpath(p, parent).replace(os.sep, "/")))
    return out


def parse_file(path: str) -> Optional[ast.Module]:
    try:
        with open(path, "r", encoding="utf-8") as f:
            return ast.parse(f.read(), filename=path)
    except (OSError, SyntaxError):
        return None


def dotted_name(expr: ast.AST) -> Optional[str]:
    """`self.state.lock` -> "self.state.lock"; None for non-name chains."""
    parts: List[str] = []
    node = expr
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def terminal_name(expr: ast.AST) -> Optional[str]:
    if isinstance(expr, ast.Attribute):
        return expr.attr
    if isinstance(expr, ast.Name):
        return expr.id
    return None


def is_lockish(expr: ast.AST) -> bool:
    t = terminal_name(expr)
    return bool(t) and bool(_LOCKISH.search(t))


def call_repr(call: ast.Call) -> str:
    name = dotted_name(call.func)
    if name is None:
        t = terminal_name(call.func)
        name = f"...{t}" if t else "<call>"
    return name
