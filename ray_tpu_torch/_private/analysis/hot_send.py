"""Pass 4: direct conn sends on hot streaming paths.

The control-plane coalescing win (wire.BatchingConn — one physical write
per batch of reply/pub/done/refop/pdone/log frames) only holds while the
hot streaming modules route their sends through batching conns.  A future
PR adding `some_conn.send(...)` on one of these paths silently regresses
it back to one syscall + one receiver wakeup per frame — exactly the
steady-state cost PROFILE_r5.md measured.

This pass catalogs every `.send(...)` call on a conn-ish receiver inside
the hot modules.  Each existing site is a REVIEWED allowlist entry (most
are fine: the receiver is a BatchingConn at runtime, or a deliberately
unbatched handshake/one-shot conn); a NEW site fails the lint until the
author either routes it through the batching layer or justifies why this
send must bypass coalescing.

Keys carry module + enclosing scope + receiver (no line numbers), so
unrelated edits don't churn the allowlist.
"""

from __future__ import annotations

import ast
from typing import List

from ray_tpu_torch._private.analysis.common import (
    Violation,
    dotted_name,
    parse_file,
    terminal_name,
)

PASS = "hot-send"

# The hot streaming modules: every long-lived control conn they write to
# is (or feeds) a coalesced stream.  wire.py itself is the batching layer
# and pubsub.py holds no conns.
HOT_MODULES = frozenset(
    {
        "ray_tpu_torch/_private/runtime.py",
        "ray_tpu_torch/_private/worker_proc.py",
        "ray_tpu_torch/_private/node_daemon.py",
        "ray_tpu_torch/_private/peer.py",
        "ray_tpu_torch/_private/driver_client.py",
        # io-shard fabric: every owned conn and the head-ward ctl channel
        # are coalesced streams; an unbatched send here regresses the
        # whole slice of conns the shard owns.
        "ray_tpu_torch/_private/io_shard.py",
    }
)


def _conn_ish(expr: ast.AST) -> bool:
    t = terminal_name(expr)
    return bool(t) and "conn" in t.lower()


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

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self.scope.append(node.name)
        self.generic_visit(node)
        self.scope.pop()

    visit_AsyncFunctionDef = visit_FunctionDef  # type: ignore[assignment]

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        if (
            isinstance(func, ast.Attribute)
            and func.attr == "send"
            and _conn_ish(func.value)
        ):
            recv = dotted_name(func.value) or terminal_name(func.value) or "<conn>"
            key = f"{PASS}:{self.rel}:{self.qualname()}:{recv}.send"
            self.violations.append(
                Violation(
                    PASS,
                    self.rel,
                    node.lineno,
                    key,
                    f"{self.rel}:{node.lineno}: direct {recv}.send() on a hot "
                    f"streaming path ({self.qualname()}) — route through the "
                    "batching layer (wire.BatchingConn / an existing batched "
                    "sender) or justify bypassing coalescing in the allowlist",
                )
            )
        self.generic_visit(node)


def scan_file(path: str, rel: str) -> List[Violation]:
    if rel not in HOT_MODULES:
        return []
    tree = parse_file(path)
    if tree is None:
        return []
    s = _Scanner(rel)
    s.visit(tree)
    return s.violations
