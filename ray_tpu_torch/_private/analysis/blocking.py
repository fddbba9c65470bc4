"""Pass 1: blocking calls made while a lock is held.

Flags calls from a catalog of blocking operations (sleep, socket/pipe
recv+send, Future.result, subprocess, ray_tpu_torch.get/wait, faults.point —
any injection point can carry a delay action) that occur LEXICALLY inside
a `with <lock>` body or between explicit lock.acquire()/lock.release()
statements.  The spill freed-race delete (PR 1) and the relayed-actor
requeue both had this shape; each cost a minutes-scale chaos soak to
surface, and this pass turns the shape into a pre-commit failure.

Scope rules:
  * nested function/lambda bodies reset the held-lock context (a closure
    defined under a lock runs later, not under it);
  * a send/recv wrapped ONLY by a dedicated wire-serialization lock
    (send_lock/conn_lock — see common.IO_SERIALIZATION_LOCKS) is the
    serialization idiom working as designed, and exempt;
  * `cond.wait()` on the held lock — or on a Condition CONSTRUCTED from
    the held lock (`self.c = threading.Condition(self.lock)` is resolved
    by a pre-scan) — is the condition idiom (wait releases the lock while
    blocked), and exempt;
  * `.wait(timeout=0)` is a poll, not a block, and exempt.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Tuple

from ray_tpu_torch._private.analysis.common import (
    IO_SERIALIZATION_LOCKS,
    Violation,
    call_repr,
    dotted_name,
    is_lockish,
    parse_file,
    terminal_name,
)

PASS = "blocking-under-lock"

# Attribute calls that block (or can block) the calling thread.
_BLOCKING_ATTRS = frozenset(
    {
        "sleep",
        "recv",
        "recv_into",
        "recv_bytes",
        "recv_bytes_into",
        "readline",
        "readexactly",
        "accept",
        "result",
        "communicate",
        "send",
        "sendall",
        "send_bytes",
        "connect",
    }
)
_SEND_RECV_ATTRS = frozenset(
    {"send", "sendall", "send_bytes", "recv", "recv_into", "recv_bytes",
     "recv_bytes_into"}
)
_SUBPROCESS_FUNCS = frozenset({"Popen", "run", "call", "check_call", "check_output"})
# Receivers whose EVERY method is disk/network I/O (the pluggable spill
# backend may be an fsspec URI — a network call under the store lock
# stalls every store operation: the exact PR 1 soak-found bug shape).
_IO_RECEIVER_TERMS = frozenset({"_spill_storage", "spill_storage"})


def _is_zero_timeout(call: ast.Call) -> bool:
    for kw in call.keywords:
        if kw.arg == "timeout" and isinstance(kw.value, ast.Constant):
            return kw.value.value == 0
    # positional timeout=0 (e.g. wait([...], n, 0))
    for a in call.args:
        if isinstance(a, ast.Constant) and a.value == 0:
            return True
    return False


def _blocking_reason(
    call: ast.Call,
    held: List[Tuple[str, str]],
    cond_aliases: dict,
) -> Optional[str]:
    """Why this call blocks, or None when it is not in the catalog (or an
    exempt idiom).  `held` is [(full_name, terminal)] innermost-last;
    cond_aliases maps condition attrs to the lock they wrap."""
    func = call.func
    dotted = dotted_name(func)
    if isinstance(func, ast.Attribute):
        attr = func.attr
        recv_term = terminal_name(func.value)
        if dotted in ("faults.point", "_faults.point") or (
            attr == "point" and recv_term in ("faults", "_faults")
        ):
            return "fault-injection point (delay/crash-capable)"
        if dotted is not None and dotted.startswith("subprocess.") and attr in _SUBPROCESS_FUNCS:
            return "subprocess spawn/wait"
        if attr == "get" and isinstance(func.value, ast.Name) and func.value.id == "ray_tpu_torch":
            return "blocking ray_tpu_torch.get"
        if attr == "request":
            return "blocking control-plane request"
        if recv_term in _IO_RECEIVER_TERMS:
            return "spill-storage I/O (may be a network backend)"
        if attr == "spill" and recv_term == "self":
            return "spill I/O"
        if attr == "wait":
            if _is_zero_timeout(call):
                return None  # a poll, not a block
            recv_full = dotted_name(func.value)
            recv_full = cond_aliases.get(recv_full, recv_full)
            if recv_full is not None and any(full == recv_full for full, _t in held):
                return None  # condition-wait on the held lock releases it
            return "blocking wait"
        if attr in _BLOCKING_ATTRS:
            if attr in _SEND_RECV_ATTRS and held and all(
                t in IO_SERIALIZATION_LOCKS for _f, t in held
            ):
                return None  # the wire-serialization-lock idiom
            return f"blocking .{attr}()"
    elif isinstance(func, ast.Name):
        if func.id == "sleep":
            return "blocking sleep"
    return None


def _collect_condition_aliases(tree: ast.Module) -> dict:
    """`self.c = threading.Condition(self.lock)` (or module-level
    `c = threading.Condition(lock)`) -> {"self.c": "self.lock", ...}.
    One module-wide map: attr names are unique enough in practice, and a
    false alias merely suppresses a wait-under-lock finding for the
    condition idiom it exists to recognize."""
    aliases: dict = {}
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Assign) and isinstance(node.value, ast.Call)):
            continue
        callee = dotted_name(node.value.func)
        if callee not in ("threading.Condition", "Condition"):
            continue
        if not node.value.args:
            continue
        wrapped = dotted_name(node.value.args[0])
        if wrapped is None:
            continue
        for target in node.targets:
            t = dotted_name(target)
            if t is not None:
                aliases[t] = wrapped
    return aliases


class _Scanner:
    def __init__(self, rel: str, cond_aliases: dict):
        self.rel = rel
        self.cond_aliases = cond_aliases
        self.violations: List[Violation] = []
        self.scope: List[str] = []  # class/function names
        self.held: List[Tuple[str, str]] = []  # (full, terminal), innermost last

    # -- scope plumbing ------------------------------------------------------

    def qualname(self) -> str:
        return ".".join(self.scope) or "<module>"

    def scan_module(self, tree: ast.Module) -> None:
        self._body(tree.body)

    # -- statement walking ---------------------------------------------------

    def _body(self, stmts: List[ast.stmt]) -> None:
        """Walk one statement list, tracking explicit acquire()/release()
        pairs at this nesting level (lexical region = acquire stmt ..
        release stmt, or end of the list when release is missing)."""
        explicit: List[str] = []  # full names acquired in this list
        for stmt in stmts:
            kind, lock = self._acquire_release_stmt(stmt)
            if kind == "acquire":
                self.held.append(lock)
                explicit.append(lock[0])
                continue
            if kind == "release":
                if explicit and explicit[-1] == lock[0]:
                    explicit.pop()
                    self.held.pop()
                continue
            self._stmt(stmt)
        for _ in explicit:  # unbalanced acquire: region ran to end of list
            self.held.pop()

    def _acquire_release_stmt(self, stmt: ast.stmt):
        if not isinstance(stmt, ast.Expr) or not isinstance(stmt.value, ast.Call):
            return None, None
        func = stmt.value.func
        if not isinstance(func, ast.Attribute) or func.attr not in ("acquire", "release"):
            return None, None
        if not is_lockish(func.value):
            return None, None
        full = dotted_name(func.value) or terminal_name(func.value) or "<lock>"
        return func.attr, (full, terminal_name(func.value) or full)

    def _stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self._nested_function(stmt)
            return
        if isinstance(stmt, ast.ClassDef):
            self.scope.append(stmt.name)
            saved, self.held = self.held, []
            self._body(stmt.body)
            self.held = saved
            self.scope.pop()
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            self._with(stmt)
            return
        # Generic statement: check expressions, then walk nested bodies.
        for expr in self._stmt_exprs(stmt):
            self._expr(expr)
        for name in ("body", "orelse", "finalbody"):
            sub = getattr(stmt, name, None)
            if sub:
                self._body(sub)
        for handler in getattr(stmt, "handlers", ()):
            self._body(handler.body)

    def _stmt_exprs(self, stmt: ast.stmt):
        for field, value in ast.iter_fields(stmt):
            if field in ("body", "orelse", "finalbody", "handlers"):
                continue
            if isinstance(value, ast.expr):
                yield value
            elif isinstance(value, list):
                for v in value:
                    if isinstance(v, ast.expr):
                        yield v

    def _with(self, stmt) -> None:
        pushed = 0
        for item in stmt.items:
            self._expr(item.context_expr)  # evaluated before the acquire
            if is_lockish(item.context_expr):
                full = dotted_name(item.context_expr) or terminal_name(
                    item.context_expr
                ) or "<lock>"
                term = terminal_name(item.context_expr) or full
                self.held.append((full, term))
                pushed += 1
        self._body(stmt.body)
        for _ in range(pushed):
            self.held.pop()

    def _nested_function(self, stmt) -> None:
        self.scope.append(stmt.name)
        saved, self.held = self.held, []  # closures run later, not under the lock
        self._body(stmt.body)
        self.held = saved
        self.scope.pop()

    # -- expression walking --------------------------------------------------

    def _expr(self, expr: ast.expr) -> None:
        stack: List[ast.AST] = [expr]
        while stack:
            node = stack.pop()
            if isinstance(node, ast.Lambda):
                continue  # lambda body runs later, not under the lock
            if isinstance(node, ast.Call):
                self._check_call(node)
            stack.extend(ast.iter_child_nodes(node))

    def _check_call(self, call: ast.Call) -> None:
        if not self.held:
            return
        reason = _blocking_reason(call, self.held, self.cond_aliases)
        if reason is None:
            return
        lock_full, lock_term = self.held[-1]
        name = call_repr(call)
        key = f"{PASS}:{self.rel}:{self.qualname()}:{lock_term}:{name}"
        self.violations.append(
            Violation(
                PASS,
                self.rel,
                call.lineno,
                key,
                f"{self.rel}:{call.lineno}: {reason} — {name}() called while "
                f"holding `{lock_full}` in {self.qualname()}",
            )
        )


def scan_file(path: str, rel: str) -> List[Violation]:
    tree = parse_file(path)
    if tree is None:
        return []
    s = _Scanner(rel, _collect_condition_aliases(tree))
    s.scan_module(tree)
    return s.violations
