"""Pass 2: lock-acquisition order graph + deadlock-inversion cycles.

Builds a per-module directed graph over lock identities: an edge A -> B
means "B was acquired while A was held" — from lexically nested `with`
statements, and from call edges (a function called with A held acquires B,
directly or transitively through same-module callees).  A cycle in that
graph is a potential ABBA deadlock: two threads entering it from
different nodes can each hold the lock the other wants (the runtime.py
`self.lock -> state.lock` comment documents exactly this invariant by
hand; this pass checks every module's invariants mechanically).

Lock identity is textual, scoped to the module: `self.X` inside class C
becomes "C.X"; other dotted names keep their (self-stripped) spelling.
Re-acquisition of the same identity (RLock re-entry) never makes an edge.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from ray_tpu_torch._private.analysis.common import (
    Violation,
    dotted_name,
    is_lockish,
    parse_file,
    terminal_name,
)

PASS = "lock-order"


def _lock_id(expr: ast.AST, cls: Optional[str]) -> Optional[str]:
    full = dotted_name(expr)
    if full is None:
        full = terminal_name(expr)
        if full is None:
            return None
    if full == "self" or full.startswith("self."):
        rest = full[5:] or terminal_name(expr) or "lock"
        return f"{cls}.{rest}" if cls else rest
    return full


class _FuncInfo:
    __slots__ = ("qualname", "cls", "acquired", "nested_edges", "calls_under", "callees")

    def __init__(self, qualname: str, cls: Optional[str]):
        self.qualname = qualname
        self.cls = cls
        self.acquired: Set[str] = set()  # locks acquired anywhere in body
        # (held_lock, acquired_lock, line) from lexical nesting
        self.nested_edges: List[Tuple[str, str, int]] = []
        # (held_locks_tuple, callee_key, line) for calls made under a lock
        self.calls_under: List[Tuple[Tuple[str, ...], Tuple[str, str], int]] = []
        self.callees: Set[Tuple[str, str]] = set()  # every same-module call


class _Collector:
    """One pass over a module: per-function acquisition facts."""

    def __init__(self):
        self.funcs: Dict[Tuple[str, str], _FuncInfo] = {}  # (cls or "", name)

    def collect(self, tree: ast.Module) -> None:
        for stmt in tree.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._function(stmt, None)
            elif isinstance(stmt, ast.ClassDef):
                for sub in stmt.body:
                    if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        self._function(sub, stmt.name)

    def _function(self, fn, cls: Optional[str]) -> None:
        qual = f"{cls}.{fn.name}" if cls else fn.name
        info = _FuncInfo(qual, cls)
        self.funcs[(cls or "", fn.name)] = info
        self._body(fn.body, cls, info, [])

    def _body(self, stmts, cls, info: _FuncInfo, held: List[str]) -> None:
        explicit = 0
        for stmt in stmts:
            lock = self._acquire_stmt(stmt, cls)
            if lock is not None:
                self._acquire(lock, cls, info, held, stmt.lineno)
                held.append(lock)
                explicit += 1
                continue
            if self._release_stmt(stmt, cls, held):
                held.pop()
                explicit -= 1
                continue
            self._stmt(stmt, cls, info, held)
        for _ in range(max(explicit, 0)):
            held.pop()

    def _acquire_stmt(self, stmt, cls) -> Optional[str]:
        call = self._lock_method_call(stmt, "acquire")
        return _lock_id(call.func.value, cls) if call is not None else None

    def _release_stmt(self, stmt, cls, held: List[str]) -> bool:
        call = self._lock_method_call(stmt, "release")
        if call is None:
            return False
        lid = _lock_id(call.func.value, cls)
        return bool(held) and held[-1] == lid

    @staticmethod
    def _lock_method_call(stmt, name: str) -> Optional[ast.Call]:
        if (
            isinstance(stmt, ast.Expr)
            and isinstance(stmt.value, ast.Call)
            and isinstance(stmt.value.func, ast.Attribute)
            and stmt.value.func.attr == name
            and is_lockish(stmt.value.func.value)
        ):
            return stmt.value
        return None

    def _acquire(self, lock: str, cls, info: _FuncInfo, held: List[str], line: int) -> None:
        info.acquired.add(lock)
        for h in held:
            if h != lock:
                info.nested_edges.append((h, lock, line))

    def _stmt(self, stmt, cls, info: _FuncInfo, held: List[str]) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            return  # nested defs execute later; closures analyzed separately
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            pushed = 0
            for item in stmt.items:
                self._exprs(item.context_expr, cls, info, held)
                lid = _lock_id(item.context_expr, cls) if is_lockish(item.context_expr) else None
                if lid is not None:
                    self._acquire(lid, cls, info, held, stmt.lineno)
                    held.append(lid)
                    pushed += 1
            self._body(stmt.body, cls, info, held)
            for _ in range(pushed):
                held.pop()
            return
        for field, value in ast.iter_fields(stmt):
            if field in ("body", "orelse", "finalbody"):
                continue
            if isinstance(value, ast.expr):
                self._exprs(value, cls, info, held)
            elif isinstance(value, list):
                for v in value:
                    if isinstance(v, ast.expr):
                        self._exprs(v, cls, info, held)
        for name in ("body", "orelse", "finalbody"):
            sub = getattr(stmt, name, None)
            if sub:
                self._body(sub, cls, info, held)
        for handler in getattr(stmt, "handlers", ()):
            self._body(handler.body, cls, info, held)

    def _exprs(self, expr: ast.expr, cls, info: _FuncInfo, held: List[str]) -> None:
        stack: List[ast.AST] = [expr]
        while stack:
            node = stack.pop()
            if isinstance(node, ast.Lambda):
                continue
            if isinstance(node, ast.Call):
                callee = self._callee_key(node, cls)
                if callee is not None:
                    info.callees.add(callee)
                    if held:
                        info.calls_under.append((tuple(held), callee, node.lineno))
            stack.extend(ast.iter_child_nodes(node))

    @staticmethod
    def _callee_key(call: ast.Call, cls) -> Optional[Tuple[str, str]]:
        func = call.func
        if isinstance(func, ast.Name):
            return ("", func.id)
        if (
            isinstance(func, ast.Attribute)
            and isinstance(func.value, ast.Name)
            and func.value.id == "self"
            and cls
        ):
            return (cls, func.attr)
        return None


def _transitive_acquired(funcs: Dict[Tuple[str, str], _FuncInfo]) -> Dict[Tuple[str, str], Set[str]]:
    """Fixed point of "locks this function may acquire, including through
    same-module callees"."""
    closure = {k: set(v.acquired) for k, v in funcs.items()}
    for _ in range(len(funcs) + 1):
        changed = False
        for k, info in funcs.items():
            for callee in info.callees:
                extra = closure.get(callee)
                if extra and not extra <= closure[k]:
                    closure[k] |= extra
                    changed = True
        if not changed:
            break
    return closure


def _find_cycles(edges: Dict[str, Set[str]]) -> List[List[str]]:
    """Strongly connected components with >1 node (self-edges are never
    recorded, so singleton SCCs are acyclic)."""
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    sccs: List[List[str]] = []
    counter = [0]

    def strongconnect(v: str) -> None:
        # iterative Tarjan (analysis runs over arbitrary user graphs)
        work = [(v, iter(sorted(edges.get(v, ()))))]
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on_stack.add(v)
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(sorted(edges.get(w, ())))))
                    advanced = True
                    break
                if w in on_stack:
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                scc = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    scc.append(w)
                    if w == node:
                        break
                if len(scc) > 1:
                    sccs.append(sorted(scc))

    for v in sorted(edges):
        if v not in index:
            strongconnect(v)
    return sccs


def scan_file(path: str, rel: str) -> List[Violation]:
    tree = parse_file(path)
    if tree is None:
        return []
    col = _Collector()
    col.collect(tree)
    closure = _transitive_acquired(col.funcs)

    edges: Dict[str, Set[str]] = {}
    examples: Dict[Tuple[str, str], Tuple[int, str]] = {}
    def add_edge(a: str, b: str, line: int, where: str) -> None:
        if a == b:
            return
        edges.setdefault(a, set()).add(b)
        edges.setdefault(b, set())
        examples.setdefault((a, b), (line, where))

    for key, info in col.funcs.items():
        for a, b, line in info.nested_edges:
            add_edge(a, b, line, info.qualname)
        for held, callee, line in info.calls_under:
            for b in closure.get(callee, ()):
                for a in held:
                    add_edge(a, b, line, f"{info.qualname} -> {'.'.join(filter(None, callee))}")

    out: List[Violation] = []
    for scc in _find_cycles(edges):
        detail = "; ".join(
            f"{a}->{b} at :{examples[(a, b)][0]} ({examples[(a, b)][1]})"
            for a in scc
            for b in sorted(edges.get(a, ()))
            if b in scc and (a, b) in examples
        )
        first_line = min(
            examples[(a, b)][0]
            for a in scc
            for b in edges.get(a, ())
            if b in scc and (a, b) in examples
        )
        key = f"{PASS}:{rel}:{'<->'.join(scc)}"
        out.append(
            Violation(
                PASS,
                rel,
                first_line,
                key,
                f"{rel}:{first_line}: potential lock-order inversion among "
                f"{{{', '.join(scc)}}}: {detail}",
            )
        )
    return out
