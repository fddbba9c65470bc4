"""Pass 10: wire-schema conformance — static send/recv checks vs SCHEMAS.

The protocol's worst bugs have all been silent schema drift caught only
by runtime accidents: the `ready` arity cap that broke every reconnect
(a recv handler assumed more fields than the schema guaranteed), and the
unregistered `refs_push` kind whose whole coalesced batch — innocent
`task_events` riding along — was rejected at the boundary.  The
reference avoids the class with generated protobuf stubs; our
hand-maintained `wire.SCHEMAS` table gets this cross-check instead.

Three sub-checks:

  * send sites — every tuple literal passed directly to `.send(...)` /
    `.oneway(...)` (or to wire.encode/encode_body/encode_native) in the
    wire-speaking modules: the kind must be registered in SCHEMAS
    (unknown kinds poison whole batches), the literal arity must fall in
    the schema's [min,max], and leading typed fields must match where
    the literal's type is statically inferable;
  * recv dispatch — per-function `kind == "x"` / `kind in (...)` chains
    over a received message variable: a subscript `msg[N]` or an exact
    tuple unpack inside a handler that assumes more fields than the
    schema's MIN guarantees (and is not under a `len(msg)` guard) fails
    — exactly the PR-4 bug class;
  * native table — wire_native.KIND_IDS must be a subset of SCHEMAS with
    ids in 1..0x7F (0x80 is pickle's discriminator), and the kinds whose
    payload the native codec shapes with an EXACT arity
    (wire_native.NATIVE_ARITIES) must agree with the schema bounds.

Dynamically built frames (vars, *args splats) are out of static reach
and skipped — `wire._validate` still rejects them at runtime.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ray_tpu_torch._private.analysis.common import Violation, parse_file

PASS = "wire-schema"

# Modules that speak the wire protocol.  Send/recv scanning is scoped to
# these (plus fixture trees, which reuse the names): `.send(...)` on
# non-wire channels elsewhere (mp pipes, queues) is not a frame.
WIRE_MODULES = frozenset(
    {
        "ray_tpu_torch/_private/runtime.py",
        "ray_tpu_torch/_private/worker_proc.py",
        "ray_tpu_torch/_private/peer.py",
        "ray_tpu_torch/_private/io_shard.py",
        "ray_tpu_torch/_private/node_daemon.py",
        "ray_tpu_torch/_private/driver_client.py",
        "ray_tpu_torch/_private/pubsub.py",
        "ray_tpu_torch/_private/telemetry.py",
        "ray_tpu_torch/_private/head.py",
        "ray_tpu_torch/_private/object_plane.py",
        "ray_tpu_torch/_private/zygote.py",
        "ray_tpu_torch/_private/wire.py",
        "ray_tpu_torch/rllib/policy_client.py",
    }
)

# Call attrs whose first positional argument is a wire frame.
_SEND_ATTRS = frozenset({"send", "oneway"})
_ENCODE_FUNCS = frozenset({"encode", "encode_body", "encode_native"})


def _schemas() -> Dict[str, Tuple[int, Optional[int], tuple]]:
    from ray_tpu_torch._private import wire

    return wire.SCHEMAS


# --- literal type inference -------------------------------------------------

# Known-constructor call results, by terminal callee name.  Deliberately
# small: only names whose return type is unambiguous in this codebase.
_CTOR_TYPES = {
    "dict": dict,
    "list": list,
    "tuple": tuple,
    "set": set,
    "str": str,
    "repr": str,
    "int": int,
    "len": int,
    "float": float,
    "bool": bool,
    "bytes": bytes,
    "getpid": int,
    "time": float,
    "monotonic": float,
}


def _infer_type(node: ast.AST) -> Optional[type]:
    """Static type of a literal-ish expression, or None = unknowable."""
    if isinstance(node, ast.Constant):
        return type(node.value)
    if isinstance(node, ast.JoinedStr):
        return str
    if isinstance(node, ast.List):
        return list
    if isinstance(node, ast.Dict):
        return dict
    if isinstance(node, ast.Tuple):
        return tuple
    if isinstance(node, ast.Set):
        return set
    if isinstance(node, ast.Call):
        func = node.func
        name = func.attr if isinstance(func, ast.Attribute) else (
            func.id if isinstance(func, ast.Name) else None
        )
        return _CTOR_TYPES.get(name) if name else None
    return None


def _field_type_ok(node: ast.AST, want: Optional[type]) -> bool:
    if want is None:
        return True
    got = _infer_type(node)
    if got is None:
        return True  # unknowable: runtime _validate is the backstop
    if got is type(None):
        return False  # isinstance(None, t) is False for every schema type
    return issubclass(got, want)


# --- send side --------------------------------------------------------------


class _Scanner(ast.NodeVisitor):
    """Shared scope-tracking base (qualname like metric_names)."""

    def __init__(self, rel: str):
        self.rel = rel
        self.scope: List[str] = []
        self.violations: Dict[str, Violation] = {}

    def qualname(self) -> str:
        return ".".join(self.scope) or "<module>"

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.scope.append(node.name)
        self.generic_visit(node)
        self.scope.pop()

    def _visit_func(self, node) -> None:
        self.scope.append(node.name)
        self.generic_visit(node)
        self.scope.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def add(self, line: int, key: str, message: str) -> None:
        if key not in self.violations:
            self.violations[key] = Violation(PASS, self.rel, line, key, message)


class _SendScanner(_Scanner):
    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        is_send = isinstance(func, ast.Attribute) and func.attr in _SEND_ATTRS
        is_encode = (
            isinstance(func, ast.Attribute) and func.attr in _ENCODE_FUNCS
        ) or (isinstance(func, ast.Name) and func.id in _ENCODE_FUNCS)
        if (is_send or is_encode) and node.args:
            arg = node.args[0]
            if isinstance(arg, ast.Tuple) and arg.elts:
                head = arg.elts[0]
                if isinstance(head, ast.Constant) and isinstance(head.value, str):
                    self._check_frame(arg, head.value)
        self.generic_visit(node)

    def _check_frame(self, tup: ast.Tuple, kind: str) -> None:
        schemas = _schemas()
        scope = self.qualname()
        spec = schemas.get(kind)
        if spec is None:
            self.add(
                tup.lineno,
                f"{PASS}:send-kind:{self.rel}:{scope}:{kind}",
                f"{self.rel}:{tup.lineno}: send of unregistered frame kind "
                f"{kind!r} — wire._validate rejects it at decode, poisoning "
                "the whole coalesced batch it rides in (the refs_push bug "
                "class); register it in wire.SCHEMAS",
            )
            return
        lo, hi, types = spec
        extras = tup.elts[1:]
        if any(isinstance(e, ast.Starred) for e in extras):
            return  # splat: arity not static
        n = len(extras)
        if n < lo or (hi is not None and n > hi):
            self.add(
                tup.lineno,
                f"{PASS}:send-arity:{self.rel}:{scope}:{kind}",
                f"{self.rel}:{tup.lineno}: {kind!r} frame sent with {n} "
                f"field(s), schema allows [{lo}, "
                f"{hi if hi is not None else 'inf'}] — the receiver rejects "
                "it at the boundary (the ready-arity bug class)",
            )
        for i, want in enumerate(types):
            if i >= len(extras):
                break
            if not _field_type_ok(extras[i], want):
                self.add(
                    tup.lineno,
                    f"{PASS}:send-type:{self.rel}:{scope}:{kind}:field{i}",
                    f"{self.rel}:{tup.lineno}: {kind!r} frame field {i} is "
                    f"statically not a {want.__name__} — wire._validate "
                    "rejects the frame at decode",
                )


# --- recv side --------------------------------------------------------------


def _const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _terminates(stmts: List[ast.stmt]) -> bool:
    return bool(stmts) and isinstance(
        stmts[-1], (ast.Return, ast.Raise, ast.Continue, ast.Break)
    )


class _RecvScanner(_Scanner):
    """Per-function dispatch analysis: find `kind == "x"` chains over a
    message variable and check that each handler's accesses stay within
    what the schema's MIN arity guarantees."""

    def _visit_func(self, node) -> None:
        self.scope.append(node.name)
        _FuncRecv(self, node).run()
        # Nested defs get their own dispatch analysis (closures handling
        # frames are common in the recv loops).
        for stmt in node.body:
            for child in ast.walk(stmt):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    self._visit_nested(child)
        self.scope.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def _visit_nested(self, node) -> None:
        self.scope.append(node.name)
        _FuncRecv(self, node).run()
        self.scope.pop()


class _FuncRecv:
    def __init__(self, scanner: _RecvScanner, func) -> None:
        self.s = scanner
        self.func = func
        # name -> message var it aliases the kind of (`kind = msg[0]`)
        self.kind_alias: Dict[str, str] = {}
        # name -> message var it aliases the LENGTH of (`n = len(msg)`)
        self.len_alias: Dict[str, str] = {}

    def run(self) -> None:
        self._collect_aliases(self.func.body)
        self._walk_block(self.func.body)

    # -- alias collection (own statements only, not nested defs) --

    def _collect_aliases(self, stmts: List[ast.stmt]) -> None:
        for stmt in stmts:
            for node in ast.walk(stmt):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                if isinstance(node, ast.Assign) and len(node.targets) == 1:
                    tgt = node.targets[0]
                    if isinstance(tgt, ast.Name):
                        src = self._msg_sub0(node.value)
                        if src is not None:
                            self.kind_alias[tgt.id] = src
                        src = self._len_of(node.value)
                        if src is not None:
                            self.len_alias[tgt.id] = src

    @staticmethod
    def _msg_sub0(node: ast.AST) -> Optional[str]:
        """`msg[0]` -> "msg" (the kind position)."""
        if (
            isinstance(node, ast.Subscript)
            and isinstance(node.value, ast.Name)
            and isinstance(node.slice, ast.Constant)
            and node.slice.value == 0
        ):
            return node.value.id
        return None

    @staticmethod
    def _len_of(node: ast.AST) -> Optional[str]:
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Name)
            and node.func.id == "len"
            and len(node.args) == 1
            and isinstance(node.args[0], ast.Name)
        ):
            return node.args[0].id
        return None

    # -- kind-test extraction --

    def _kind_test(
        self, test: ast.AST
    ) -> Optional[Tuple[str, Set[str], bool, bool]]:
        """(msgvar, kinds, negated, len_guarded) for a kind test, else None."""
        if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.And):
            found = None
            guarded = False
            for v in test.values:
                sub = self._kind_test(v)
                if sub is not None and found is None:
                    found = sub
                if self._mentions_len(v, sub[0] if sub else None):
                    guarded = True
            if found is not None:
                msgvar, kinds, neg, g = found
                return (msgvar, kinds, neg, g or guarded)
            return None
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            sub = self._kind_test(test.operand)
            if sub is not None:
                msgvar, kinds, neg, g = sub
                return (msgvar, kinds, not neg, g)
            return None
        if isinstance(test, ast.Compare) and len(test.ops) == 1:
            op = test.ops[0]
            left, right = test.left, test.comparators[0]
            if isinstance(op, (ast.Eq, ast.NotEq)):
                for a, b in ((left, right), (right, left)):
                    msgvar = self._kind_expr(a)
                    k = _const_str(b)
                    if msgvar is not None and k is not None:
                        return (msgvar, {k}, isinstance(op, ast.NotEq), False)
            if isinstance(op, (ast.In, ast.NotIn)):
                msgvar = self._kind_expr(left)
                if msgvar is not None and isinstance(
                    right, (ast.Tuple, ast.List, ast.Set)
                ):
                    kinds = {
                        s
                        for s in (_const_str(e) for e in right.elts)
                        if s is not None
                    }
                    if kinds:
                        return (msgvar, kinds, isinstance(op, ast.NotIn), False)
        return None

    def _kind_expr(self, node: ast.AST) -> Optional[str]:
        """The message var whose kind this expr reads: `msg[0]` or a
        `kind = msg[0]` alias name."""
        src = self._msg_sub0(node)
        if src is not None:
            return src
        if isinstance(node, ast.Name):
            return self.kind_alias.get(node.id)
        return None

    def _mentions_len(self, node: ast.AST, msgvar: Optional[str]) -> bool:
        """Does this expression read len(<msgvar>) (or a len alias)?"""
        for sub in ast.walk(node):
            src = self._len_of(sub)
            if src is not None and (msgvar is None or src == msgvar):
                return True
            if (
                isinstance(sub, ast.Name)
                and sub.id in self.len_alias
                and (msgvar is None or self.len_alias[sub.id] == msgvar)
            ):
                return True
        return False

    # -- block walking --

    def _walk_block(self, stmts: List[ast.stmt]) -> None:
        for i, stmt in enumerate(stmts):
            if isinstance(stmt, ast.If):
                kt = self._kind_test(stmt.test)
                if kt is not None:
                    msgvar, kinds, negated, guarded = kt
                    if negated:
                        # `if msg[0] != "ready": ...return` — the REST of
                        # the block is the "ready" handler.
                        if _terminates(stmt.body):
                            self._check_handler(
                                msgvar, kinds, stmts[i + 1 :], guarded
                            )
                        self._walk_block(stmt.body)
                        self._walk_block(stmt.orelse)
                        continue
                    self._check_handler(msgvar, kinds, stmt.body, guarded)
                    self._walk_block(stmt.body)
                    self._walk_block(stmt.orelse)
                    continue
            for block in self._sub_blocks(stmt):
                self._walk_block(block)

    @staticmethod
    def _sub_blocks(stmt: ast.stmt) -> List[List[ast.stmt]]:
        out = []
        for attr in ("body", "orelse", "finalbody"):
            block = getattr(stmt, attr, None)
            if isinstance(block, list) and not isinstance(
                stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                out.append(block)
        for h in getattr(stmt, "handlers", ()) or ():
            out.append(h.body)
        return out

    # -- handler checking --

    def _check_handler(
        self,
        msgvar: str,
        kinds: Set[str],
        body: List[ast.stmt],
        pre_guarded: bool,
    ) -> None:
        schemas = _schemas()
        wire_kinds = sorted(k for k in kinds if k in schemas)
        if not wire_kinds:
            return
        lo = min(schemas[k][0] for k in wire_kinds)
        kind0 = wire_kinds[0]
        scope = self.s.qualname()
        self._scan_accesses(
            msgvar, kinds, wire_kinds, lo, kind0, scope, body, pre_guarded
        )

    def _scan_accesses(
        self,
        msgvar: str,
        kinds: Set[str],
        wire_kinds: List[str],
        lo: int,
        kind0: str,
        scope: str,
        body: List[ast.stmt],
        guarded: bool,
    ) -> None:
        schemas = _schemas()
        for stmt in body:
            # Exact tuple unpack: `_, wid, renv = msg` requires len(msg)
            # to be EXACTLY n — legal frames at any other schema arity
            # raise ValueError in the handler, not ProtocolError at the
            # boundary.
            if (
                isinstance(stmt, ast.Assign)
                and len(stmt.targets) == 1
                and isinstance(stmt.targets[0], (ast.Tuple, ast.List))
                and isinstance(stmt.value, ast.Name)
                and stmt.value.id == msgvar
                and not guarded
            ):
                elts = stmt.targets[0].elts
                starred = any(isinstance(e, ast.Starred) for e in elts)
                if starred:
                    need = len(elts) - 2  # fixed extras before/after star
                    if need > lo:
                        self.s.add(
                            stmt.lineno,
                            f"{PASS}:recv-unpack:{self.s.rel}:{scope}:{kind0}",
                            f"{self.s.rel}:{stmt.lineno}: handler for "
                            f"{kind0!r} star-unpacks {need} fixed extra "
                            f"field(s) but the schema only guarantees {lo}",
                        )
                else:
                    need = len(elts) - 1
                    bad = [
                        k
                        for k in wire_kinds
                        if schemas[k][0] != need or schemas[k][1] != need
                    ]
                    if bad:
                        self.s.add(
                            stmt.lineno,
                            f"{PASS}:recv-unpack:{self.s.rel}:{scope}:{kind0}",
                            f"{self.s.rel}:{stmt.lineno}: handler for "
                            f"{bad[0]!r} exact-unpacks {need} extra field(s) "
                            f"but the schema allows [{schemas[bad[0]][0]}, "
                            f"{schemas[bad[0]][1] if schemas[bad[0]][1] is not None else 'inf'}] "
                            "— a legal frame at another arity raises in the "
                            "handler instead of rejecting at the boundary "
                            "(the ready-arity bug class)",
                        )
            # len-guarded regions: anything under a test that reads
            # len(msgvar) is assumed bounds-checked.
            if isinstance(stmt, ast.If) and self._mentions_len(
                stmt.test, msgvar
            ):
                self._scan_accesses(
                    msgvar, kinds, wire_kinds, lo, kind0, scope,
                    stmt.body, True,
                )
                self._scan_accesses(
                    msgvar, kinds, wire_kinds, lo, kind0, scope,
                    stmt.orelse, True,
                )
                continue
            # Everything else: walk expressions for subscripts.
            self._scan_exprs(stmt, msgvar, lo, kind0, scope, guarded)
            for block in _FuncRecv._sub_blocks(stmt):
                self._scan_accesses(
                    msgvar, kinds, wire_kinds, lo, kind0, scope,
                    block, guarded,
                )

    @staticmethod
    def _stmt_exprs(stmt: ast.stmt) -> List[ast.expr]:
        """A statement's IMMEDIATE expressions (not nested stmt bodies —
        those are walked separately so inner len-guards keep working)."""
        out: List[ast.expr] = []
        for _field, value in ast.iter_fields(stmt):
            if isinstance(value, ast.expr):
                out.append(value)
            elif isinstance(value, list):
                for v in value:
                    if isinstance(v, ast.expr):
                        out.append(v)
                    elif isinstance(v, ast.withitem):
                        out.append(v.context_expr)
        return out

    def _scan_exprs(
        self,
        stmt: ast.stmt,
        msgvar: str,
        lo: int,
        kind0: str,
        scope: str,
        guarded: bool,
    ) -> None:
        if guarded:
            return
        exprs = self._stmt_exprs(stmt)
        nodes = [n for e in exprs for n in ast.walk(e)]
        skip: Set[int] = set()
        for node in nodes:
            if isinstance(node, ast.IfExp) and self._mentions_len(
                node.test, msgvar
            ):
                for sub in ast.walk(node.body):
                    skip.add(id(sub))
                for sub in ast.walk(node.orelse):
                    skip.add(id(sub))
            elif isinstance(node, ast.BoolOp):
                # `len(msg) > 4 and msg[4]` short-circuit guard
                guard_seen = False
                for v in node.values:
                    if self._mentions_len(v, msgvar):
                        guard_seen = True
                    elif guard_seen:
                        for sub in ast.walk(v):
                            skip.add(id(sub))
        for node in nodes:
            if id(node) in skip:
                continue
            if (
                isinstance(node, ast.Subscript)
                and isinstance(node.value, ast.Name)
                and node.value.id == msgvar
                and isinstance(node.slice, ast.Constant)
                and isinstance(node.slice.value, int)
                and not isinstance(node.slice.value, bool)
                and node.slice.value > lo
            ):
                n = node.slice.value
                self.s.add(
                    node.lineno,
                    f"{PASS}:recv-arity:{self.s.rel}:{scope}:{kind0}:field{n}",
                    f"{self.s.rel}:{node.lineno}: handler for {kind0!r} "
                    f"reads {msgvar}[{n}] but the schema only guarantees "
                    f"{lo} extra field(s) — guard with len({msgvar}) or "
                    "raise the schema min (the ready-arity bug class)",
                )


# --- entry points -----------------------------------------------------------


def scan_file(path: str, rel: str) -> List[Violation]:
    if rel not in WIRE_MODULES and not rel.startswith("fixture"):
        return []
    tree = parse_file(path)
    if tree is None:
        return []
    send = _SendScanner(rel)
    send.visit(tree)
    recv = _RecvScanner(rel)
    recv.visit(tree)
    out = list(send.violations.values()) + list(recv.violations.values())
    return out


def check_native() -> List[Violation]:
    """wire_native.KIND_IDS must be a registered subset of SCHEMAS with
    wire-safe ids, and its exact payload arities must fit the schema."""
    from ray_tpu_torch._private import wire_native

    schemas = _schemas()
    out: List[Violation] = []
    rel = "ray_tpu_torch/_private/wire_native.py"
    seen_ids: Dict[int, str] = {}
    for kind, kid in sorted(wire_native.KIND_IDS.items()):
        if kind not in schemas:
            out.append(
                Violation(
                    PASS, rel, 0,
                    f"{PASS}:native-kind:{kind}",
                    f"{rel}: native kind {kind!r} (id {kid}) is not "
                    "registered in wire.SCHEMAS — its frames decode then "
                    "fail validation",
                )
            )
        if not (1 <= kid <= 0x7F):
            out.append(
                Violation(
                    PASS, rel, 0,
                    f"{PASS}:native-id:{kind}",
                    f"{rel}: native kind {kind!r} id {kid} is outside "
                    "1..0x7F (0x80 is pickle's discriminator byte)",
                )
            )
        if kid in seen_ids:
            out.append(
                Violation(
                    PASS, rel, 0,
                    f"{PASS}:native-dup:{kind}",
                    f"{rel}: native id {kid} is claimed by both "
                    f"{seen_ids[kid]!r} and {kind!r}",
                )
            )
        seen_ids.setdefault(kid, kind)
    for kind, arity in sorted(
        getattr(wire_native, "NATIVE_ARITIES", {}).items()
    ):
        spec = schemas.get(kind)
        if spec is None:
            continue  # already reported above
        lo, hi, _types = spec
        if arity < lo or (hi is not None and arity > hi):
            out.append(
                Violation(
                    PASS, rel, 0,
                    f"{PASS}:native-arity:{kind}",
                    f"{rel}: native codec packs {kind!r} at exact arity "
                    f"{arity}, but wire.SCHEMAS allows [{lo}, "
                    f"{hi if hi is not None else 'inf'}] — one of the two "
                    "tables is stale",
                )
            )
    return out
