"""Pass 5: GCS table mutations outside the journaled mutators.

The durability story (snapshot + append-only mutation journal,
gcs_storage.py) only holds while every actor/named-binding/job table
mutation flows through GlobalState's journaled mutators in
`ray_tpu_torch/_private/gcs.py` — a direct dict write elsewhere (e.g.
`rt.state.actors[aid] = info`) would take effect in memory but never hit
the journal, and the mutation would silently NOT survive a head bounce:
exactly the class of gap the PR-1 chaos soak spent minutes finding.

This pass flags any write-shaped access to the journaled tables
(`actors`, `named_actors`, `jobs`) on a GlobalState-ish receiver (dotted
path whose owner terminates in `state`/`_state`/`gcs`) in any module
other than gcs.py itself:

  * subscript assignment / augmented assignment / `del`;
  * mutating method calls: pop/popitem/update/setdefault/clear.

Reads (subscript loads, `.get(...)`, iteration) are untouched — the state
API and snapshot writer read these tables directly by design.  Reviewed
exceptions go in allowlist.txt with a justification, same contract as the
other passes.

FORWARD-ONLY modules (the io-shard fabric, io_shard.py) get a stricter
rule: ANY write-shaped access on a `state`/`gcs`-ish owner — any table
name, plain attribute rebinding included — fails.  A shard process
exists to decode and forward; the single-writer invariant (all GCS
mutation in the head over the journaled path) is the entire reason conn
sharding is safe, so the lint makes a shard-side mutation a CI failure
rather than a soak-found durability hole.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from ray_tpu_torch._private.analysis.common import (
    Violation,
    dotted_name,
    parse_file,
    terminal_name,
)

PASS = "gcs-mutation"

# The journaled tables (GlobalState attributes whose mutations must ride
# the journal).  `functions` joined in the telemetry PR (function exports
# are journaled so a lineage re-execution within the snapshot tick never
# hits "unknown function" — the PR-4 residual); `placement_groups` joined
# with elastic re-mesh (a RESHAPING episode must survive a head bounce or
# the gang wedges forever); kv stays snapshot-only by design (full-table
# capture every tick).
_JOURNALED_TABLES = frozenset({
    "actors", "named_actors", "jobs", "functions", "placement_groups",
})

# Mutating dict methods; everything else on the table is a read.
_MUTATING_METHODS = frozenset({"pop", "popitem", "update", "setdefault", "clear"})

# The one module allowed to write the tables (it owns the mutators).
_MUTATOR_MODULE = "ray_tpu_torch/_private/gcs.py"

# Forwarding-only modules: shard processes may never mutate ANY state
# table (not just the journaled ones) — see the module docstring.
FORWARD_ONLY_MODULES = frozenset({"ray_tpu_torch/_private/io_shard.py"})


def _table_ref(expr: ast.AST, any_table: bool = False) -> Optional[str]:
    """When `expr` is `<owner>.state.actors`-shaped (a journaled table on
    a GlobalState-ish owner), return its dotted name, else None.  With
    any_table (forward-only modules), every attribute on a state/gcs-ish
    owner counts."""
    if not isinstance(expr, ast.Attribute):
        return None
    if not any_table and expr.attr not in _JOURNALED_TABLES:
        return None
    owner = terminal_name(expr.value)
    if owner is None or owner.lstrip("_") not in ("state", "gcs"):
        return None
    return dotted_name(expr) or f"<expr>.{expr.attr}"


class _Scanner(ast.NodeVisitor):
    def __init__(self, rel: str):
        self.rel = rel
        # Forward-only modules: any state/gcs table, any write shape.
        self.any_table = rel in FORWARD_ONLY_MODULES
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

    def _flag(self, node: ast.AST, table: str, how: str) -> None:
        key = f"{PASS}:{self.rel}:{self.qualname()}:{table}:{how}"
        if self.any_table:
            msg = (
                f"{self.rel}:{node.lineno}: {how} on state table `{table}` "
                f"in {self.qualname()} — io-shard processes are FORWARDING "
                "ONLY: all GCS mutation stays in the head over the "
                "journaled single-writer path (this is what makes conn "
                "sharding safe)"
            )
        else:
            msg = (
                f"{self.rel}:{node.lineno}: direct {how} on journaled GCS "
                f"table `{table}` in {self.qualname()} — route through the "
                "journaled mutators in gcs.py (register_actor / "
                "set_actor_state / set_job_state) or justify in the "
                "allowlist; a direct write silently skips the durability "
                "journal"
            )
        self.violations.append(Violation(PASS, self.rel, node.lineno, key, msg))

    def _check_store_target(self, target: ast.AST) -> None:
        if isinstance(target, ast.Subscript):
            table = _table_ref(target.value, self.any_table)
            if table is not None:
                self._flag(target, table, "subscript write")
        elif isinstance(target, ast.Attribute) and self.any_table:
            # Forward-only modules: rebinding a table wholesale
            # (`rt.state.actors = {}`) is a mutation too.
            table = _table_ref(target, True)
            if table is not None:
                self._flag(target, table, "attribute write")
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._check_store_target(elt)

    def visit_Assign(self, node: ast.Assign) -> None:
        for target in node.targets:
            self._check_store_target(target)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._check_store_target(node.target)
        self.generic_visit(node)

    def visit_Delete(self, node: ast.Delete) -> None:
        for target in node.targets:
            if isinstance(target, ast.Subscript):
                table = _table_ref(target.value, self.any_table)
                if table is not None:
                    self._flag(target, table, "del")
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        if isinstance(func, ast.Attribute) and func.attr in _MUTATING_METHODS:
            table = _table_ref(func.value, self.any_table)
            if table is not None:
                self._flag(node, table, f".{func.attr}()")
        self.generic_visit(node)


def scan_file(path: str, rel: str) -> List[Violation]:
    if rel == _MUTATOR_MODULE:
        return []  # the mutators themselves live here
    tree = parse_file(path)
    if tree is None:
        return []
    s = _Scanner(rel)
    s.visit(tree)
    return s.violations
