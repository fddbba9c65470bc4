"""Pass 8: journal coverage — every GCS mutator reaches journal_hook.

The gcs-mutation pass (gcs_mutation.py) guarantees the journaled tables
are only written INSIDE gcs.py; this pass closes the other half of the
durability contract: a mutator inside gcs.py that writes a journaled
table but never calls `self._journal(...)` would mutate memory without
ever reaching the journal hook — the mutation silently would not survive
a head bounce, and no chaos round is guaranteed to catch the one table it
forgot.  The hole got more interesting with group commit
(gcs_storage.MutationJournal batches appends): the journal write is now
decoupled from the mutation in TIME, so a dropped entry KIND would look
identical to normal linger in any manual test.

Two checks:

  * mutator coverage — every GlobalState method that writes a journaled
    table (same write-shape detection as gcs-mutation: subscript/del/
    augassign/mutating method calls on `self.<table>`) must contain a
    `self._journal(...)` call.  Restore-path bulk loaders that apply
    ALREADY-journaled entries are exempt by name (_RESTORE_EXEMPT) — they
    must NOT re-journal what they replay;
  * kind catalog — every literal entry kind handed to `_journal(...)` /
    `_journal_append(...)` anywhere in the package must be in
    KNOWN_KINDS.  A new kind is a REVIEW EVENT: the author must decide
    its restore-time handling (apply, like actor_state; or ignore, like
    lease) and add it here — an unreviewed kind replays as silence.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from ray_tpu_torch._private.analysis.common import (
    Violation,
    parse_file,
    terminal_name,
)

PASS = "journal-coverage"

# Keep in sync with gcs_mutation._JOURNALED_TABLES.
_JOURNALED_TABLES = frozenset({
    "actors", "named_actors", "jobs", "functions", "placement_groups",
})
_MUTATING_METHODS = frozenset({"pop", "popitem", "update", "setdefault", "clear"})
_MUTATOR_MODULE = "ray_tpu_torch/_private/gcs.py"

# Bulk loaders on the RESTORE path: they apply entries that came FROM the
# journal/snapshot being replayed; journaling them again would double
# every entry at the next compaction.
_RESTORE_EXEMPT = frozenset({"import_functions", "restore_pg"})

# Reviewed journal entry kinds with their restore-time handling:
#   actor_register / actor_state / job_state / function / lineage —
#     applied by Runtime._restore_snapshot;
#   pg_register / pg_state — applied by Runtime._restore_snapshot (PG
#     record upsert / lifecycle merge); a PG that died mid-RESHAPING
#     replays as RESHAPING and re-enters the reshape sweep with a fresh
#     wait deadline (the deadline itself is head-local, never persisted);
#   lease — diagnostic only: leases are runtime state that cannot outlive
#     the workers' resource reservations, a restarted head re-grants from
#     live traffic (restore ignores them by design);
#   node_lifecycle — applied by Runtime._restore_snapshot (per-node state
#     merge onto Runtime.node_lifecycle): DEPARTED is terminal; DRAINING
#     resumes draining after a head bounce (the daemon's re-registration
#     re-marks NodeInfo.draining and the reconciler re-arms FRESH drain
#     windows — wall-clock deadlines are head-local and never persisted);
#     REQUESTED/STARTING are re-checked against the provider by the
#     reconciler; ACTIVE is re-confirmed by daemon reconnect or flipped
#     DEPARTED by the death path;
#   demand — advisory demand-summary trail (throttled by the autoscaler
#     reconciler) for post-mortem "why did it scale" analysis; restore
#     ignores it by design: demand is recomputed from live queues.
KNOWN_KINDS = frozenset({
    "actor_register", "actor_state", "job_state", "function", "lineage",
    "lease", "pg_register", "pg_state", "node_lifecycle", "demand",
})


def _self_table_write(node: ast.AST) -> Optional[str]:
    """Table name when `node` is a write-shaped access on
    `self.<journaled table>`."""
    def table_of(expr) -> Optional[str]:
        if (
            isinstance(expr, ast.Attribute)
            and expr.attr in _JOURNALED_TABLES
            and terminal_name(expr.value) == "self"
        ):
            return expr.attr
        return None

    if isinstance(node, ast.Assign):
        for t in node.targets:
            if isinstance(t, ast.Subscript):
                got = table_of(t.value)
                if got:
                    return got
    elif isinstance(node, ast.AugAssign):
        if isinstance(node.target, ast.Subscript):
            return table_of(node.target.value)
    elif isinstance(node, ast.Delete):
        for t in node.targets:
            if isinstance(t, ast.Subscript):
                got = table_of(t.value)
                if got:
                    return got
    elif isinstance(node, ast.Call):
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in _MUTATING_METHODS:
            return table_of(f.value)
    return None


def _journal_call_kinds(tree: ast.AST):
    """(call_node, literal_kind_or_None) for every `*._journal(...)` /
    `*._journal_append(...)` / `journal_hook(...)`-shaped call."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        name = f.attr if isinstance(f, ast.Attribute) else (
            f.id if isinstance(f, ast.Name) else None
        )
        if name not in ("_journal", "_journal_append"):
            continue
        kind = None
        if node.args and isinstance(node.args[0], ast.Tuple) and node.args[0].elts:
            first = node.args[0].elts[0]
            if isinstance(first, ast.Constant) and isinstance(first.value, str):
                kind = first.value
        yield node, kind


def scan_file(path: str, rel: str) -> List[Violation]:
    tree = parse_file(path)
    if tree is None:
        return []
    out: List[Violation] = []

    # Kind catalog (package-wide): unreviewed literal kinds fail.
    for node, kind in _journal_call_kinds(tree):
        if kind is not None and kind not in KNOWN_KINDS:
            key = f"{PASS}:{rel}:kind:{kind}"
            out.append(Violation(
                PASS, rel, node.lineno, key,
                f"{rel}:{node.lineno}: journal entry kind {kind!r} is not "
                "in journal_coverage.KNOWN_KINDS — decide its restore-time "
                "handling (apply or explicitly ignore) and add it to the "
                "reviewed catalog; an unreviewed kind replays as silence",
            ))

    # Mutator coverage: gcs.py only.
    if rel != _MUTATOR_MODULE:
        return out
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if node.name in _RESTORE_EXEMPT or node.name.startswith("__"):
            continue
        written = None
        for sub in ast.walk(node):
            written = _self_table_write(sub)
            if written:
                break
        if not written:
            continue
        has_journal = any(True for _n, _k in _journal_call_kinds(node))
        if not has_journal:
            key = f"{PASS}:{rel}:{node.name}:{written}"
            out.append(Violation(
                PASS, rel, node.lineno, key,
                f"{rel}:{node.lineno}: GlobalState.{node.name} writes "
                f"journaled table `{written}` but never calls "
                "self._journal(...) — the mutation would not survive a "
                "head bounce (batched or not, every mutator must reach "
                "journal_hook); restore-path bulk loaders belong in "
                "_RESTORE_EXEMPT instead",
            ))
    return out
