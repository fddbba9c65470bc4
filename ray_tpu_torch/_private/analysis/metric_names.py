"""Pass 6: metric-name registry + tag-key validation.

The telemetry plane aggregates metrics ACROSS processes by name: two code
sites constructing the same metric name silently merge (or worse, collide
with different types and one process's registration wins), and a record
call with a tag key the metric never declared raises ValueError at RECORD
time — on a hot path, in production, long after the typo was written.

This pass makes both failure modes a CI error:

  * every `Counter(...)` / `Gauge(...)` / `Histogram(...)` construction
    with a literal name is collected into a generated catalog
    (metric_names.txt, the fault_points.txt pattern — regenerated by
    `scripts/ray_tpu_lint.py --fix-allowlist`), so the full metric
    namespace is reviewable in one file and README's catalog section has
    a source of truth;
  * DUPLICATE names (the same literal name constructed at two sites, or
    at one site with two different types) fail the lint;
  * UNDECLARED TAGS — a literal `tags={...}` passed to `.inc()/.set()/
    .observe()`, or a literal dict to `.set_default_tags()`, whose keys
    are not all in the construction's literal `tag_keys` — fail the lint
    at the call site, statically, where the runtime would only fail at
    record time.

Dynamically built names/tag dicts are out of static reach and skipped —
the runtime's own validation still fails those loudly.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch._private.analysis.common import (
    Violation,
    dotted_name,
    parse_file,
)

PASS = "metric-names"

_METRIC_TYPES = ("Counter", "Gauge", "Histogram")

CATALOG_HEADER = (
    "# Generated metric-name catalog — do not edit by hand.\n"
    "# Regenerate with: python scripts/ray_tpu_lint.py --fix-allowlist\n"
    "# One '<name> <Type>' per registered Counter/Gauge/Histogram "
    "construction.\n"
)


def _ctor_type(call: ast.Call) -> Optional[str]:
    """Counter/Gauge/Histogram constructor calls, plain (`Counter(...)`)
    or module-qualified (`metrics.Counter(...)`)."""
    func = call.func
    if isinstance(func, ast.Name) and func.id in _METRIC_TYPES:
        return func.id
    if isinstance(func, ast.Attribute) and func.attr in _METRIC_TYPES:
        return func.attr
    return None


def _literal_str(node) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _literal_str_seq(node) -> Optional[Tuple[str, ...]]:
    if isinstance(node, (ast.Tuple, ast.List)):
        out = []
        for elt in node.elts:
            s = _literal_str(elt)
            if s is None:
                return None
            out.append(s)
        return tuple(out)
    return None


def _ctor_info(
    call: ast.Call,
) -> Optional[Tuple[str, Optional[str], Optional[Tuple[str, ...]]]]:
    """(type, literal name or None, literal tag_keys or None)."""
    mtype = _ctor_type(call)
    if mtype is None:
        return None
    name = _literal_str(call.args[0]) if call.args else None
    tag_keys: Optional[Tuple[str, ...]] = None
    tag_node = None
    for kw in call.keywords:
        if kw.arg == "tag_keys":
            tag_node = kw.value
    if tag_node is None:
        # positional tag_keys: Counter/Gauge(name, desc, tag_keys);
        # Histogram(name, desc, boundaries, tag_keys)
        idx = 3 if mtype == "Histogram" else 2
        if len(call.args) > idx:
            tag_node = call.args[idx]
    if tag_node is not None:
        tag_keys = _literal_str_seq(tag_node)
    elif not any(kw.arg is None for kw in call.keywords):
        tag_keys = ()  # no tag_keys argument at all = declared empty
    return mtype, name, tag_keys


def collect_metrics(
    files: Sequence[Tuple[str, str]],
) -> Dict[str, List[Tuple[str, str]]]:
    """metric name -> [("rel:line", type), ...] over (abspath, rel)."""
    out: Dict[str, List[Tuple[str, str]]] = {}
    for path, rel in files:
        tree = parse_file(path)
        if tree is None:
            continue
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                info = _ctor_info(node)
                if info is not None and info[1] is not None:
                    out.setdefault(info[1], []).append(
                        (f"{rel}:{node.lineno}", info[0])
                    )
    return out


def check_duplicates(
    metrics: Dict[str, List[Tuple[str, str]]],
) -> List[Violation]:
    out: List[Violation] = []
    for name, sites in sorted(metrics.items()):
        if len(sites) < 2:
            continue
        types = sorted({t for _s, t in sites})
        conflict = (
            f" with CONFLICTING types {types}" if len(types) > 1 else ""
        )
        locs = ", ".join(s for s, _t in sites)
        rel, line = sites[0][0].rsplit(":", 1)
        out.append(
            Violation(
                PASS,
                rel,
                int(line),
                f"{PASS}:dup:{name}",
                f"metric {name!r} constructed at {len(sites)} sites"
                f"{conflict} ({locs}) — same-name registrations collide in "
                "the per-process registry and merge silently in the "
                "cluster aggregate; rename one or hoist the construction",
            )
        )
    return out


# -- catalog (the fault_points.txt pattern) ---------------------------------

def load_catalog(path: str) -> List[str]:
    if not os.path.exists(path):
        return []
    with open(path, "r", encoding="utf-8") as f:
        return [
            line.strip()
            for line in f
            if line.strip() and not line.lstrip().startswith("#")
        ]


def write_catalog(
    metrics: Dict[str, List[Tuple[str, str]]], path: str
) -> None:
    with open(path, "w", encoding="utf-8") as f:
        f.write(CATALOG_HEADER)
        for name in sorted(metrics):
            types = sorted({t for _s, t in metrics[name]})
            f.write(f"{name} {'/'.join(types)}\n")


def check_catalog(
    metrics: Dict[str, List[Tuple[str, str]]], path: str
) -> List[Violation]:
    committed = set(load_catalog(path))
    actual = {
        f"{name} {'/'.join(sorted({t for _s, t in sites}))}"
        for name, sites in metrics.items()
    }
    if committed == actual:
        return []
    missing = sorted(actual - committed)
    extra = sorted(committed - actual)
    parts = []
    if missing:
        parts.append(f"unregistered metrics {missing}")
    if extra:
        parts.append(f"stale catalog entries {extra}")
    rel = os.path.basename(path)
    return [
        Violation(
            PASS,
            rel,
            0,
            f"{PASS}:catalog:{rel}",
            f"{rel}: metric-name catalog is stale ({'; '.join(parts)}) — "
            "regenerate with scripts/ray_tpu_lint.py --fix-allowlist",
        )
    ]


# -- per-file tag validation -------------------------------------------------

_RECORD_METHODS = ("inc", "set", "observe", "set_default_tags")


class _Scanner(ast.NodeVisitor):
    def __init__(self, rel: str):
        self.rel = rel
        self.scope: List[str] = []
        self.violations: List[Violation] = []
        # dotted receiver -> (metric name, declared tag_keys)
        self.vars: Dict[str, Tuple[Optional[str], Optional[Tuple[str, ...]]]] = {}

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

    @staticmethod
    def _unwrap_ctor(value: ast.AST) -> Optional[ast.Call]:
        """The constructor Call under an optional .set_default_tags(...)
        chain (its return value is the metric itself)."""
        if isinstance(value, ast.Call):
            if _ctor_type(value) is not None:
                return value
            func = value.func
            if (
                isinstance(func, ast.Attribute)
                and func.attr == "set_default_tags"
                and isinstance(func.value, ast.Call)
                and _ctor_type(func.value) is not None
            ):
                return func.value
        return None

    def visit_Assign(self, node: ast.Assign) -> None:
        ctor = self._unwrap_ctor(node.value)
        if ctor is not None:
            info = _ctor_info(ctor)
            if info is not None:
                for target in node.targets:
                    dn = dotted_name(target)
                    if dn is not None:
                        self.vars[dn] = (info[1], info[2])
        self.generic_visit(node)

    def _flag(self, node: ast.AST, mname: str, bad: List[str], declared) -> None:
        self.violations.append(
            Violation(
                PASS,
                self.rel,
                node.lineno,
                f"{PASS}:tags:{self.rel}:{mname}:{','.join(sorted(bad))}",
                f"{self.rel}:{node.lineno}: tags {sorted(bad)} not in "
                f"metric {mname!r}'s declared tag_keys "
                f"{list(declared)} ({self.qualname()}) — the record call "
                "raises ValueError at runtime; declare the key or fix the "
                "typo",
            )
        )

    def _check_tag_dict(
        self, call: ast.Call, dict_node: ast.AST, mname, declared
    ) -> None:
        if declared is None or not isinstance(dict_node, ast.Dict):
            return
        keys: List[str] = []
        for k in dict_node.keys:
            s = _literal_str(k) if k is not None else None
            if s is None:
                return  # dynamic key: out of static reach
            keys.append(s)
        bad = [k for k in keys if k not in declared]
        if bad:
            self._flag(call, mname or "<dynamic>", bad, declared)

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        if isinstance(func, ast.Attribute) and func.attr in _RECORD_METHODS:
            info = None
            ctor = (
                func.value
                if isinstance(func.value, ast.Call)
                and _ctor_type(func.value) is not None
                else None
            )
            if ctor is not None:  # Gauge(...).set_default_tags({...})
                info = _ctor_info(ctor)
                info = (info[1], info[2]) if info else None
            else:
                dn = dotted_name(func.value)
                if dn is not None:
                    info = self.vars.get(dn)
            if info is not None:
                mname, declared = info
                if func.attr == "set_default_tags":
                    if node.args:
                        self._check_tag_dict(node, node.args[0], mname, declared)
                else:
                    for kw in node.keywords:
                        if kw.arg == "tags":
                            self._check_tag_dict(node, kw.value, mname, declared)
        self.generic_visit(node)


def scan_file(path: str, rel: str) -> List[Violation]:
    if rel == "ray_tpu_torch/util/metrics.py":
        return []  # the metric classes themselves live here
    tree = parse_file(path)
    if tree is None:
        return []
    s = _Scanner(rel)
    s.visit(tree)
    return s.violations
