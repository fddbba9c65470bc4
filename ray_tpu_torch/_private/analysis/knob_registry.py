"""Pass 11: knob registry — every RAY_TPU_* env literal must be declared.

The config table (config.py _DEFS) is the single source of truth for
runtime knobs, env-overridable as RAY_TPU_<NAME>.  But nothing
cross-checked the literals: a typo'd env name in code or a test
(`RAY_TPU_WIRE_BATCH_BYTE`) silently no-ops — the exact failure mode the
fault-registry pass killed for fault specs.  This pass closes it:

  * unknown — a literal RAY_TPU_* env name in an ACCESS position
    (environ get/setdefault/pop/subscript/membership, env-dict keys,
    setenv calls) that is neither a knob env form, a declared alias
    (config._ENV_ALIASES), nor declared process wiring
    (config.WIRING_ENV) fails the lint;
  * bypass — a READ of a knob's env form outside config.py skips the
    resolution order (_system_config > env > default) and the type
    coercion config.get() gives; deliberate ones (pre-config boot reads,
    bench save/restore of the env form) carry allowlist justifications;
  * get-unknown — config.get("name") with an undeclared literal raises
    KeyError at runtime; the lint finds it before a rarely-exercised
    path does;
  * dead — a knob declared in _DEFS that no config.get("name") literal
    anywhere in the package reads is dead weight (or a sign the reader
    was renamed and the table wasn't).

The generated catalog (knob_names.txt, one `<ENV_NAME> <kind>` line,
kind in knob|alias|wiring) is the greppable inventory; staleness against
the committed file fails the lint like the other catalogs.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ray_tpu_torch._private.analysis.common import Violation, dotted_name, parse_file

PASS = "knob-registry"

_ENV_RE = re.compile(r"^RAY_TPU_[A-Z0-9_]+$")

def _config_receivers(tree: ast.Module) -> Set[str]:
    """Names the config MODULE is bound to in this file — derived from
    its imports, so a local dict that happens to be called `config`
    never false-positives."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            if node.module and node.module.endswith("_private"):
                for alias in node.names:
                    if alias.name == "config":
                        out.add(alias.asname or alias.name)
        elif isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name.endswith("_private.config") and alias.asname:
                    out.add(alias.asname)
    return out

CATALOG_HEADER = (
    "# Generated knob catalog — do not edit by hand.\n"
    "# Regenerate with: python scripts/ray_tpu_lint.py --fix-allowlist\n"
    "# One `<ENV_NAME> <kind>` per line; kind: knob (config._DEFS row),\n"
    "# alias (config._ENV_ALIASES back-compat name), wiring\n"
    "# (config.WIRING_ENV process-bootstrap plumbing, not a knob).\n"
)


def _tables() -> Tuple[Set[str], Set[str], Set[str], Set[str]]:
    """(knob_names, knob_env, alias_env, wiring_env) from config.py."""
    from ray_tpu_torch._private import config

    knob_names = set(config._DEFS)
    knob_env = {f"RAY_TPU_{n.upper()}" for n in knob_names}
    alias_env = {a for t in config._ENV_ALIASES.values() for a in t}
    wiring_env = set(config.WIRING_ENV)
    return knob_names, knob_env, alias_env, wiring_env


class _Access:
    __slots__ = ("name", "line", "is_read")

    def __init__(self, name: str, line: int, is_read: bool):
        self.name = name
        self.line = line
        self.is_read = is_read


def _lit(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _environish(node: ast.AST) -> bool:
    """Is this expression os.environ (or a renamed import of it / os)?"""
    name = dotted_name(node)
    if name is None:
        return False
    return name.endswith("environ") or name in ("os", "_os", "_os2")


def _collect_accesses(tree: ast.Module) -> List[_Access]:
    """Every RAY_TPU_* string literal in an env ACCESS position.
    Mentions in docstrings/messages don't count; dict keys, setdefault,
    setenv and subscript writes count as plumbing (checked for typos but
    not as resolution bypasses)."""
    out: List[_Access] = []

    def env_name(node: ast.AST) -> Optional[str]:
        s = _lit(node)
        if s is not None and _ENV_RE.match(s):
            return s
        return None

    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            func = node.func
            attr = func.attr if isinstance(func, ast.Attribute) else None
            if attr in ("get", "getenv", "setdefault", "pop") and node.args:
                s = env_name(node.args[0])
                if s is not None:
                    is_read = attr in ("get", "getenv") and _environish(
                        func.value
                    )
                    out.append(_Access(s, node.lineno, is_read))
            elif attr in ("setenv", "delenv") and node.args:
                # pytest monkeypatch plumbing in spec roots
                s = env_name(node.args[0])
                if s is not None:
                    out.append(_Access(s, node.lineno, False))
        elif isinstance(node, ast.Subscript):
            s = env_name(node.slice)
            if s is not None:
                is_read = isinstance(node.ctx, ast.Load) and _environish(
                    node.value
                )
                out.append(_Access(s, node.lineno, is_read))
        elif isinstance(node, ast.Dict):
            for k in node.keys:
                if k is None:
                    continue
                s = env_name(k)
                if s is not None:
                    out.append(_Access(s, node.lineno, False))
        elif isinstance(node, ast.Compare) and len(node.ops) == 1:
            if isinstance(node.ops[0], (ast.In, ast.NotIn)):
                s = env_name(node.left)
                if s is not None and _environish(node.comparators[0]):
                    out.append(_Access(s, node.lineno, True))
    return out


def _config_get_literals(tree: ast.Module) -> List[Tuple[str, int]]:
    """(knob_name, line) for every <config receiver>.get("literal")."""
    receivers = _config_receivers(tree)
    if not receivers:
        return []
    out: List[Tuple[str, int]] = []
    for node in ast.walk(tree):
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "get"
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id in receivers
            and node.args
        ):
            s = _lit(node.args[0])
            if s is not None:
                out.append((s, node.lineno))
    return out


def scan_file(path: str, rel: str) -> List[Violation]:
    """Per-file checks: unknown env names, knob-env bypass reads, and
    config.get of undeclared knobs.  config.py itself is the registry and
    is exempt from the bypass check (it IS the resolver)."""
    tree = parse_file(path)
    if tree is None:
        return []
    knob_names, knob_env, alias_env, wiring_env = _tables()
    declared = knob_env | alias_env | wiring_env
    out: List[Violation] = []
    seen: Set[str] = set()
    is_config = rel.endswith("_private/config.py")
    for acc in _collect_accesses(tree):
        if acc.name not in declared:
            key = f"{PASS}:unknown:{rel}:{acc.name}"
            if key not in seen:
                seen.add(key)
                out.append(
                    Violation(
                        PASS, rel, acc.line, key,
                        f"{rel}:{acc.line}: env var {acc.name!r} is neither "
                        "a declared knob (config._DEFS), an alias "
                        "(config._ENV_ALIASES), nor declared wiring "
                        "(config.WIRING_ENV) — a typo'd knob silently "
                        "no-ops",
                    )
                )
        elif (
            acc.is_read
            and acc.name in (knob_env | alias_env)
            and not is_config
        ):
            key = f"{PASS}:bypass:{rel}:{acc.name}"
            if key not in seen:
                seen.add(key)
                out.append(
                    Violation(
                        PASS, rel, acc.line, key,
                        f"{rel}:{acc.line}: reads knob env {acc.name!r} "
                        "directly, bypassing config.get() resolution "
                        "(_system_config > env > default) and type "
                        "coercion — use config.get, or justify in the "
                        "allowlist",
                    )
                )
    for name, line in _config_get_literals(tree):
        if name not in knob_names:
            key = f"{PASS}:get-unknown:{rel}:{name}"
            if key not in seen:
                seen.add(key)
                out.append(
                    Violation(
                        PASS, rel, line, key,
                        f"{rel}:{line}: config.get({name!r}) — no such knob "
                        "in config._DEFS; this raises KeyError when the "
                        "path runs",
                    )
                )
    return out


def scan_spec_file(path: str, rel: str) -> List[Violation]:
    """Spec roots (tests/scripts): unknown-name check only.  Tests read
    and set env freely — that's harness plumbing, not a bypass — but a
    typo'd knob name in a test silently tests the default."""
    tree = parse_file(path)
    if tree is None:
        return []
    _knob_names, knob_env, alias_env, wiring_env = _tables()
    declared = knob_env | alias_env | wiring_env
    out: List[Violation] = []
    seen: Set[str] = set()
    for acc in _collect_accesses(tree):
        if acc.name not in declared:
            key = f"{PASS}:unknown:{rel}:{acc.name}"
            if key not in seen:
                seen.add(key)
                out.append(
                    Violation(
                        PASS, rel, acc.line, key,
                        f"{rel}:{acc.line}: env var {acc.name!r} is not a "
                        "declared knob/alias/wiring name — the test or "
                        "script silently exercises the default",
                    )
                )
    return out


def check_dead_knobs(
    files: Sequence[Tuple[str, str]]
) -> List[Violation]:
    """Knobs declared in _DEFS that no config.get("name") literal in the
    package reads.  (Readers always go through config.get — children
    receive the env form but still resolve it there.)"""
    knob_names, _knob_env, _alias_env, _wiring_env = _tables()
    read: Set[str] = set()
    for path, rel in files:
        tree = parse_file(path)
        if tree is None:
            continue
        for name, _line in _config_get_literals(tree):
            read.add(name)
    out: List[Violation] = []
    rel = "ray_tpu_torch/_private/config.py"
    for name in sorted(knob_names - read):
        out.append(
            Violation(
                PASS, rel, 0,
                f"{PASS}:dead:{name}",
                f"{rel}: knob {name!r} is declared but no "
                f"config.get({name!r}) literal in the package reads it — "
                "dead weight, or the reader was renamed without the table",
            )
        )
    return out


# --- catalog ----------------------------------------------------------------


def catalog_lines() -> List[str]:
    """`<ENV_NAME> <kind>` rows, sorted.  Derived from the config tables
    alone, so the catalog is deterministic for a given config.py."""
    _knob_names, knob_env, alias_env, wiring_env = _tables()
    rows = (
        [(n, "knob") for n in knob_env]
        + [(n, "alias") for n in alias_env]
        + [(n, "wiring") for n in wiring_env]
    )
    return [f"{n} {kind}" for n, kind in sorted(rows)]


def load_catalog(path: str) -> List[str]:
    if not os.path.exists(path):
        return []
    with open(path, "r", encoding="utf-8") as f:
        return [
            line.strip()
            for line in f
            if line.strip() and not line.lstrip().startswith("#")
        ]


def write_catalog(path: str) -> int:
    lines = catalog_lines()
    with open(path, "w", encoding="utf-8") as f:
        f.write(CATALOG_HEADER)
        for line in lines:
            f.write(line + "\n")
    return len(lines)


def check_catalog(path: str) -> List[Violation]:
    committed = load_catalog(path)
    actual = catalog_lines()
    if committed == actual:
        return []
    missing = sorted(set(actual) - set(committed))
    extra = sorted(set(committed) - set(actual))
    parts = []
    if missing:
        parts.append(f"missing {missing}")
    if extra:
        parts.append(f"stale {extra}")
    rel = os.path.basename(path)
    return [
        Violation(
            PASS, rel, 0,
            f"{PASS}:catalog:{rel}",
            f"{rel}: knob catalog is stale ({'; '.join(parts)}) — "
            "regenerate with scripts/ray_tpu_lint.py --fix-allowlist",
        )
    ]
