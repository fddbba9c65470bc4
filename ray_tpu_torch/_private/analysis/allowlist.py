"""Allowlist of reviewed concurrency-lint findings.

Format — one entry per line, key and a MANDATORY one-line justification:

    <violation key> | <why this site is acceptable>

Keys carry no line numbers (pass:file:scope:detail), so unrelated edits
don't churn the file.  Hand-edit justifications freely; regenerate the
key set deliberately with `scripts/ray_tpu_lint.py --fix-allowlist`
(which preserves existing justifications and marks new keys TODO).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

HEADER = (
    "# Concurrency-lint allowlist — reviewed findings with justifications.\n"
    "# Format: <violation key> | <one-line justification>\n"
    "# Regenerate keys with: python scripts/ray_tpu_lint.py --fix-allowlist\n"
)

TODO_JUSTIFICATION = "TODO: justify"


def load(path: str) -> Dict[str, str]:
    entries: Dict[str, str] = {}
    with open(path, "r", encoding="utf-8") as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            key, sep, why = line.partition("|")
            entries[key.strip()] = why.strip() if sep else ""
    return entries


def save(path: str, entries: Dict[str, str]) -> None:
    with open(path, "w", encoding="utf-8") as f:
        f.write(HEADER)
        for key in sorted(entries):
            f.write(f"{key} | {entries[key] or TODO_JUSTIFICATION}\n")


def unjustified(entries: Dict[str, str]) -> List[str]:
    return sorted(
        k for k, why in entries.items()
        if not why or why == TODO_JUSTIFICATION
    )


def regenerate(
    existing: Dict[str, str], current_keys: List[str]
) -> Tuple[Dict[str, str], List[str], List[str]]:
    """(new entries, added keys, dropped keys): current violations become
    the key set; justifications survive for keys that persist."""
    new = {
        k: existing.get(k, TODO_JUSTIFICATION) for k in current_keys
    }
    added = sorted(set(current_keys) - set(existing))
    dropped = sorted(set(existing) - set(current_keys))
    return new, added, dropped
