"""Project-specific concurrency static analysis (SURVEY §5.2).

The reference hardens its C++ concurrency with clang thread-safety
annotations (GUARDED_BY) + TSAN in CI; this Python runtime gets the
equivalent as an AST lint over the package, run by tier-1 tests and
`scripts/ray_tpu_lint.py`.  The original five passes:

  * blocking-under-lock (blocking.py) — calls from a catalog of blocking
    operations (time.sleep, conn.recv/sock.recv, .result(), wire
    send/recv, subprocess, faults.point delay-capable sites) made
    lexically inside a `with <lock>` body or between explicit
    acquire()/release();
  * lock-order (lock_order.py) — the per-module lock-acquisition graph
    from nested `with` statements plus same-module call edges; cycles are
    potential ABBA deadlock inversions;
  * fault-registry (fault_registry.py) — every faults.point("name") call
    site collected into a generated catalog
    (ray_tpu_torch/_private/analysis/fault_points.txt), and every literal
    RAY_TPU_FAULT_SPEC / faults.configure() spec in tests+scripts
    validated against it (a typo'd spec silently injects nothing — false
    robustness);
  * hot-send (hot_send.py) — direct `conn.send(...)` calls in the hot
    streaming modules are reviewed allowlist entries: a new one must
    route through wire.BatchingConn or justify bypassing coalescing
    (silent regressions back to one-syscall-per-frame fail CI);
  * gcs-mutation (gcs_mutation.py) — the journaled GCS tables (actor /
    named-binding / job) may only be written through the mutators in
    gcs.py: a direct dict write elsewhere takes effect in memory but
    skips the durability journal, so the mutation silently would not
    survive a head bounce.

Later passes extend the same machinery beyond locks: journal-coverage,
metric-names, span-names, copy-coverage, and the protocol conformance
plane —

  * wire-schema (wire_schema.py) — send sites and recv dispatch handlers
    cross-checked against the hand-maintained wire.SCHEMAS table
    (unknown kinds, arity drift, handlers assuming more fields than the
    schema min guarantees — the historical ready-arity and refs_push bug
    classes), plus the wire_native.KIND_IDS table as a schema subset;
  * knob-registry (knob_registry.py) — every literal RAY_TPU_* env
    access must resolve to a declared knob, alias, or wiring name
    (config.py); typo'd knobs silently no-op.  Generated catalog:
    knob_names.txt; dead knobs (declared, never read) also fail.

Existing, reviewed sites live in allowlist.txt with one-line
justifications; the lint fails only on NEW violations.  The runtime
twins of the static side are the opt-in lock watchdog
(ray_tpu_torch/_private/lock_watchdog.py, RAY_TPU_LOCK_WATCHDOG=1) and the
seeded wire fuzzer (scripts/wire_fuzz.py, tests/test_wire_fuzz.py).
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Sequence

from ray_tpu_torch._private.analysis.common import Violation, iter_py_files
from ray_tpu_torch._private.analysis import (
    blocking,
    copy_coverage,
    fault_registry,
    gcs_mutation,
    hot_send,
    journal_coverage,
    knob_registry,
    lock_order,
    metric_names,
    span_names,
    wire_schema,
)
from ray_tpu_torch._private.analysis import allowlist as allowlist_mod

PASSES = (
    "blocking-under-lock",
    "lock-order",
    "fault-registry",
    "hot-send",
    "gcs-mutation",
    "journal-coverage",
    "metric-names",
    "span-names",
    "copy-coverage",
    "wire-schema",
    "knob-registry",
)


class AnalysisResult:
    """All findings plus the allowlist split applied to them."""

    def __init__(
        self,
        violations: List[Violation],
        allowed: Dict[str, str],
        timings: Optional[Dict[str, float]] = None,
    ):
        self.violations = violations
        self.allowlist = allowed
        self.timings = timings or {}
        keys = {v.key for v in violations}
        self.new = [v for v in violations if v.key not in allowed]
        self.allowlisted = [v for v in violations if v.key in allowed]
        self.stale_allowlist = sorted(k for k in allowed if k not in keys)

    @property
    def ok(self) -> bool:
        return not self.new


def run_analysis(
    roots: Sequence[str],
    spec_roots: Optional[Sequence[str]] = None,
    allowlist_path: Optional[str] = None,
    catalog_path: Optional[str] = None,
    metric_catalog_path: Optional[str] = None,
    span_catalog_path: Optional[str] = None,
    knob_catalog_path: Optional[str] = None,
) -> AnalysisResult:
    """Run every pass over `roots` (package dirs or files).

    spec_roots: where fault-spec literals and knob env names are
    validated (tests/scripts); catalog_path / metric_catalog_path /
    span_catalog_path / knob_catalog_path: committed generated catalogs
    to check for staleness (None = skip, e.g. on fixture trees).
    Dead-knob detection is gated on knob_catalog_path too: fixture trees
    don't contain the package's knob readers."""
    timings: Dict[str, float] = {p: 0.0 for p in PASSES}

    def timed(pass_name, fn, *args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            timings[pass_name] += time.perf_counter() - t0

    files = []
    for root in roots:
        files.extend(iter_py_files(root))
    violations: List[Violation] = []
    for path, rel in files:
        violations.extend(timed("blocking-under-lock", blocking.scan_file, path, rel))
        violations.extend(timed("lock-order", lock_order.scan_file, path, rel))
        violations.extend(timed("hot-send", hot_send.scan_file, path, rel))
        violations.extend(timed("gcs-mutation", gcs_mutation.scan_file, path, rel))
        violations.extend(timed("journal-coverage", journal_coverage.scan_file, path, rel))
        violations.extend(timed("metric-names", metric_names.scan_file, path, rel))
        violations.extend(timed("copy-coverage", copy_coverage.scan_file, path, rel))
        violations.extend(timed("wire-schema", wire_schema.scan_file, path, rel))
        violations.extend(timed("knob-registry", knob_registry.scan_file, path, rel))
    violations.extend(timed("wire-schema", wire_schema.check_native))
    points = timed("fault-registry", fault_registry.collect_points, files)
    if catalog_path is not None:
        violations.extend(
            timed("fault-registry", fault_registry.check_catalog, points, catalog_path)
        )
    metrics = timed("metric-names", metric_names.collect_metrics, files)
    violations.extend(timed("metric-names", metric_names.check_duplicates, metrics))
    if metric_catalog_path is not None:
        violations.extend(
            timed("metric-names", metric_names.check_catalog, metrics, metric_catalog_path)
        )
    spans = timed("span-names", span_names.collect_spans, files)
    violations.extend(timed("span-names", span_names.check_duplicates, spans))
    if span_catalog_path is not None:
        violations.extend(
            timed("span-names", span_names.check_catalog, spans, span_catalog_path)
        )
    if knob_catalog_path is not None:
        violations.extend(
            timed("knob-registry", knob_registry.check_dead_knobs, files)
        )
        violations.extend(
            timed("knob-registry", knob_registry.check_catalog, knob_catalog_path)
        )
    spec_files = []
    for root in spec_roots or ():
        spec_files.extend(iter_py_files(root))
    # Specs validate against package points PLUS points the spec tree
    # itself visits (tests exercise the fault plane with synthetic
    # faults.point("p.x") calls; those are real points for their specs).
    known = dict(points)
    for name, locs in fault_registry.collect_points(spec_files).items():
        known.setdefault(name, []).extend(locs)
    violations.extend(
        timed("fault-registry", fault_registry.validate_spec_files, spec_files, known)
    )
    for path, rel in spec_files:
        violations.extend(
            timed("knob-registry", knob_registry.scan_spec_file, path, rel)
        )
    allowed = (
        allowlist_mod.load(allowlist_path) if allowlist_path and os.path.exists(allowlist_path)
        else {}
    )
    violations.sort(key=lambda v: (v.rel, v.line, v.key))
    return AnalysisResult(violations, allowed, timings)
