#!/usr/bin/env python
"""Static-analysis lint CLI — ray_tpu_torch's TSAN/clang-annotation stand-in.

    python scripts/ray_tpu_lint.py [ray_tpu_torch/] [--fix-allowlist] [-v] [--json]

Runs the eleven analysis passes (blocking-under-lock, lock-order,
fault-registry, hot-send, gcs-mutation, journal-coverage, metric-names,
span-names, copy-coverage, wire-schema, knob-registry — see
ray_tpu_torch/_private/analysis/) over the package and exits non-zero on any
violation not covered by the reviewed allowlist
(ray_tpu_torch/_private/analysis/allowlist.txt).  Tier-1 tests run this same
entry point (tests/test_concurrency_lint.py), so a new blocking call
under a lock — or a frame send that drifts from wire.SCHEMAS — fails CI
before it costs a chaos soak to find.

--fix-allowlist regenerates the allowlist DELIBERATELY (the only
sanctioned way to grow it): current findings become the key set, existing
justifications are preserved, new keys are marked "TODO: justify" (which
the lint then reports until a human writes the reason).  It also rewrites
the generated catalogs (fault_points.txt, metric_names.txt,
span_names.txt, knob_names.txt); a committed catalog that doesn't match
regeneration fails the lint (the "forgot to regenerate" gap).

--json emits a machine-readable report (per-pass findings/new counts,
per-pass timing in seconds, every violation) instead of the text report.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO_ROOT not in sys.path:
    sys.path.insert(0, _REPO_ROOT)

from ray_tpu_torch._private.analysis import PASSES, run_analysis  # noqa: E402
from ray_tpu_torch._private.analysis import allowlist as allowlist_mod  # noqa: E402
from ray_tpu_torch._private.analysis import fault_registry  # noqa: E402
from ray_tpu_torch._private.analysis import knob_registry  # noqa: E402
from ray_tpu_torch._private.analysis import metric_names  # noqa: E402
from ray_tpu_torch._private.analysis import span_names  # noqa: E402
from ray_tpu_torch._private.analysis.common import iter_py_files  # noqa: E402

_ANALYSIS_DIR = os.path.join(_REPO_ROOT, "ray_tpu_torch", "_private", "analysis")
DEFAULT_ALLOWLIST = os.path.join(_ANALYSIS_DIR, "allowlist.txt")
DEFAULT_CATALOG = os.path.join(_ANALYSIS_DIR, "fault_points.txt")
DEFAULT_METRIC_CATALOG = os.path.join(_ANALYSIS_DIR, "metric_names.txt")
DEFAULT_SPAN_CATALOG = os.path.join(_ANALYSIS_DIR, "span_names.txt")
DEFAULT_KNOB_CATALOG = os.path.join(_ANALYSIS_DIR, "knob_names.txt")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "roots", nargs="*", default=[os.path.join(_REPO_ROOT, "ray_tpu_torch")],
        help="package dirs/files to analyze (default: ray_tpu_torch/)",
    )
    ap.add_argument(
        "--spec-roots", nargs="*",
        default=[os.path.join(_REPO_ROOT, "tests"), os.path.join(_REPO_ROOT, "scripts")],
        help="where fault-spec literals and knob env names are validated "
        "(default: tests/ scripts/)",
    )
    ap.add_argument("--allowlist", default=DEFAULT_ALLOWLIST)
    ap.add_argument("--catalog", default=DEFAULT_CATALOG)
    ap.add_argument("--metric-catalog", default=DEFAULT_METRIC_CATALOG)
    ap.add_argument("--span-catalog", default=DEFAULT_SPAN_CATALOG)
    ap.add_argument("--knob-catalog", default=DEFAULT_KNOB_CATALOG)
    ap.add_argument(
        "--no-catalog-check", action="store_true",
        help="skip the generated-catalog staleness checks (fixture trees)",
    )
    ap.add_argument(
        "--fix-allowlist", action="store_true",
        help="regenerate allowlist keys + the generated catalogs from "
        "current findings (preserves existing justifications)",
    )
    ap.add_argument(
        "--json", action="store_true", dest="json_out",
        help="machine-readable report: per-pass counts + timings, every "
        "violation, overall ok",
    )
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="also print allowlisted findings")
    args = ap.parse_args(argv)

    result = run_analysis(
        args.roots,
        spec_roots=args.spec_roots,
        allowlist_path=args.allowlist,
        catalog_path=None if args.no_catalog_check else args.catalog,
        metric_catalog_path=None if args.no_catalog_check else args.metric_catalog,
        span_catalog_path=None if args.no_catalog_check else args.span_catalog,
        knob_catalog_path=None if args.no_catalog_check else args.knob_catalog,
    )

    if args.fix_allowlist:
        files = [f for root in args.roots for f in iter_py_files(root)]
        points = fault_registry.collect_points(files)
        fault_registry.write_catalog(points, args.catalog)
        metrics = metric_names.collect_metrics(files)
        metric_names.write_catalog(metrics, args.metric_catalog)
        spans = span_names.collect_spans(files)
        span_names.write_catalog(spans, args.span_catalog)
        n_knobs = knob_registry.write_catalog(args.knob_catalog)
        # Catalog staleness violations are cured by the rewrites above, so
        # they never become allowlist entries.
        keys = sorted(
            {
                v.key
                for v in result.violations
                if not v.key.startswith("fault-registry:catalog:")
                and not v.key.startswith("metric-names:catalog:")
                and not v.key.startswith("span-names:catalog:")
                and not v.key.startswith("knob-registry:catalog:")
            }
        )
        existing = result.allowlist
        merged, added, dropped = allowlist_mod.regenerate(existing, keys)
        allowlist_mod.save(args.allowlist, merged)
        print(f"allowlist: {len(merged)} entries "
              f"(+{len(added)} new, -{len(dropped)} stale) -> {args.allowlist}")
        for k in added:
            print(f"  NEW (justify me): {k}")
        print(f"catalog: {len(points)} fault points -> {args.catalog}")
        print(
            f"catalog: {len(metrics)} metric names -> {args.metric_catalog}"
        )
        print(f"catalog: {len(spans)} span names -> {args.span_catalog}")
        print(f"catalog: {n_knobs} knob/wiring names -> {args.knob_catalog}")
        return 0

    todo = allowlist_mod.unjustified(result.allowlist)
    by_pass = {}
    for v in result.violations:
        by_pass.setdefault(v.pass_name, []).append(v)

    if args.json_out:
        report = {
            "ok": bool(not result.new and not todo),
            "passes": {
                p: {
                    "findings": len(by_pass.get(p, [])),
                    "allowlisted": sum(
                        1 for v in by_pass.get(p, [])
                        if v.key in result.allowlist
                    ),
                    "new": sum(
                        1 for v in by_pass.get(p, [])
                        if v.key not in result.allowlist
                    ),
                    "seconds": round(result.timings.get(p, 0.0), 4),
                }
                for p in PASSES
            },
            "violations": [
                {
                    "pass": v.pass_name,
                    "file": v.rel,
                    "line": v.line,
                    "key": v.key,
                    "message": v.message,
                    "allowlisted": v.key in result.allowlist,
                }
                for v in result.violations
            ],
            "unjustified_allowlist": todo,
            "stale_allowlist": result.stale_allowlist,
        }
        print(json.dumps(report, indent=2, sort_keys=True))
        return 0 if report["ok"] else 1

    for pass_name in PASSES:
        vs = by_pass.get(pass_name, [])
        new = [v for v in vs if v.key not in result.allowlist]
        print(
            f"[{pass_name}] {len(vs)} finding(s), "
            f"{len(vs) - len(new)} allowlisted, {len(new)} new "
            f"({result.timings.get(pass_name, 0.0):.3f}s)"
        )
        for v in new:
            print(f"  NEW: {v.message}")
        if args.verbose:
            for v in vs:
                if v.key in result.allowlist:
                    print(f"  allowlisted: {v.message}")
                    print(f"    reason: {result.allowlist[v.key]}")

    for k in todo:
        print(f"  UNJUSTIFIED allowlist entry (write a reason): {k}")
    for k in result.stale_allowlist:
        print(f"  note: stale allowlist entry (no longer fires): {k}")

    if result.new or todo:
        print(
            f"\nFAIL: {len(result.new)} new violation(s), "
            f"{len(todo)} unjustified allowlist entr(ies).  Fix the code, or "
            "review + run --fix-allowlist and write a justification."
        )
        return 1
    print("\nOK: no new static-analysis violations.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
