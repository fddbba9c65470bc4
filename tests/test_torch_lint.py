"""The port's static-analysis lint (`ray_tpu_torch._private.analysis` and
scripts/ray_tpu_torch_lint.py, copies of `ray_tpu`'s, package name
rewritten).

The lint runs over the port's whole tree, which holds modules the JAX lint
never saw (the kernels' wrappers and builder, the models, the parallel
layer, the learners, card ids), and must be clean there, with its committed
catalogs fresh. Its passes must find what the source's find: every
seeded-violation fixture of tests/test_concurrency_lint.py, written out as a
tree, gives the same findings from both packages, with the port's fixture,
paths and keys rewritten by the copy's rule.
"""

import ast
import contextlib
import io
import json
import os
import re
import sys
import textwrap
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))

import ray_tpu_torch_lint  # noqa: E402
from ray_tpu_torch._private import analysis as port_analysis  # noqa: E402
from ray_tpu_torch._private.analysis import (  # noqa: E402
    fault_registry,
    knob_registry,
    metric_names,
    span_names,
)
from ray_tpu_torch._private.analysis.common import iter_py_files  # noqa: E402

ANALYSIS = REPO / "ray_tpu_torch" / "_private" / "analysis"
# The passes that scan one file at a time, by module name.
FILE_PASSES = ("blocking", "lock_order", "hot_send", "gcs_mutation", "journal_coverage",
               "metric_names", "copy_coverage", "wire_schema", "knob_registry")


def _rewrite(text: str) -> str:
    return re.sub(r"\bray_tpu\b", "ray_tpu_torch", text)


def _fixtures() -> dict:
    """tests/test_concurrency_lint.py's fixtures by the function that writes
    them: its `_write(tmp_path, name, source)` files (with those of the
    helpers it calls) and the display paths it scans them under."""
    tree = ast.parse((REPO / "tests" / "test_concurrency_lint.py").read_text())
    found = {}
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        files, rels, calls = [], set(), set()
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            if isinstance(node.func, ast.Name):
                calls.add(node.func.id)
                if node.func.id == "_write":
                    files.append((node.args[1].value, textwrap.dedent(node.args[2].value)))
            elif isinstance(node.func, ast.Attribute) and node.func.attr == "scan_file" \
                    and isinstance(node.args[1], ast.Constant):
                rels.add(node.args[1].value)
        found[fn.name] = (files, rels, calls)
    out = {}
    for name, (files, rels, calls) in found.items():
        helpers = [found[c][0] for c in sorted(calls) if c in found and c != name]
        files = [f for h in helpers for f in h] + files
        if files and name.startswith("test_"):
            out[name] = (files, sorted(rels))
    return out


FIXTURES = _fixtures()


def _findings(violations, rewrite: bool) -> list:
    f = _rewrite if rewrite else (lambda s: s)
    return [(v.pass_name, f(v.rel), v.line, f(v.key), f(v.message)) for v in violations]


def test_fixtures_are_the_lint_tests_seeded_trees():
    assert len(FIXTURES) >= 30
    assert "test_blocking_detects_sleep_under_with_lock" in FIXTURES
    files, _ = FIXTURES["test_fault_registry_flags_typod_point_and_proc"]
    assert [n for n, _ in files] == ["pkg.py", "spec_user.py"]


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_port_finds_what_the_source_finds(name, tmp_path):
    """Each pass on each fixture file, under each display path the test
    scans it as (the hot modules' names matter to hot-send, the GCS's to
    gcs-mutation), and the whole analysis over the fixture tree."""
    import importlib

    from ray_tpu._private import analysis as src_analysis

    files, rels = FIXTURES[name]
    trees = {}
    for side, rewrite in (("src", lambda s: s), ("port", _rewrite)):
        root = tmp_path / side / "tree"
        root.mkdir(parents=True)
        for fname, text in files:
            (root / fname).write_text(rewrite(text))
        trees[side] = root
    for pass_name in FILE_PASSES:
        src_pass = importlib.import_module(f"ray_tpu._private.analysis.{pass_name}")
        port_pass = importlib.import_module(f"ray_tpu_torch._private.analysis.{pass_name}")
        for fname, _ in files:
            for rel in sorted(set(rels) | {fname}):
                src = src_pass.scan_file(str(trees["src"] / fname), rel)
                port = port_pass.scan_file(str(trees["port"] / fname), _rewrite(rel))
                assert _findings(port, False) == _findings(src, True), (pass_name, fname, rel)
    src = src_analysis.run_analysis([str(trees["src"])], spec_roots=[str(trees["src"])])
    port = port_analysis.run_analysis([str(trees["port"])], spec_roots=[str(trees["port"])])
    assert _findings(port.violations, False) == _findings(src.violations, True)


def test_port_lint_is_clean_over_the_port_s_tree():
    """scripts/ray_tpu_torch_lint.py over ray_tpu_torch/ (its default): no
    new finding, no unjustified entry, the catalogs fresh; and it read the
    modules the JAX lint never sees (the kernel builder's reviewed site)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = ray_tpu_torch_lint.main(["--json"])
    report = json.loads(buf.getvalue())
    assert rc == 0 and report["ok"], [v for v in report["violations"] if not v["allowlisted"]]
    assert report["unjustified_allowlist"] == [] and report["stale_allowlist"] == []
    files = {v["file"] for v in report["violations"]}
    assert "ray_tpu_torch/ops/cuda/_build.py" in files
    assert not any(f.startswith("ray_tpu/") for f in files)


@pytest.mark.parametrize("catalog", ["fault_points", "metric_names", "span_names", "knob_names"])
def test_committed_catalog_is_fresh(catalog, tmp_path):
    """Each catalog regenerated over ray_tpu_torch/ equals the committed one."""
    files = iter_py_files(str(REPO / "ray_tpu_torch"))
    out = str(tmp_path / f"{catalog}.txt")
    if catalog == "fault_points":
        fault_registry.write_catalog(fault_registry.collect_points(files), out)
    elif catalog == "metric_names":
        metric_names.write_catalog(metric_names.collect_metrics(files), out)
    elif catalog == "span_names":
        span_names.write_catalog(span_names.collect_spans(files), out)
    else:
        knob_registry.write_catalog(out)
    assert Path(out).read_text() == (ANALYSIS / f"{catalog}.txt").read_text()


def test_allowlist_entries_are_justified():
    lines = [ln for ln in (ANALYSIS / "allowlist.txt").read_text().splitlines()
             if ln.strip() and not ln.startswith("#")]
    assert lines and all(" | " in ln for ln in lines)
    assert not [ln for ln in lines if "TODO" in ln.split(" | ", 1)[1]]
    paths = [p for ln in lines for p in re.findall(r"[\w/]+\.py", ln.split(" | ", 1)[0])]
    assert paths and all(p.startswith("ray_tpu_torch/") for p in paths)
    assert os.path.basename(ray_tpu_torch_lint.DEFAULT_ALLOWLIST) == "allowlist.txt"
    assert Path(ray_tpu_torch_lint.DEFAULT_ALLOWLIST).parent == ANALYSIS
