"""BENCHMARK.json keeps to its contract, and every cell's files are found by
name: adding a cell, a configuration or a metric adds files and entries and
edits none."""

import hashlib
import json
import re
import shutil

import pytest

from benchmark import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = manifest.manifest()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"] and 1 <= BENCH["run_seconds"] <= 51
    assert len(BENCH["command"]) <= 32 and BENCH["command"][1] == "benchmark/run.py"
    # A full check of 24 cells fits the driver's 43,200 seconds.
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert (manifest.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_names_units_and_keys():
    entries = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[kind]]
        assert len(names) == len(set(names))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert NAME.match(w["traffic"])


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_finds_its_files_and_reports_enough(cell):
    c = manifest.workload(cell, BENCH)
    m = manifest.config(c["config"])
    assert m["name"] == c["config"]
    assert hasattr(manifest.kind(c["kind"]), "run")
    e2e = [x["name"] for x in manifest.end_to_end(BENCH, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = manifest.per_layer(BENCH, cell)
    assert layer
    for metric in layer:
        assert callable(manifest.reader(metric["name"]).read)
        assert metric["moves"] in e2e


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_files(entry):
    path = manifest.ROOT / entry["file"]
    assert path.parent == manifest.BENCH_DIR / "configs"
    m = json.loads(path.read_text())
    assert m["source"] == entry["source"] and m["name"] == entry["name"]
    assert entry["reduced"] == []


def _digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_cell_needs_no_edit(tmp_path, monkeypatch):
    """A copy of the benchmark gains a cell with its own traffic file, a new
    configuration and a new per-layer metric with its reader: files and
    entries only. The harness finds all of them and no file changed."""
    root = tmp_path / "checkout"
    shutil.copytree(manifest.BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    bench = json.loads(json.dumps(BENCH))
    before = _digest(root / "benchmark")
    (root / "benchmark" / "configs" / "new-model.json").write_text(
        json.dumps(dict(manifest.config("internlm2-1.8b"), name="new-model")))
    (root / "benchmark" / "workloads" / "new-model.train-1k.json").write_text(
        json.dumps(dict(json.loads((manifest.BENCH_DIR / "workloads"
                                    / "internlm2-1.8b.train-4k.json").read_text()),
                        traffic={"batch": 16, "seq": 1024})))
    (root / "benchmark" / "metrics" / "ce_ms.train.py").write_text(
        "def read(ctx):\n    return None\n")
    bench["configs"].append({"name": "new-model", "source": "https://example.org/new",
                             "file": "benchmark/configs/new-model.json", "reduced": [],
                             "why": "x"})
    bench["workloads"].append({"name": "new-model.train-1k", "config": "new-model",
                               "traffic": "train-1k", "chips": 1, "why": "x"})
    tokens = next(m for m in bench["end_to_end"] if m["name"] == "train_tokens_per_s")
    tokens["workloads"].append("new-model.train-1k")
    bench["per_layer"].append({"name": "ce_ms.train", "unit": "ms", "better": "lower",
                               "source": "device_trace", "layer": "loss",
                               "moves": "train_tokens_per_s", "workloads": ["new-model.train-1k"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(manifest, "ROOT", root)
    monkeypatch.setattr(manifest, "BENCH_DIR", root / "benchmark")
    cell = manifest.workload("new-model.train-1k", manifest.manifest())
    assert manifest.config(cell["config"])["name"] == "new-model"
    assert cell["traffic"] == {"batch": 16, "seq": 1024}
    assert [m["name"] for m in manifest.end_to_end(manifest.manifest(), cell["name"])] == [
        "train_tokens_per_s", "setup_s"]
    names = [m["name"] for m in manifest.per_layer(manifest.manifest(), cell["name"])]
    assert names == ["ce_ms.train"]
    assert manifest.reader("ce_ms.train").read({}) is None
    after = _digest(root / "benchmark")
    assert {k: v for k, v in after.items() if k in before} == before
