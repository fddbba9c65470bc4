"""Everything a run finds by name: the manifest (BENCHMARK.json at the root
of the checkout), a cell's file `benchmark/workloads/<cell>.json`, its
configuration `benchmark/configs/<config>.json`, the configuration's model
family `benchmark/families/<family>.py`, its kind's driver
`benchmark/kinds/<kind>.py` and each per-layer metric's reader
`benchmark/metrics/<metric>.py`. Adding a cell, a configuration, a family or
a metric adds files and entries; no file here changes."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def manifest() -> Dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def workload(name: str, bench: Dict) -> Dict:
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    with open(BENCH_DIR / "workloads" / f"{name}.json") as f:
        cell = json.load(f)
    cell.update(name=name, config=entry["config"], traffic_name=entry["traffic"],
                chips=entry["chips"])
    return cell


def config(name: str) -> Dict:
    with open(BENCH_DIR / "configs" / f"{name}.json") as f:
        return json.load(f)


def _load(path: Path, module_name: str):
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def kind(name: str):
    return _load(BENCH_DIR / "kinds" / f"{name}.py", f"benchmark.kinds.{name}")


def family(m: Dict):
    """The module of configuration `m`'s model family (`"family"`, `"dense"`
    where the file names none)."""
    name = m.get("family", "dense")
    return _load(BENCH_DIR / "families" / f"{name}.py", f"benchmark.families.{name}")


def reader(metric: str):
    return _load(BENCH_DIR / "metrics" / f"{metric}.py", f"benchmark.metrics.{metric}")


def end_to_end(bench: Dict, cell: str) -> List[Dict]:
    return [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]


def per_layer(bench: Dict, cell: str) -> List[Dict]:
    """The cell's per-layer metrics: those that list it, and those without a
    list that move an end-to-end metric the cell reports."""
    mine = {m["name"] for m in end_to_end(bench, cell)}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in mine)]
