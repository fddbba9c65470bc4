"""The port's runtime microbenchmarks (`ray_tpu_torch._private.ray_perf`, a
copy of `ray_tpu`'s) and the CLI command that runs them.

Each of the eight benches runs at a small size on the port's runtime and
returns the keys the source's returns at the same size (the source's run in
a process of its own, so that this one starts only the port's runtime);
`microbenchmark --json` writes the suite's schema. Nothing here asserts a
rate: these are host numbers of a shared box.
"""

import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import ray_tpu_torch
from ray_tpu_torch._private import ray_perf
from ray_tpu_torch.scripts import cli

REPO = Path(__file__).resolve().parents[1]

# Each bench at a small size: (function name, keyword arguments).
SMALL = {
    "bench_tasks_sync": dict(n=20),
    "bench_tasks_async": dict(n=100, window=20),
    "bench_multi_client_tasks_async": dict(n_clients=2, n_per=50),
    "bench_actor_calls_sync": dict(n=20),
    "bench_actor_calls_async": dict(n=100, window=20),
    "bench_n_n_actor_calls_async": dict(n_actors=2, n_per=50),
    "bench_put_ops": dict(n=100),
    "bench_put_gigabytes": dict(total_gb=0.01, chunk_mb=2),
}

SOURCE_RUN = """
import json, sys
import ray_tpu
from ray_tpu._private import ray_perf

small = json.loads(sys.argv[1])
ray_tpu.init(num_cpus=4)
out = {}
for bench in ray_perf.ALL:
    r = bench(**small[bench.__name__])
    out[bench.__name__] = {"name": r["name"], "keys": sorted(r),
                           "copy_stats": sorted(r.get("copy_stats", {}))}
ray_tpu.shutdown()
print(json.dumps(out))
"""


def _shape(r: dict) -> dict:
    return {"name": r["name"], "keys": sorted(r), "copy_stats": sorted(r.get("copy_stats", {}))}


def test_microbenchmark_command_writes_the_suite_s_schema(tmp_path, monkeypatch):
    """`microbenchmark --json` (the suite at small sizes): a host note, then
    one record per bench in the source's order, as the file it writes."""
    monkeypatch.setattr(ray_perf, "ALL", [functools.partial(b, **SMALL[b.__name__])
                                          for b in ray_perf.ALL])
    out = tmp_path / "perf.json"
    assert cli.main(["microbenchmark", "--json", str(out)]) == 0
    assert not ray_tpu_torch.is_initialized()
    rows = json.loads(out.read_text())
    assert rows[0]["name"] == "host_note" and rows[0]["nproc"] == os.cpu_count()
    assert [r["name"] for r in rows[1:]] == [
        "single_client_tasks_sync", "single_client_tasks_async", "multi_client_tasks_async",
        "1_1_actor_calls_sync", "1_1_actor_calls_async", "n_n_actor_calls_async",
        "single_client_put_ops", "single_client_put_gigabytes"]
    for r in rows[1:-1]:
        assert r["ops_per_s"] > 0 and len(r["runs"]) == 3
    assert rows[-1]["gb_per_s"] > 0 and len(rows[-1]["runs"]) == 3


@pytest.fixture(scope="module")
def source_shapes():
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, "-c", SOURCE_RUN, json.dumps(SMALL)],
                         capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-800:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def port_runtime():
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()


def test_the_suite_is_the_source_s():
    assert [b.__name__ for b in ray_perf.ALL] == list(SMALL)


@pytest.mark.parametrize("bench", list(SMALL))
def test_bench_returns_the_source_s_keys(bench, source_shapes, port_runtime):
    r = getattr(ray_perf, bench)(**SMALL[bench])
    assert _shape(r) == source_shapes[bench]
    assert all(v > 0 for v in r["runs"])
