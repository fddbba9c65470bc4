#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result as the last line
of standard output:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's entry in BENCHMARK.json names its configuration; its file
`benchmark/workloads/<cell>.json` names its kind (`benchmark/kinds/<kind>.py`,
which sets up, measures for `--seconds` and checks the outputs) and holds its
traffic and limits. With `--trace 0` the result's metrics are the cell's
end-to-end metrics; with `--trace 1` its per-layer metrics, each read by
`benchmark/metrics/<metric>.py` from what the run recorded.

The run needs a CUDA card (as many as the cell asks for) and exits non-zero,
printing no result, without one, or if jax, flax or ray_tpu (the JAX
package) were loaded into this process.
"""

import time

T0 = time.perf_counter()  # set-up is timed from the start of the process

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Top-level module names that no run may load (compared whole: the port's
# name starts with the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "ray_tpu")


def hygiene() -> None:
    """Every build and kernel cache of the program inside the checkout, at
    fixed paths; what the runtime lets a caller place, under TMPDIR; no
    library loading JAX on its own. Workers inherit this environment, and
    find the `benchmark` package through PYTHONPATH."""
    cache = os.path.join(ROOT, "benchmark", ".cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("RAY_TPU_NATIVE_CACHE", "ray_tpu_native"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(cache, sub)
    import tempfile

    os.environ["RAY_TPU_PKG_CACHE"] = os.path.join(tempfile.gettempdir(), "raytpu-pkg-cache")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    path = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = ROOT + (os.pathsep + path if path else "")
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    hygiene()
    from benchmark import manifest

    bench = manifest.manifest()
    cell = manifest.workload(args.workload, bench)
    model = manifest.config(cell["config"])
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"run.py: {args.workload} needs {cell['chips']} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    out = manifest.kind(cell["kind"]).run(cell, model, args.seed, args.seconds,
                                           bool(args.trace), T0)
    found = forbidden_modules()
    if found:
        print(f"run.py: the run loaded {found}; the benchmark runs ray_tpu_torch alone",
              file=sys.stderr)
        return 4
    result = report(bench, cell["name"], out, bool(args.trace))
    print("readings " + json.dumps(_plain(out.get("readings"))), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


def _plain(x):
    """`x` with every dict key a string (a leaf's path joined by "/")."""
    if isinstance(x, dict):
        return {"/".join(k) if isinstance(k, tuple) else str(k): _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def _number(x):
    return x is not None and isinstance(x, (int, float)) and math.isfinite(x)


def report(bench: dict, cell: str, out: dict, trace: bool) -> dict:
    """The result line from what the kind returned: the cell's end-to-end
    metrics (untraced) or the per-layer metrics its readers find (traced),
    the device, and each compared number beside its limit, last."""
    from benchmark import manifest

    metrics, correct = {}, bool(out["correct"])
    if trace:
        for m in manifest.per_layer(bench, cell):
            value = manifest.reader(m["name"]).read(out["context"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in manifest.end_to_end(bench, cell):
            value = out["metrics"].get(m["name"])
            if _number(value):
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            else:
                correct = False  # a tail over failed requests has no number
    checks = {k: {"value": v, "limit": lim} for k, (v, lim) in out["checks"].items()}
    correct = correct and all(_number(c["value"]) and c["value"] <= c["limit"]
                              for c in checks.values())
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": dict(out["device"])}
    tr = out.get("trace")
    if trace and tr:
        result["device"].update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    result["checks"] = checks
    return result


if __name__ == "__main__":
    sys.exit(main())
