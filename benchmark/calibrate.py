#!/usr/bin/env python3
"""The readings a training cell's limits are set from, on the chip, printed
as one JSON line per seed (the runs of the benchmark never call this): for
each of `--seeds`, the program's compared numbers (its checked steps from
the seed, against the float32 reference), and for each of `--control-seeds`
those of the control, the reference computed from float8 e4m3 operands in
the program's place, and of the planted fault "half the batch left out, the
mean taken over the rest", the reference on the first half of each batch's
rows.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2 --control-seeds 3,4,5
"""

import argparse
import json
import sys
import time

import run  # noqa: F401 - the run's environment and path


def _ints(text):
    return [int(x) for x in text.split(",") if x]


def train(cell, m, seeds, control_seeds):
    import gc

    import torch

    from benchmark import manifest

    kind = manifest.kind("train")
    for seed in sorted(set(seeds) | set(control_seeds)):
        t = time.perf_counter()
        line = {"seed": seed}
        ref = None
        if seed in seeds:
            ctx, state, ours = kind.build(cell, m, seed)
            del ctx, state
            gc.collect()
            torch.cuda.empty_cache()
            ref = kind.reference_readings(cell, m, seed)
            line["program"] = kind.gaps(ours, ref)
            line["losses"] = {"program": ours["losses"], "reference": ref["losses"]}
        if seed in control_seeds:
            ref = ref or kind.reference_readings(cell, m, seed)
            fp8 = kind.reference_readings(cell, m, seed, quant="fp8")
            line["control_fp8"] = kind.gaps(fp8, ref)
            half = kind.reference_readings(cell, m, seed, rows=cell["traffic"]["batch"] // 2)
            line["fault_half_batch"] = kind.gaps(half, ref)
        line["s"] = time.perf_counter() - t
        print(json.dumps(line), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args()
    run.hygiene()
    from benchmark import manifest

    bench = manifest.manifest()
    cell = manifest.workload(args.workload, bench)
    m = manifest.config(cell["config"])
    train(cell, m, _ints(args.seeds), _ints(args.control_seeds))
    return 0


if __name__ == "__main__":
    sys.exit(main())
