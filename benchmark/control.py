"""The control of a cell's comparison: the plain reference put in the
program's place and computed one precision below the configurations'
bfloat16, its products in float8 e4m3 (``reference/precision.py``), read
against the float32 reference exactly as a run reads the program.

    python3 -m benchmark.control --workload <cell> --seeds <n> [<n> ...]

prints one JSON line per seed with the control's readings and the cell's
limits; every seed has to read above a limit for the comparison to stand.
Not part of a benchmark run."""

import argparse
import json
import sys
import time

from . import compare, harness


def readings(cell, seed, device):
    """The control's readings of ``cell`` on ``seed``."""
    from .traffic import daod_step, serve

    if cell.kind == "daod_step":
        ref = daod_step.reference_run(cell, seed, device)
        ctl = daod_step.reference_run(cell, seed, device, products="fp8")
        return compare.train_readings(ctl, ref)
    w = cell.workload
    keys = list(range(min(w["check_requests"], w["pool"])))
    return serve.reference_check(cell, seed, device,
                                 [(k, None) for k in keys], products="fp8")


def main(argv=None, device=None, root=harness.ROOT, bench=harness.BENCH):
    p = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    harness.set_caches(root)
    cell = harness.Cell(args.workload, root, bench)
    import torch

    device = device or torch.device("cuda")
    for seed in args.seeds:
        t = time.perf_counter()
        r = readings(cell, seed, device)
        ok, rows = compare.judge(r, cell.workload["limits"])
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "control_correct": ok, "readings": r,
                          "limits": cell.workload["limits"],
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
