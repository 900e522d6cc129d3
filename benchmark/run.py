"""One run of one cell of the benchmark of ``aldi_tpu_torch``:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Loads, warms up the cell's shapes, measures
for ``--seconds`` (with ``--trace 1``: a traced window of at most that
long), checks the outputs against the plain reference and prints one JSON
line: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number compared
with its limit, which also end standard error. Exits non-zero, printing no
result, without as many CUDA cards as the cell asks for, or when JAX or
the JAX package was loaded."""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from . import compare, harness, trace  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def power_limit():
    """The card's power limit in W, as ``nvidia-smi`` reads it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20, check=True).stdout.split()
        return float(out[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def result(cell, rec, traced, device):
    """The result line's object for a driver's record."""
    correct, rows = compare.judge(rec["readings"], cell.workload["limits"])
    metrics = {}
    for name, unit in cell.metrics(traced):
        value = cell.reader(name).read(rec)
        if value is not None:
            metrics[name] = {"value": value, "unit": unit}
    if device.type == "cuda":
        kind, _ = harness.card()
        dev = {"platform": "gpu", "kind": kind, "count": cell.entry["chips"],
               "memory_peak_bytes": rec["memory_peak_bytes"],
               "power_limit_w": power_limit()}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    line = {"correct": correct, "attempted": rec["attempted"],
            "failed": rec["failed"], "metrics": metrics, "device": dev}
    if traced and rec.get("trace"):
        t = rec["trace"]
        dev.update(busy_s=t["busy_s"], window_s=t["window_s"])
        line["breakdown"] = {"device_ops": trace.top_device_ops(t),
                             "idle_gaps": trace.idle_gaps(t)}
    line["checks"] = {name: {"value": value, "limit": limit}
                      for name, value, limit in rows}
    return line


def main(argv=None, device=None, fault=None, root=harness.ROOT,
         bench=harness.BENCH):
    """A run; ``device`` and ``fault`` are for the benchmark's own tests
    (a CPU run at a tiny size, the timed path broken underneath), which
    skip the look for a card."""
    args = parse(argv)
    harness.set_caches(root)
    cell = harness.Cell(args.workload, root, bench)
    import torch

    if device is None:
        chips = cell.entry["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"benchmark: cell {cell.name} needs {chips} CUDA card(s); "
                  f"this machine has "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda")
    rec = cell.driver().run(cell, args.seed, args.seconds, bool(args.trace),
                            device, T0, fault)
    bad = harness.forbidden_modules()
    if bad:
        print(f"benchmark: modules of JAX or the JAX package were loaded: "
              f"{bad}", file=sys.stderr)
        return 3
    line = result(cell, rec, bool(args.trace), device)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
