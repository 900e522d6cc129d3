"""Where one DAOD step's device time moves between trees of the repository.

Each ``name=tree`` argument names a checkout of the repository: this one
is ``.``, another may be a parent commit unpacked with ``git archive``
into a git-ignored directory. For each, in the order given, a child
process imports that tree's ``aldi_tpu_torch`` (and this tree's
``chip_smoke.py`` for the seeded weights, the synthetic batch and the
trace), builds the configuration's detector at full width, runs a warm-up
DAOD step of 4 + 4 images, traces one more (``chip_smoke.device_busy``)
and times 3 more on the host clock, each ending in a synchronize.
It reports the shape and strides of both strong views (``strong_augment``'s
outputs) and how many inputs of the warm-up step's convolutions (each
``aten.convolution`` call) are stored NHWC, NCHW or otherwise; then the
traced step's device busy time and each CUDA kernel's device time and
calls, and the 3 steps' times. Then the kernels whose time moved most
between the first two names are printed, each name's times the mean over
its runs.

Run from the repository root on a machine with a CUDA card::

    python3 -m aldi_tpu_torch.tools.step_diff --config vit \\
        old=build/parent new=. new=. old=build/parent
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TAG = "[step_diff json] "
TOP = 20  # kernels printed, by how far their time moved


def child(tree, config):
    """One tree's warm-up and traced step; prints its numbers as JSON."""
    sys.path.insert(0, os.path.abspath(tree))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from aldi_tpu_torch.config import get_cfg
    from aldi_tpu_torch.engine import train_step as ts
    from aldi_tpu_torch.models import build_detector

    cfg = get_cfg()
    cfg.merge_from_file(cs.VIT_ALDI if config == "vit" else cs.FLAGSHIP)
    cfg.SOLVER.IMS_PER_BATCH = 2 * cs.TRAIN_IMAGES
    det = build_detector(cfg)
    state = ts.create_train_state(cfg, det, cs.seeded_weights(det, seed=0))
    step = ts.make_train_step(cfg, det)
    gen = torch.Generator(device="cuda").manual_seed(2)
    batches = [cs.synthetic_train_batch(gen, det.canvas, cfg.TPU.MAX_GT,
                                        det.num_classes, cs.TRAIN_IMAGES)
               for _ in range(2)]
    draws = [ts.draw_step(gen, det, cs.TRAIN_IMAGES, cs.TRAIN_IMAGES)
             for _ in range(2)]
    views, convs = [], {"NHWC": 0, "NCHW": 0, "other": 0}
    augment = ts.strong_augment

    def view(*args):
        out = augment(*args)
        views.append([list(out.shape), list(out.stride())])
        return out

    class Convs(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten.convolution.default:
                x = args[0]
                convs["NHWC" if x.is_contiguous(
                    memory_format=torch.channels_last)
                      else "NCHW" if x.is_contiguous() else "other"] += 1
            return func(*args, **(kwargs or {}))

    ts.strong_augment = view
    with Convs():  # the warm-up step: views and convolution inputs
        state, _ = step(state, batches[0], draws[0])
    ts.strong_augment = augment
    traced = cs.device_busy(lambda: step(state, batches[1], draws[1]))
    if traced is None:
        raise SystemExit("the trace holds no device events")
    busy, _, per_kernel, _ = traced
    step_ms = []
    for _ in range(cs.TIMED_STEPS):  # host clock, as chip_smoke times steps
        t0 = time.perf_counter()
        state, _ = step(state, batches[1], draws[1])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    print(TAG + json.dumps({"busy_ms": busy, "step_ms": step_ms,
                            "views": views, "convs": convs,
                            "kernels": per_kernel}), flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("trees", nargs="*", help="name=path of a checkout")
    parser.add_argument("--config", choices=["r50", "vit"], default="r50")
    parser.add_argument("--child", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.child:
        return child(args.child, args.config)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    runs = []
    for spec in args.trees:
        name, tree = spec.split("=", 1)
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--child", tree, "--config", args.config],
                              capture_output=True, text=True)
        lines = [x for x in proc.stdout.splitlines() if x.startswith(TAG)]
        if proc.returncode or not lines:
            raise SystemExit(f"{spec} failed:\n{proc.stderr[-4000:]}")
        r = json.loads(lines[0][len(TAG):])
        runs.append((name, r))
        print(f"[step] {spec}, {args.config}: device busy "
              f"{r['busy_ms']:.2f} ms; steps after it "
              f"{', '.join(f'{x:.2f}' for x in r['step_ms'])} ms (median "
              f"{sorted(r['step_ms'])[len(r['step_ms']) // 2]:.2f}); "
              f"strong views (shape, strides) "
              f"{r['views']}; convolution inputs by storage {r['convs']}",
              flush=True)

    mean = {}
    for name in dict.fromkeys(n for n, _ in runs):
        rs = [r["kernels"] for n, r in runs if n == name]
        mean[name] = {k: [sum(r.get(k, (0, 0))[i] for r in rs) / len(rs)
                          for i in (0, 1)]
                      for k in set().union(*rs)}
    if len(mean) < 2:
        return
    (a, ka), (b, kb) = list(mean.items())[:2]

    def delta(k):
        return kb.get(k, (0, 0))[0] - ka.get(k, (0, 0))[0]

    keys = sorted(set(ka) | set(kb), key=lambda k: -abs(delta(k)))
    print(f"[step] kernel time {b} - {a}: {sum(map(delta, keys)):+.3f} ms "
          f"in all; the {TOP} kernels that moved most:", flush=True)
    for k in keys[:TOP]:
        (ma, na), (mb, nb) = ka.get(k, (0, 0)), kb.get(k, (0, 0))
        print(f"[step] {delta(k):+9.3f} ms ({a} {ma:.3f} ms x{na:g}, {b} "
              f"{mb:.3f} ms x{nb:g}) {k[:160]}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
