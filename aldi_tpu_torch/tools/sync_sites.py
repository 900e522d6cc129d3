"""Where one DAOD step or one serving request makes the host wait for the
card, and which ``aldi/sync/<site>`` range covers each wait.

Builds the configuration's detector at full width with seeded weights
(``chip_smoke.py``'s helpers) and runs a warm-up DAOD step of 4 + 4
synthetic images (``--serve``: a warm-up request of 8 synthetic images
from pinned host memory through ``make_serving_fn``), then one more under
``torch.cuda.set_sync_debug_mode("warn")`` and ``torch.profiler``, so the
port's ranges (``utils/tracing.py``) are on: every operator that
synchronizes the host with the card (a device tensor read on the host, a
copy from host memory) warns, and each warning's call site in the port is
counted with the innermost ``aldi/sync/*`` range open around it. Prints
each site (the innermost four frames of the port) with its count and its
range, or "unspanned", most frequent first; exits 1 if a site is
unspanned.

Run from the repository root on a machine with a CUDA card::

    python3 -m aldi_tpu_torch.tools.sync_sites [--config vit] [--serve]
"""

import argparse
import collections
import importlib.util
import os
import sys
import traceback
import warnings

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MARK = "sync_sites/"  # the profiler range recorded at each warning
UNSPANNED = "unspanned"


def site_of(stack) -> str:
    """A warning's call site: the innermost four frames of the port."""
    frames = [f for f in stack
              if f"{os.sep}aldi_tpu_torch{os.sep}" in f.filename
              and not f.filename.endswith(f"tools{os.sep}sync_sites.py")]
    return "\n    ".join(
        f"{os.path.relpath(f.filename, ROOT)}:{f.lineno} {f.line}"
        for f in frames[-4:]) or "outside the port"


def covering_range(event) -> str:
    """The innermost ``aldi/sync/*`` range around a profiler event."""
    e = event.cpu_parent
    while e is not None and not e.name.startswith("aldi/sync/"):
        e = e.cpu_parent
    return UNSPANNED if e is None else e.name


def record(fn, device) -> collections.Counter:
    """Runs ``fn`` under a profiler (and, on a card, the sync debug mode)
    and counts the warnings it raises: {(call site, covering range): n}."""
    sites, inside = [], [False]

    def seen(message, category, filename, lineno, file=None, line=None):
        if not inside[0]:  # e.g. the mode's own notice
            return
        with torch.profiler.record_function(MARK + str(len(sites))):
            sites.append(site_of(traceback.extract_stack()[:-1]))

    acts = [torch.profiler.ProfilerActivity.CPU]
    saved = warnings.showwarning
    warnings.showwarning = seen
    try:
        with warnings.catch_warnings(), \
                torch.profiler.profile(activities=acts) as prof:
            warnings.simplefilter("always")
            if device.type == "cuda":
                torch.cuda.set_sync_debug_mode("warn")
            inside[0] = True
            try:
                fn()
            finally:
                inside[0] = False
                if device.type == "cuda":
                    torch.cuda.set_sync_debug_mode(0)
    finally:
        warnings.showwarning = saved
    ranges = {int(e.name[len(MARK):]): covering_range(e)
              for e in prof.events() if e.name.startswith(MARK)}
    return collections.Counter((site, ranges.get(i, UNSPANNED))
                               for i, site in enumerate(sites))


def report(counts, what) -> int:
    """Prints the sites; 1 if one is unspanned, else 0."""
    print(f"{sum(counts.values())} host synchronizations in {what}, by "
          f"call site:")
    for (site, name), n in counts.most_common():
        print(f"{n} x [{name}]\n    {site}")
    return int(any(name == UNSPANNED for _, name in counts))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", choices=("r50", "vit"), default="r50")
    parser.add_argument("--serve", action="store_true",
                        help="one request through make_serving_fn instead "
                             "of a DAOD step")
    args = parser.parse_args(argv)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    from aldi_tpu_torch.config import get_cfg
    from aldi_tpu_torch.engine import train_step as ts
    from aldi_tpu_torch.engine.export import make_serving_fn
    from aldi_tpu_torch.models import build_detector

    cfg = get_cfg()
    cfg.merge_from_file(cs.VIT_ALDI if args.config == "vit" else cs.FLAGSHIP)
    cfg.SOLVER.IMS_PER_BATCH = 2 * cs.TRAIN_IMAGES
    det = build_detector(cfg)
    gen = torch.Generator(device="cuda").manual_seed(1)
    if args.serve:
        fn = make_serving_fn(det, cs.seeded_weights(det, seed=0))
        images, sizes = cs.synthetic_request(gen, det.canvas)
        images, sizes = images.cpu().pin_memory(), sizes.cpu()
        fn(images, sizes)
        torch.cuda.synchronize()
        counts = record(lambda: fn(images, sizes), det.device)
        what = (f"one {cfg.MODEL.BACKBONE.NAME} request of {cs.BATCH} "
                f"images")
    else:
        state = ts.create_train_state(cfg, det,
                                      cs.seeded_weights(det, seed=0))
        step = ts.make_train_step(cfg, det)
        batches = [cs.synthetic_train_batch(gen, det.canvas, cfg.TPU.MAX_GT,
                                            det.num_classes,
                                            cs.TRAIN_IMAGES)
                   for _ in range(2)]
        draws = [ts.draw_step(gen, det, cs.TRAIN_IMAGES, cs.TRAIN_IMAGES)
                 for _ in range(2)]
        state, _ = step(state, batches[0], draws[0])
        torch.cuda.synchronize()
        counts = record(lambda: step(state, batches[1], draws[1]),
                        det.device)
        what = (f"one {cfg.MODEL.BACKBONE.NAME} DAOD step of "
                f"{cs.TRAIN_IMAGES} + {cs.TRAIN_IMAGES} images")
    return report(counts, what)


if __name__ == "__main__":
    sys.exit(main())
