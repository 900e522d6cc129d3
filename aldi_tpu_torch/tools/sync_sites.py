"""Where one DAOD step makes the host wait for the card.

Builds the configuration's detector at full width with seeded weights
(``chip_smoke.py``'s helpers), runs a warm-up DAOD step of 4 + 4
synthetic images and then one more under
``torch.cuda.set_sync_debug_mode("warn")``: every operator that
synchronizes the host with the card (a device tensor read on the host, a
copy from pageable host memory) warns, and each warning's call site in the
port is counted. Prints each site (the innermost four frames of the port)
with its count, most frequent first.

Run from the repository root on a machine with a CUDA card::

    python3 -m aldi_tpu_torch.tools.sync_sites [--config vit]
"""

import argparse
import collections
import importlib.util
import os
import traceback
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", choices=("r50", "vit"), default="r50")
    args = parser.parse_args()
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch

    from aldi_tpu_torch.config import get_cfg
    from aldi_tpu_torch.engine import train_step as ts
    from aldi_tpu_torch.models import build_detector

    cfg = get_cfg()
    cfg.merge_from_file(cs.VIT_ALDI if args.config == "vit" else cs.FLAGSHIP)
    cfg.SOLVER.IMS_PER_BATCH = 2 * cs.TRAIN_IMAGES
    det = build_detector(cfg)
    state = ts.create_train_state(cfg, det, cs.seeded_weights(det, seed=0))
    step = ts.make_train_step(cfg, det)
    gen = torch.Generator(device="cuda").manual_seed(1)
    batches = [cs.synthetic_train_batch(gen, det.canvas, cfg.TPU.MAX_GT,
                                        det.num_classes, cs.TRAIN_IMAGES)
               for _ in range(2)]
    draws = [ts.draw_step(gen, det, cs.TRAIN_IMAGES, cs.TRAIN_IMAGES)
             for _ in range(2)]
    state, _ = step(state, batches[0], draws[0])
    torch.cuda.synchronize()

    sites, in_step = collections.Counter(), [False]

    def count(message, category, filename, lineno, file=None, line=None):
        if not in_step[0]:  # e.g. the mode's own notice
            return
        frames = [f for f in traceback.extract_stack()[:-1]
                  if f"{os.sep}aldi_tpu_torch{os.sep}" in f.filename]
        sites["\n    ".join(
            f"{os.path.relpath(f.filename, ROOT)}:{f.lineno} {f.line}"
            for f in frames[-4:]) or "outside the port"] += 1

    saved = warnings.showwarning
    warnings.showwarning = count
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            in_step[0] = True
            try:
                step(state, batches[1], draws[1])
            finally:
                in_step[0] = False
                torch.cuda.set_sync_debug_mode(0)
    finally:
        warnings.showwarning = saved
    print(f"{sum(sites.values())} host synchronizations in one "
          f"{cfg.MODEL.BACKBONE.NAME} DAOD step of {cs.TRAIN_IMAGES} + "
          f"{cs.TRAIN_IMAGES} images, by call site:")
    for site, n in sites.most_common():
        print(f"{n} x\n    {site}")


if __name__ == "__main__":
    main()
