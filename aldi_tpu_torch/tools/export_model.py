#!/usr/bin/env python3
"""Export a trained detector's inference path to a serving artifact, with
the command line of ``tools/export_model.py``:

    python3 -m aldi_tpu_torch.tools.export_model \\
        --config-file configs/cityscapes/ALDI-Best-Cityscapes.yaml \\
        --weights out/model_final.pth --output out/serving --batch 8
    # smoke the artifact after writing it:
    python3 -m aldi_tpu_torch.tools.export_model ... --selftest

Weights load through the port's ``engine/checkpoint.py`` (the port's own
checkpoints, ALDI ``.pth`` files, plain state dicts, detectron2 ``.pkl``):
the student, or the EMA teacher with ``--ema``. ``--platforms`` defaults to
``cpu,cuda``; the detector is built on the card when ``cuda`` is among
them (which needs one), else on the CPU. See
``aldi_tpu_torch/engine/export.py`` for the artifact's contract.
"""

import argparse
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="aldi_tpu_torch serving export")
    p.add_argument("--config-file", required=True)
    p.add_argument("--weights", default=None,
                   help="checkpoint to export (default: cfg.MODEL.WEIGHTS; "
                        "'' exports fresh-init weights)")
    p.add_argument("--output", default=None,
                   help="artifact directory (default: OUTPUT_DIR/serving)")
    p.add_argument("--batch", type=int, default=1,
                   help="serving batch size baked into the artifact")
    p.add_argument("--platforms", default="cpu,cuda",
                   help="comma list of export targets (cpu, cuda)")
    p.add_argument("--ema", action="store_true",
                   help="export the EMA-teacher weights; without this flag "
                        "the student weights are exported (fresh loads are "
                        "done with load_from_ema=--ema so the student is "
                        "actually reachable in EMA-bearing checkpoints)")
    p.add_argument("--selftest", action="store_true",
                   help="reload the artifact and run one batch through each "
                        "exported platform")
    p.add_argument("opts", nargs=argparse.REMAINDER,
                   help="config overrides KEY VALUE ...")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import numpy as np

    from aldi_tpu_torch.config import get_cfg
    from aldi_tpu_torch.engine.checkpoint import Checkpointer
    from aldi_tpu_torch.engine.export import (export_inference, load_artifact,
                                              save_artifact)
    from aldi_tpu_torch.engine.train_step import create_train_state
    from aldi_tpu_torch.models import build_detector

    cfg = get_cfg()
    cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg.freeze()

    platforms = tuple(p.strip() for p in args.platforms.split(",")
                      if p.strip())
    det = build_detector(cfg, device="cuda" if "cuda" in platforms else "cpu")
    state = create_train_state(cfg, det)
    weights = cfg.MODEL.WEIGHTS if args.weights is None else args.weights
    if weights:
        # load_from_ema follows --ema: the default (student) export must not
        # silently receive EMA-preferred weights from a fresh load
        Checkpointer(cfg.OUTPUT_DIR).resume_or_load(
            state, weights, resume=False, load_from_ema=args.ema)
        print(f"loaded weights from {weights}"
              + (" (EMA preferred)" if args.ema else " (student)"))
    else:
        print("exporting fresh-initialized weights (no --weights given)")
    if args.ema:
        if state.teacher is None:
            raise SystemExit("--ema: the config keeps no EMA teacher "
                             "(EMA.ENABLED is off)")
        det.module.load_state_dict(state.teacher.state_dict())

    programs = export_inference(det, None, args.batch, platforms=platforms)
    out_dir = args.output or os.path.join(cfg.OUTPUT_DIR, "serving")
    save_artifact(out_dir, programs, det, cfg, args.batch)
    sizes_mb = ", ".join(
        f"{p}: {os.path.getsize(f'{out_dir}/serving.{p}.pt2') / 1e6:.1f} MB"
        for p in programs)
    print(f"wrote {out_dir} ({sizes_mb}; batch={args.batch}, "
          f"canvas={det.canvas})")

    if args.selftest:
        for platform in programs:
            model = load_artifact(out_dir, platform=platform)
            h, w = model.meta["canvas"]
            images = np.random.default_rng(0).uniform(
                0, 255, (args.batch, h, w, 3)).astype(np.float32)
            sizes = np.tile([[h, w]], (args.batch, 1)).astype(np.int32)
            out = model(images, sizes)
            n = int(out["valid"].sum())
            print(f"selftest OK ({platform}): {n} detections across "
                  f"{args.batch} images")


if __name__ == "__main__":
    main()
