#!/usr/bin/env python3
"""Training and evaluation entry point of the port, with the command line
of ``tools/train_net.py`` (``--config-file``, ``--eval-only``,
``--resume``, trailing ``KEY VALUE`` overrides):

    python3 -m aldi_tpu_torch.tools.train_net \\
        --config-file configs/cityscapes/ALDI-Best-Cityscapes.yaml \\
        [--eval-only] [--resume] KEY VALUE ...

It runs on one CUDA card; ``MODEL.DEVICE cpu`` runs it on the CPU.
``--num-gpus``, ``--num-machines``, ``--machine-rank`` and ``--dist-url``
are accepted for compatibility; more than one GPU or machine raises
(multi-GPU training is not ported yet: ROADMAP.md).
"""

import argparse
import os


def default_argument_parser():
    p = argparse.ArgumentParser(description="aldi_tpu_torch training")
    p.add_argument("--config-file", "--config", default="", metavar="FILE")
    p.add_argument("--eval-only", action="store_true")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--num-gpus", type=int, default=1)
    p.add_argument("--num-machines", type=int, default=1)
    p.add_argument("--machine-rank", type=int, default=0)
    p.add_argument("--dist-url", default="auto")
    p.add_argument("opts", nargs=argparse.REMAINDER,
                   help="KEY VALUE config overrides")
    return p


def setup(args):
    from aldi_tpu_torch.config import get_cfg

    if args.num_gpus > 1 or args.num_machines > 1:
        raise NotImplementedError(
            f"--num-gpus {args.num_gpus} --num-machines {args.num_machines}: "
            "multi-GPU training is not ported yet: ROADMAP.md lists it "
            "under multi-GPU data parallel")
    cfg = get_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg.freeze()
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    with open(os.path.join(cfg.OUTPUT_DIR, "config.yaml"), "w") as f:
        f.write(cfg.dump())
    return cfg


def verify_results(cfg, results) -> bool:
    """Check TEST.EXPECTED_RESULTS entries [dataset, metric, expected,
    tolerance] against the eval output (detectron2's ``verify_results``)."""
    ok = True
    for dataset, metric, expected, tolerance in cfg.TEST.EXPECTED_RESULTS:
        actual = results.get(dataset, {}).get(metric)
        if actual is None or abs(actual - expected) > tolerance:
            print(
                f"verify_results FAIL: {dataset}/{metric} = {actual} "
                f"(expected {expected} +/- {tolerance})"
            )
            ok = False
        else:
            print(f"verify_results OK: {dataset}/{metric} = {actual}")
    return ok


def main(args):
    cfg = setup(args)
    from aldi_tpu_torch.engine.trainer import ALDITrainer

    trainer = ALDITrainer(cfg)
    trainer.resume_or_load(resume=args.resume)
    if args.eval_only:
        results = trainer.test()
        print(results)
        if cfg.TEST.EXPECTED_RESULTS:
            assert verify_results(cfg, results)
        return results
    return trainer.train()


if __name__ == "__main__":
    main(default_argument_parser().parse_args())
