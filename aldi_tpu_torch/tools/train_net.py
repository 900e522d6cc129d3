#!/usr/bin/env python3
"""Training and evaluation entry point of the port, with the command line
of ``tools/train_net.py`` (``--config-file``, ``--eval-only``,
``--resume``, trailing ``KEY VALUE`` overrides):

    python3 -m aldi_tpu_torch.tools.train_net \\
        --config-file configs/cityscapes/ALDI-Best-Cityscapes.yaml \\
        [--eval-only] [--resume] [--num-gpus N] KEY VALUE ...

It runs on the CUDA cards; ``MODEL.DEVICE cpu`` runs it on the CPU.
``--num-gpus N`` trains data parallel (``aldi_tpu_torch/parallel``) in N
processes, one per card, as detectron2's ``launch`` does for the
reference: the ranks join one group (NCCL on the cards, gloo with
``MODEL.DEVICE cpu``, where the N processes share the CPU) at
``--dist-url`` (``auto``: a free port on this machine). ``--num-machines``
and ``--machine-rank`` join the machines' processes into one group, each
machine started with the same ``--dist-url tcp://HOST:PORT``. A process
that ``torchrun`` started (``torchrun --nproc-per-node N -m
aldi_tpu_torch.tools.train_net ...``) joins torchrun's group instead.
"""

import argparse
import os
import socket


def default_argument_parser():
    p = argparse.ArgumentParser(description="aldi_tpu_torch training")
    p.add_argument("--config-file", "--config", default="", metavar="FILE")
    p.add_argument("--eval-only", action="store_true")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--num-gpus", type=int, default=1,
                   help="processes (one per card) on this machine")
    p.add_argument("--num-machines", type=int, default=1)
    p.add_argument("--machine-rank", type=int, default=0)
    p.add_argument("--dist-url", default="auto",
                   help="the group's rendezvous: tcp://HOST:PORT or "
                        "file://PATH; auto: a free port on this machine")
    p.add_argument("opts", nargs=argparse.REMAINDER,
                   help="KEY VALUE config overrides")
    return p


def load_cfg(args):
    from aldi_tpu_torch.config import get_cfg

    cfg = get_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg.freeze()
    return cfg


def setup(args):
    """The config of ``args``, written to OUTPUT_DIR/config.yaml by rank
    0."""
    from aldi_tpu_torch.parallel.mesh import is_main

    cfg = load_cfg(args)
    if is_main():
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


def _device_type(cfg) -> str:
    return "cpu" if str(cfg.MODEL.DEVICE).lower() == "cpu" else "cuda"


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, main_func, args):
    """One rank of ``launch``: ``main_func(args)`` in the group."""
    return main_func(args)


def launch(main_func, args):
    """``main_func(args)`` in ``--num-gpus`` spawned processes of this
    machine's share of the group (detectron2's ``launch``, through
    ``parallel/mesh.py`` ``spawn``). A rank that fails stops the others and
    raises here. Returns rank 0's result (None on another machine)."""
    import torch

    from aldi_tpu_torch.parallel import mesh

    cfg = load_cfg(args)
    device_type = _device_type(cfg)
    if device_type == "cuda" and torch.cuda.device_count() < args.num_gpus:
        raise RuntimeError(
            f"--num-gpus {args.num_gpus} but {torch.cuda.device_count()} "
            "CUDA cards are available (MODEL.DEVICE cpu trains on the CPU)")
    dist_url = args.dist_url
    if dist_url == "auto":
        if args.num_machines > 1:
            raise ValueError("--dist-url auto needs --num-machines 1: give "
                             "every machine the same tcp://HOST:PORT")
        dist_url = f"tcp://127.0.0.1:{_free_port()}"
    results = mesh.spawn(_rank_main, args.num_gpus * args.num_machines,
                         dist_url, main_func, args, device_type=device_type,
                         nprocs=args.num_gpus,
                         first_rank=args.machine_rank * args.num_gpus)
    return results[0] if args.machine_rank == 0 else None


def main(args):
    from aldi_tpu_torch.parallel import mesh

    world = args.num_gpus * args.num_machines
    if (world > 1 and not mesh.is_initialized()
            and "WORLD_SIZE" not in os.environ):
        return launch(main, args)
    cfg = setup(args)
    from aldi_tpu_torch.engine.trainer import ALDITrainer

    trainer = ALDITrainer(cfg)
    trainer.resume_or_load(resume=args.resume)
    if args.eval_only:
        results = trainer.test()
        if mesh.is_main():
            print(results)
        if cfg.TEST.EXPECTED_RESULTS:
            assert verify_results(cfg, results)
        return results
    return trainer.train()


if __name__ == "__main__":
    main(default_argument_parser().parse_args())
