#!/usr/bin/env python3
"""One iteration's weak, strong and pseudo-labeled images, as PNGs with
their boxes.

Port of ``tools/debug_pipeline.py``: the port's ``WeakStrongLoader`` gives
the first batch; ``weak_{i}.png`` and ``strong_{i}.png`` (the strong view
of ``data/strong_aug.py``, its draws from ``torch.Generator`` seed 0) carry
the gt boxes; for a config with unlabeled images, ``pseudo_{i}.png``
carries the teacher's thresholded pseudo-labels (the model's weights, after
MODEL.WEIGHTS if set).

    python3 -m aldi_tpu_torch.tools.debug_pipeline --config-file <yaml> \\
        [--out debug_out] [--device cuda] [KEY VALUE ...]

It runs on the CUDA card unless ``--device cpu`` is given.
"""

import argparse
import os
import sys

import numpy as np
import torch


def draw(img_bgr_or_rgb, boxes, valid, path, color=(255, 60, 60), bgr=True):
    """An image [H, W, 3] with ``boxes`` [G, 4] where ``valid``, to
    ``path``."""
    from PIL import Image, ImageDraw

    arr = np.asarray(img_bgr_or_rgb, np.uint8)
    if bgr:
        arr = arr[:, :, ::-1]
    img = Image.fromarray(np.ascontiguousarray(arr))
    d = ImageDraw.Draw(img)
    for b, v in zip(np.asarray(boxes), np.asarray(valid)):
        if v:
            d.rectangle([float(b[0]), float(b[1]), float(b[2]), float(b[3])],
                        outline=color, width=2)
    img.save(path)


def run(cfg, out, device="cuda"):
    """The tool on a frozen config: writes the PNGs into ``out``. Returns
    the first batch (numpy), the strong views and, with unlabeled images,
    the pseudo-labels (``Instances`` on the CPU) and the teacher's
    metrics."""
    from ..data.loader import WeakStrongLoader
    from ..data.strong_aug import strong_aug_draws, strong_augment
    from ..engine.checkpoint import load_reference_weights
    from ..engine.train_step import create_train_state, draw_step
    from ..models import build_detector

    os.makedirs(out, exist_ok=True)
    bgr = cfg.INPUT.FORMAT.upper() == "BGR"
    detector = build_detector(cfg, device=device)
    batch = next(WeakStrongLoader(cfg, detector.canvas, seed=0))
    dev = detector.device
    gen = torch.Generator(device=dev).manual_seed(0)

    lab = batch["labeled"]
    aug = cfg.AUG
    n = lab["image"].shape[0]
    with torch.no_grad():
        strong = strong_augment(
            torch.from_numpy(lab["image"]).to(dev),
            torch.from_numpy(lab["sizes"]).to(dev),
            strong_aug_draws(gen, n, detector.canvas,
                             aug.LABELED_INCLUDE_RANDOM_ERASING,
                             aug.LABELED_MIC_AUG, aug.MIC_BLOCK_SIZE),
            aug.LABELED_INCLUDE_RANDOM_ERASING, aug.LABELED_MIC_AUG,
            aug.MIC_RATIO).cpu().numpy()
    for i in range(min(4, n)):
        draw(lab["image"][i], lab["boxes"][i], lab["valid"][i],
             os.path.join(out, f"weak_{i}.png"), bgr=bgr)
        draw(np.clip(strong[i], 0, 255).astype(np.uint8),
             lab["boxes"][i], lab["valid"][i],
             os.path.join(out, f"strong_{i}.png"), bgr=bgr)

    result = {"batch": batch, "strong": strong}
    u = batch["unlabeled"]
    m = u["image"].shape[0]
    if m:
        state = create_train_state(cfg, detector)
        if cfg.MODEL.WEIGHTS:
            load_reference_weights(state, cfg.MODEL.WEIGHTS)
        draws = draw_step(gen, detector, n, m)
        _, pseudo, metrics = detector.forward_teacher_ctx(
            state.student, torch.from_numpy(u["image"]).to(dev),
            torch.from_numpy(u["sizes"]).to(dev), draws.get("teacher"),
            threshold=cfg.DOMAIN_ADAPT.TEACHER.THRESHOLD,
            max_gt=cfg.TPU.MAX_GT)
        pseudo = type(pseudo)(*(None if x is None else x.cpu()
                                for x in (pseudo.boxes, pseudo.classes,
                                          pseudo.valid, pseudo.scores)))
        for i in range(min(4, m)):
            draw(u["image"][i], pseudo.boxes[i].numpy(),
                 pseudo.valid[i].numpy(),
                 os.path.join(out, f"pseudo_{i}.png"),
                 color=(60, 255, 60), bgr=bgr)
        result.update(pseudo=pseudo, metrics={
            k: float(v) for k, v in metrics.items()})
        print(f"avg pseudo labels/image: "
              f"{result['metrics']['num_pseudo_labels']:.2f}")
    print(f"wrote debug images to {out}/")
    return result


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config-file", "--config", required=True)
    p.add_argument("--out", default="debug_out")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    p.add_argument("opts", nargs="*")
    args = p.parse_args(argv)

    from ..config import get_cfg
    from ..data import datasets  # noqa: F401  (dataset registrations)

    cfg = get_cfg()
    cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg.freeze()
    return run(cfg, args.out, args.device)


if __name__ == "__main__":
    main(sys.argv[1:])
