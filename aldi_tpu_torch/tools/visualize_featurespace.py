#!/usr/bin/env python3
"""PCA scatter of backbone features across two domains.

Port of ``tools/visualize_featurespace.py``: each image of the two
datasets (the port's ``TestLoader``) goes through the R-CNN backbone; its
pyramid level ``--level`` is averaged over the pixels, and the two sets of
vectors are projected together on their first two principal axes (a numpy
SVD). The scatter goes to ``--out`` with matplotlib, or, without
matplotlib, the coordinates [2 * num-images, 2] to ``--out``.npy.

    python3 -m aldi_tpu_torch.tools.visualize_featurespace \\
        --config-file <yaml> --datasets SOURCE TARGET [--weights FILE] \\
        [--num-images 50] [--level 0] [--out featurespace.png] \\
        [--device cuda] [KEY VALUE ...]

It runs on the CUDA card unless ``--device cpu`` is given.
"""

import argparse
import sys

import numpy as np
import torch


def pca_2d(x: np.ndarray) -> np.ndarray:
    """[N, D] -> the centred rows on the first two principal axes [N, 2]."""
    x = x - x.mean(0, keepdims=True)
    _, _, vt = np.linalg.svd(x, full_matrices=False)
    return x @ vt[:2].T


@torch.inference_mode()
def collect_features(cfg, detector, dataset, n_images, level, module=None):
    """Pixel-averaged pyramid level ``level`` of the first ``n_images``
    images of ``dataset``: [n, C] float32."""
    from ..data.loader import TestLoader

    feats = []
    loader = TestLoader(dataset, cfg, detector.canvas, batch_size=2)
    for batch, metas in loader:
        images = torch.from_numpy(batch["image"]).to(detector.device)
        out = detector.backbone(detector.preprocess(images), module)[level]
        pooled = out.float().mean(dim=(1, 2)).cpu().numpy()
        feats.extend(pooled[: len(metas)])
        if len(feats) >= n_images:
            break
    return np.stack(feats[:n_images])


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config-file", "--config", required=True)
    p.add_argument("--weights", default="")
    p.add_argument("--datasets", nargs=2, required=True,
                   help="source and target dataset names")
    p.add_argument("--num-images", type=int, default=50)
    p.add_argument("--level", type=int, default=0, help="FPN level index")
    p.add_argument("--out", default="featurespace.png")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    p.add_argument("opts", nargs="*")
    args = p.parse_args(argv)

    from ..config import get_cfg
    from ..data import datasets  # noqa: F401  (dataset registrations)
    from ..engine.checkpoint import load_reference_weights
    from ..engine.train_step import create_train_state
    from ..models import build_detector

    cfg = get_cfg()
    cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg.freeze()
    detector = build_detector(cfg, device=args.device)
    weights = args.weights or cfg.MODEL.WEIGHTS
    if weights:
        load_reference_weights(create_train_state(cfg, detector), weights)

    fa = collect_features(cfg, detector, args.datasets[0], args.num_images,
                          args.level)
    fb = collect_features(cfg, detector, args.datasets[1], args.num_images,
                          args.level)
    xy = pca_2d(np.concatenate([fa, fb]))
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        np.save(args.out + ".npy", xy)
        print(f"matplotlib unavailable; wrote raw PCA coords to "
              f"{args.out}.npy")
        return xy
    plt.figure(figsize=(6, 6))
    plt.scatter(xy[: len(fa), 0], xy[: len(fa), 1], label=args.datasets[0],
                alpha=0.6)
    plt.scatter(xy[len(fa):, 0], xy[len(fa):, 1], label=args.datasets[1],
                alpha=0.6)
    plt.legend()
    plt.title(f"backbone feature space (level {args.level})")
    plt.savefig(args.out, dpi=120)
    plt.close()
    print(f"wrote {args.out}")
    return xy


if __name__ == "__main__":
    main(sys.argv[1:])
