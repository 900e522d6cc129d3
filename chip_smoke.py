#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with ``python3 chip_smoke.py`` on a machine
with a CUDA card (it exits non-zero without one, and prints no result).
It imports nothing of JAX or of the JAX package. Phases, in order; any
failure exits non-zero:

1. Print the card's name and power limit and build every kernel of the
   serving and training paths from ``aldi_tpu_torch/csrc`` (one ``nvcc``
   per source, all started together), with the build time and the
   compiler's register and spill report.
1b. Decoder phase: the loaders' branch on the card's host and why (the
   native core where it builds with libjpeg and libpng, else PIL, as the
   JAX package decides); the host data path's native core without its
   codecs (``aldi_tpu_torch/data/native.py``, ``csrc/native_decode.cpp``)
   built with the system C++ compiler (its name, version and the build
   seconds; a core that does not build fails the run), held bitwise
   against its plain numpy version on noise-textured 2048x1024 PNGs and
   JPEGs (quality 95) at short edges 800, 896 and 1024, flipped and not,
   BGR; one image per call on one thread through that core, through
   ``apply_transform`` on the loaders' branch and PIL's decode alone, in
   ms, and the first two on a pool of 1 and 8 threads, in images/s;
   ``WeakStrongLoader`` at the published 24 + 24 with TPU.DATA_THREADS 8
   and 1 and ``TestLoader`` on the loaders' branch, in images/s; with the
   host CPU's model and core count.
2. Kernel phase, each kernel against its plain PyTorch version at the
   main paths' shapes, with its time, the plain version's time and the
   least time the card could take: the ROIAlign forward (8 images, 1000
   boxes each, p2..p5 of a 1024x2048 canvas, 256 channels) in float32 and
   bfloat16, with boxes of every level, some out of range and some
   invalid; the anchor matcher K1a/K1b (4 images, the canvas's 523,776
   anchors, 100 gt slots of which about 30% invalid, boxes of 16-512 px;
   and its worst case, 100 valid boxes that each cover the canvas),
   exactly equal, with the pairs the culled kernels list beside the dense
   count; the ROIAlign backward (4 images, 512 boxes each) in
   float32 and bfloat16; the rel-pos attention K3a/K3b on a tiny 8x8 and a
   ragged 50x84 grid and at ViTDet-B's global blocks (one image's 12
   heads, grid 64x128, N = 8192, head dim 64) in float32 and bfloat16,
   and in bfloat16 at one training-step launch (4 images' heads, G = 48),
   and at ViTDet-L's (16 heads: G = 16 and G = 64), with their achieved
   rate, their share of the bound and PyTorch's
   ``scaled_dot_product_attention`` timed beside them.
3. Serving phase, for the flagship detector (Faster R-CNN R50-FPN,
   ``configs/cityscapes/ALDI-Best-Cityscapes.yaml``), for ViTDet-B
   (``configs/cityscapes/ALDI-Best-ViT-Cityscapes.yaml``) and for
   ConvNeXt-L (``configs/cityscapes/ALDI-Best-ConvNeXt-Cityscapes.yaml``:
   depths 3/3/27/3, widths 192-1536, anchors 64-1024 px), all with 8
   classes, canvas 1024x2048, bfloat16 and seeded random weights: one
   warm-up request and then 3 timed requests of 8 synthetic images each,
   through ``build_detector`` and ``make_serving_fn``. The launch counts
   are set to 0 just before the timed requests and read just after. The
   outputs are checked, and one request is traced with torch.profiler for
   the device's busy share, the device time of the port's ranges (trunk,
   RPN, box head, detections, NMS and its exit tests) and its
   layout-conversion kernels (with the operators that launched them); for
   ConvNeXt-L the trunk's residual stream is measured at the end of each
   stage. K2's forward is held against its plain version on a flagship
   and a ConvNeXt-L request's real proposals. Then a tiny float32 detector of each family
   on the card is held against the same detector on the CPU (the tiny ViT
   has 64-wide heads, so the attention kernel runs). Then ViTDet-L
   (``configs/cityscapes/ALDI-Best-ViTL-Cityscapes.yaml``: 24 blocks of
   1024, 16 heads, global blocks 5/11/17/23) as the three above, and Fast
   R-CNN on precomputed proposals (``configs/cityscapes/Base-RCNN-FPN-
   Cityscapes_strongaug_ema.yaml`` with MODEL.LOAD_PROPOSALS):
   ``forward_inference(..., precomputed=)`` on 1 warm-up + 3 timed
   requests of 8 images with 1000 proposals each (jittered gt and random
   boxes), K2's forward once per request and no K1, K2 held against its
   plain version at a request's proposals.
4. Artifact phase, for R50-FPN and ViTDet-B (full width, 8
   classes, 1024x2048, bfloat16, ``seeded_weights``): the serving artifact
   exported for ``cuda`` through ``export_inference`` (the graph must call
   K2's forward op once, and for ViTDet-B K3a's op 4 times), saved with
   ``save_artifact`` into a temporary directory (its size printed; deleted afterwards), loaded with
   ``load_artifact`` and served (a request run node by node must copy no
   pyramid level before K2): one warm-up request and 3 timed
   requests, launch counts set to 0 just before them and read just after
   (K2's forward once per request, K3a 4 times), every output bitwise
   equal to the eager ``make_serving_fn`` on the same request, whose
   latency is printed beside the artifact's with the export, save and
   load seconds. Then the tiny float32 R50-FPN exported for ``cpu`` and
   ``cuda``: the ``cuda`` program bitwise equal to eager on the card, the
   ``cpu`` program within ``tiny_reference_check``'s tolerances of it.
5. Training phase, for the ALDI++ DAOD steps of the three configs and of
   the flagship with adversarial alignment (``DOMAIN_ADAPT.ALIGN``'s
   image- and instance-level discriminators on, the target_weak stream)
   (bfloat16, one backward per stream, soft distillation, erasing on the
   labeled stream, MIC on the unlabeled one; SGD for R50-FPN, AdamW with
   layer decay, drop path and activation checkpointing for ViTDet-B, AdamW
   and drop path 0.2 for ConvNeXt-L, whose parameters all train)
   through ``create_train_state``, ``draw_step`` and ``make_train_step``,
   with SOLVER.IMS_PER_BATCH cut from 48 to 8 (4 labeled + 4 unlabeled
   images of 1024x2048 per step), seeded weights for student and teacher,
   synthetic images and 5-30 gt boxes per labeled image: one warm-up step
   and 3 timed steps, launch counts set to 0 just before the timed steps
   and read just after. Checks: finite losses (with alignment, the
   ``loss_da_*`` of the source_strong and target_weak streams present),
   trainable parameters moved, frozen ones (stem and res2) did not, the
   teacher differs from the student after step 2, every kernel of the
   path launched as often per step as the streams need (K1a/K1b 3, K2
   forward 4 and backward 2; with alignment 5 and 3), and no call
   of the box head in the warm-up step had to copy a pyramid level that
   was not contiguous (NHWC) before K2. Then one step by stage, one traced
   step (with its layout-conversion kernels counted), and K2's forward and
   backward and K1a/K1b held against their plain versions and timed at
   each of the warm-up step's own launches (K2: its real boxes and levels
   with the level shapes; K1: each call's anchors and gt, and its call
   site). Then a tiny float32 step on the card against the same step on
   the CPU. Then the flagship with the dense RPN loss
   (TPU.RPN_LOSS_IMPL "dense": the same launches per step) and its tiny
   card-vs-CPU step; Fast R-CNN (MODEL.LOAD_PROPOSALS, 4 labeled images
   with 2000 proposals each per step: no ``loss_rpn_*``, K2 forward and
   backward once per step, no K1, the RPN head, which no loss reaches,
   not asked to move); and ViTDet-L's step (K3a 20 and K3b 8 per step at
   G = 64, K1a/K1b 3, K2 4 / 2).
6. Trainer phase: the flagship through the training CLI,
   ``aldi_tpu_torch/tools/train_net.py`` ``main`` with
   ``configs/cityscapes/ALDI-Best-Cityscapes.yaml`` at the published
   SOLVER.IMS_PER_BATCH 48 (24 labeled + 24 unlabeled images of
   1024x2048 per step, bfloat16), on synthetic COCO splits written here
   (PNGs of 2048x1024, 8 classes, 5-30 boxes of 16-512 px: train 48,
   unlabeled 48, val 16) and a reference-format ``.pth`` whose ``model``
   and ``ema`` entries come from ``tests/torch_rcnn_oracle.py`` (pure
   torch) with two seeds. First 4 iterations with a checkpoint every 2 and
   an eval at 4, with the smallest TPU.GRAD_ACCUM that fits the card (1
   first); checks: the student and the teacher started from the ``ema``
   entry, finite losses, ``metrics.json`` with the JAX trainer's keys
   (written every iteration here), ``model_0000002.pth`` and
   ``model_0000004.pth``, a finite ``bbox/AP50`` and the best-AP50 map in
   ``trainer_state.json``, K1a, K1b and K2 forward and backward launched
   by the steps and K2 forward by the eval, and no box-head call of a step
   copying a level. Then ``--resume`` to 6 (it must go on at 4 with the
   saved weights) and ``--eval-only --resume``. Prints images/s per
   iteration, data_time, peak memory, the TPU.GRAD_ACCUM used, eval
   images/s and the checkpoint saves' times. Then ``--resume`` from 6 to
   20 with TPU.PROFILE_DIR and the trainer's own write period: the
   device's busy time and idle share in each traced iteration (16-18),
   and where the host waited on the card. Last, K2's forward and backward
   and K1a/K1b held against their plain versions and timed at each of
   the first run's first step's own launches (24 + 24 images: their real
   boxes, levels, anchors and gt), as in the training phase. On the same
   splits and reference ``.pth``: Fast R-CNN through ``train_net`` with
   detectron2 proposal files of 2000 proposals per image
   (DATASETS.PROPOSAL_FILES_TRAIN/_TEST, SOLVER.IMS_PER_BATCH cut to 8, 2
   iterations and an eval of 16 images on the files' proposals: no RPN
   loss, K2 in steps and eval, no K1); then the user tools' ``main`` on
   the card (``aldi_tpu_torch/tools/calibrate_threshold.py``,
   ``debug_pipeline.py``, ``visualize_featurespace.py``): a finite
   recommended threshold or none, the weak, strong and pseudo-labeled
   PNGs, finite PCA coordinates.
7. Data-parallel phase (``aldi_tpu_torch/parallel/mesh.py``): the
   flagship's DAOD step (4 + 4 images of 1024x2048, bf16) without a process
   group and then with a world-1 NCCL group, bitwise equal (losses and
   parameters after 3 steps), both timed, and the gradient all-reduce
   timed on that group with its bytes. Then what every rank's draws of
   the global batch cost at world 2 against its rows drawn alone
   (``dp_draw_cost``: R50-FPN's ``draw_step`` at the published 24 + 24,
   DETR's step on 8 + 8 of the published 16 + 16 chunk with its dropout
   draws counted; times and peak memory). Then world 2 on this one card:
   two spawned processes (``mesh.spawn``) in a gloo group (NCCL refuses
   two ranks on one device), each stepping on its 2 + 2 images of the
   same global 4 + 4 (``shard_batch``, ``shard_draws``), float32
   (TPU.COMPUTE_DTYPE), 2 steps of the flagship and 1 of YOLOv5-m
   (TEACHER.THRESHOLD 0): the ranks' summed losses and their parameters
   against the world-1 steps in this process (tolerances
   ``DP_LOSS_RTOL``, ``DP_PARAM_ATOL``, ``DP_STATS_RTOL``; world 1's
   largest move per step at least ``DP_MOVE_FACTOR`` x
   ``DP_PARAM_ATOL``), the two ranks' parameters and YOLO's BatchNorm
   running statistics bitwise equal, each rank's K1a/K1b 3 and K2 forward
   4 and backward 2 launches per step; then the flagship's 2 steps again
   under each of ``DP_FAULTS`` (gradients averaged instead of summed,
   rank-local denominators), each of which its limit must catch. Last,
   ``ALDITrainer`` at world 2 on the card (two gloo ranks, the flagship
   at 4 + 4 images, synthetic COCO splits of 2048x1024 PNGs: train 8,
   unlabeled 8, val 16 whose boxes are the reference ``.pth``'s own
   detections above 0.5, so that the AP is far above 0): 2 iterations
   with a checkpoint and an eval at 2; rank
   0 alone wrote the files (one ``metrics.json`` line), and this process
   resumes the checkpoint at world 1 and scores the same AP. Any rank that
   fails, or a group not done in ``DP_TIMEOUT_S``, fails the run; the
   phase prints its seconds. The world-2 times come from two processes on
   one card: a check of correctness, not a multi-GPU speed.
7b. Grid phase (``aldi_tpu_torch/parallel/mesh.py`` ``make_grid``,
   ``tensor.py``, ``fsdp.py``): two gloo ranks on this card, against
   world 1 on the same global batch of 2 + 2 images and draws, TF32 off:
   (i) the flagship's DAOD step at TPU.MESH_MODEL 2 (both ranks on the
   whole batch, the box head's fc1/fc2 split), float32, 2 steps, the
   data-parallel phase's limits, the two ranks' gathered states bitwise
   equal, K1a/K1b 3 and K2 4 / 2 launches per step on each rank; (ii)
   ViTDet-B at M = 2, bf16, 2 steps: each rank's global blocks launch
   K3a/K3b 20 / 8 per step at G = 12 (2 images x 6 heads), held against
   their plain versions at that G, step ms and peak GiB per rank, the
   first step's metrics within ``GRID_BF16_LOSS_RTOL``; (iii) ViTDet-L
   with TPU.FSDP at D = 2 (1 + 1 per rank), bf16, 2 steps: each rank's
   GiB of parameters, gradients, AdamW moments and teacher between steps
   against world 1's (at most ``GRID_FSDP_SHARE`` of the parameters',
   moments' and teacher's), peak GiB per rank, the first step's metrics.
   The times are of two processes sharing one card.
8. YOLO phase, YOLOv5-m of ``configs/cityscapes/ALDI-Yolo-Cityscapes.yaml``
   (depth 0.67, width 0.75, 8 classes, bfloat16, ``seeded_weights``),
   whose paths launch none of the six kernels (asserted on each path):
   serving (1 warm-up + 3 timed requests of 8 images of 1024x2048, a
   request by stage, a traced request whose layout conversions must be
   none); the ALDI-Yolo DAOD step at 4 + 4 (DOMAIN_ADAPT.TEACHER.THRESHOLD
   0, since the seeded weights score below the published 0.8; 1 warm-up +
   3 timed steps, each checked: finite losses, pseudo-labels, every
   BatchNorm running statistic of the
   student moved, the teacher's equal to ``alpha t + (1 - alpha) s`` of
   the step before, all parameters moved; a step by stage, a traced step),
   the same with image-level alignment on p5 (the target_weak stream),
   and one step at the published SOLVER.IMS_PER_GPU of 12 + 12 (its peak,
   or that it does not fit); the artifact as in phase 4 (bitwise equal to
   eager, no kernel op in the graph); and a tiny float32 YOLOv5-n DAOD step
   on the card against the same step on the CPU.
9. Deformable DETR phase, ``configs/cityscapes/ALDI-Best-DETR-Cityscapes
   .yaml`` (R50, 4 levels, 6 + 6 layers, d_model 256, 8 heads, 4 points,
   300 queries, 8 classes, 800x1344, float32, ``seeded_weights``), whose
   only kernel is K4, the Hungarian criterion's assignment solver: first,
   in the kernel phase, K4 on a synthetic set of 96 problems of [100, 300]
   with ties (duplicated rows, columns clipped to 1e4) and on its shape
   cases (``LAPJV_CASES``: near-duplicate rows whose searches run as long
   as on 100 pseudo-labels, m of 77, 300 and 512, n = m, costs too large
   for shared memory, no rows, -0/+0 with exact ties, and m = 600, the
   block kernel), exactly equal to ``lapjv_plain`` and cost-equal to
   scipy's ``linear_sum_assignment``, each line naming the kernel taken,
   the settles per problem and the ns per settle.
   Then serving (1 warm-up + 3 timed requests of 8 images, a request by
   stage, a traced request with MSDA's share of the busy time); the
   ALDI-Best-DETR DAOD step at 4 + 4 (TEACHER.THRESHOLD 0, so every
   unlabeled image's 100 detections are pseudo-labels; 1 warm-up whose K4
   launches are recorded + 3 timed steps, each checked: finite losses, a
   non-zero ``loss_ce_distill``, the teacher's ``query_embed`` copied and
   its other parameters the EMA, every trainable parameter moved and the
   frozen stem and res2 not, K4 twice per step and no other kernel; a step
   by stage, a traced step); one step at the published 16 + 16 (its peak,
   or the smallest TPU.GRAD_ACCUM that fits); K4 held against its plain
   version, exactly, and scipy at each of the warm-up step's launches (their
   real costs), with its time, bound, settles, the plain version's and
   scipy's times; the artifact as in phase 4 (no kernel op in the graph);
   and a tiny float32 DETR, the shipped variant and WITH_BOX_REFINE +
   TWO_STAGE, on the card against the CPU (a request and one DAOD step).
10. Print the whole run's seconds (and those of the Fast R-CNN, dense RPN,
   ViTDet-L, tools and grid phases), the card line, a ``{"kernels":
   [...]}`` line (the six kernels and K4; K3a/K3b with their numbers at
   the grid's G = 12) and, last, ``{"ok": true, "device": {...}}``.

Kernel times come from CUDA events over repeated launches; request times
from the host clock around work that ends in ``torch.cuda.synchronize()``.
"""

import json
import math
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = os.path.join(ROOT, "configs", "cityscapes",
                        "ALDI-Best-Cityscapes.yaml")
VIT_ALDI = os.path.join(ROOT, "configs", "cityscapes",
                        "ALDI-Best-ViT-Cityscapes.yaml")
CONVNEXT_ALDI = os.path.join(ROOT, "configs", "cityscapes",
                             "ALDI-Best-ConvNeXt-Cityscapes.yaml")
YOLO_ALDI = os.path.join(ROOT, "configs", "cityscapes",
                         "ALDI-Yolo-Cityscapes.yaml")
# YOLO's image-level alignment, on p5 as the reference's YoloAlignMixin
YOLO_ALIGN = {"DOMAIN_ADAPT.ALIGN.IMG_DA_ENABLED": True,
              "DOMAIN_ADAPT.ALIGN.IMG_DA_LAYER": "p5"}
YOLO_PUBLISHED_CHUNK = 12  # SOLVER.IMS_PER_GPU of configs/Base-Yolo.yaml
DETR_ALDI = os.path.join(ROOT, "configs", "cityscapes",
                         "ALDI-Best-DETR-Cityscapes.yaml")
DETR_PUBLISHED_CHUNK = 16  # SOLVER.IMS_PER_GPU of configs/Base-DETR.yaml
DETR_TWO_STAGE = {"MODEL.DEFORMABLE_DETR.WITH_BOX_REFINE": True,
                  "MODEL.DEFORMABLE_DETR.TWO_STAGE": True}
# the aligned flagship: both discriminators on, the rest of
# DOMAIN_ADAPT.ALIGN at its defaults
ALIGN = {"DOMAIN_ADAPT.ALIGN.IMG_DA_ENABLED": True,
         "DOMAIN_ADAPT.ALIGN.INS_DA_ENABLED": True}
VITL_ALDI = os.path.join(ROOT, "configs", "cityscapes",
                         "ALDI-Best-ViTL-Cityscapes.yaml")
# Fast R-CNN on precomputed proposals: the supervised strong-augmentation
# + EMA recipe (labeled_strong only) with MODEL.LOAD_PROPOSALS
FAST_RCNN = os.path.join(ROOT, "configs", "cityscapes",
                         "Base-RCNN-FPN-Cityscapes_strongaug_ema.yaml")
FAST_RCNN_ON = {"MODEL.LOAD_PROPOSALS": True}
DENSE_RPN = {"TPU.RPN_LOSS_IMPL": "dense"}
VIT_GRID = (64, 128)  # ViTDet's stride-16 grid of the 1024x2048 canvas
VIT_HEADS = 12  # one image's heads: G = 12
VITL_HEADS = 16  # ViTDet-L's: G = 16
BATCH = 8  # the evaluator's default batch size
TIMED_REQUESTS = 3
TRAIN_IMAGES = 4  # per stream: SOLVER.IMS_PER_BATCH 8 = 4 labeled + 4 unlabeled
TIMED_STEPS = 3
MATCH_OPS = 12  # float operations per IoU (4 min/max, 3 sub, 2 mul, add, div)
MATCH_BLOCK = 256  # anchors per block of K1a/K1b (csrc/match_iou.cu kThreads)
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): device
# memory 3.35 TB/s; float32 on the CUDA cores 67 TFLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12  # dense bf16 on the tensor cores
ROI_STRIDES = [4, 8, 16, 32]


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, iters, warmup=2):
    """Mean time of one call on the card, from CUDA events around
    ``iters`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def launch_ms(kernel, args, iters):
    """Mean time (ms) of one launch of ``kernel``'s C entry point on
    ``args`` (device pointers of preallocated tensors, sizes, the stream),
    from CUDA events around ``iters`` back-to-back launches made straight
    through ctypes: the kernel alone, where ``cuda_ms`` of a wrapper call
    whose kernel takes tens of microseconds reads the host's launch rate.
    These launches are not counted."""
    import ctypes

    fn = getattr(kernel.lib(), f"aldi_{kernel.name}")
    fn.argtypes, fn.restype = kernel.argtypes, ctypes.c_int

    def launch():
        if fn(*args):
            fail(f"{kernel.name}: a timing launch failed")

    return cuda_ms(launch, iters)


def roi_bound(features, boxes, levels, output_size=7, sampling_ratio=2):
    """Least time (ms) the card could take for this ROIAlign call, and what
    sets it: bytes (each feature row that this call's samples touch read
    once, boxes and levels read once, the output written once) over the
    memory rate, against float32 operations (4 corner products and 4 sums
    per sample and channel that reads features) over the CUDA-core rate."""
    import torch

    from aldi_tpu_torch.ops.roi_align import sample_geometry

    b, p = boxes.shape[:2]
    c = features[0].shape[-1]
    esize = features[0].element_size()
    hws = [(int(f.shape[1]), int(f.shape[2])) for f in features]
    rows = samples = 0
    for i in range(b):
        idx4, _, ok = sample_geometry(boxes[i], levels[i], hws, ROI_STRIDES,
                                      output_size, sampling_ratio)
        rows += torch.unique(torch.cat([idx[ok] for idx in idx4])).numel()
        samples += int(ok.sum())
    n_bytes = (rows * c * esize + b * p * output_size ** 2 * c * esize
               + boxes.numel() * 4 + levels.numel() * 4)
    ops = samples * c * 8
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_roi(name, features, boxes, levels, plain_iters=3, kernel_iters=20):
    """Hold the kernel against its plain version on these inputs and time
    both (the plain version not with ``plain_iters`` 0). Returns a dict of
    the numbers; fails the run on disagreement."""
    import torch

    from aldi_tpu_torch.ops.roi_align import roi_align_plain
    from aldi_tpu_torch.ops.roi_align_kernel import roi_align_fwd

    got = roi_align_fwd(features, boxes, levels, ROI_STRIDES)
    want = roi_align_plain(features, boxes, levels, ROI_STRIDES)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    if features[0].dtype == torch.float32:
        tol = 1e-5 * max(1.0, want.float().abs().max().item())
        ok = err <= tol
        tol_text = f"{tol:.3g} (float32: 1e-5 of the output scale)"
    else:  # one bf16 ulp of each value
        ok = bool((diff <= want.float().abs() * 2.0 ** -7 + 1e-6).all())
        tol_text = "one bfloat16 ulp of each value (2^-7 relative)"
    ms = cuda_ms(lambda: roi_align_fwd(features, boxes, levels, ROI_STRIDES),
                 kernel_iters)
    plain_ms = cuda_ms(
        lambda: roi_align_plain(features, boxes, levels, ROI_STRIDES),
        plain_iters, warmup=1) if plain_iters else None
    bound_ms, bound_by = roi_bound(features, boxes, levels)
    per_level = torch.bincount(levels[levels >= 0].flatten().long(),
                               minlength=len(features)).tolist()
    plain_text = "not timed" if plain_ms is None else f"{plain_ms:.3f} ms"
    print(f"[kernel] {name}: boxes {tuple(boxes.shape[:2])}, valid per level "
          f"p2..p5 {per_level}"
          f" dtype {str(features[0].dtype).split('.')[-1]}: max abs err "
          f"{err:.3g}, tolerance {tol_text}: {'ok' if ok else 'FAIL'}; "
          f"kernel {ms:.4f} ms, plain {plain_text}, bound {bound_ms:.4f}"
          f" ms ({bound_by}), {bound_ms / ms:.3f} of the bound", flush=True)
    if not ok:
        fail(f"roi_align_fwd disagrees with its plain version ({name})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def synthetic_roi_inputs(dtype, seed, b=BATCH, p=1000, c=256,
                         canvas=(1024, 2048)):
    """Flagship-shaped ROIAlign inputs made on the card from a seed: boxes
    of every pyramid level (sqrt-area 8..1400 px, aspect 1:e..e:1), 3%
    wholly out of the canvas, 10% invalid."""
    import torch

    from aldi_tpu_torch.ops.roi_align import box_levels

    g = torch.Generator(device="cuda").manual_seed(seed)

    def u(lo, hi, shape):
        return torch.rand(shape, generator=g, device="cuda") * (hi - lo) + lo

    feats = [torch.randn((b, canvas[0] // s, canvas[1] // s, c), generator=g,
                         device="cuda").to(dtype) for s in ROI_STRIDES]
    side = torch.exp(u(2.08, 7.24, (b, p)))
    aspect = torch.exp(u(-1.0, 1.0, (b, p)))
    w, h = side * aspect, side / aspect
    cx, cy = u(-64, canvas[1] + 64, (b, p)), u(-64, canvas[0] + 64, (b, p))
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    far = u(0, 1, (b, p)) < 0.03
    boxes[far] = boxes[far] - 4096.0
    valid = u(0, 1, (b, p)) > 0.10
    return feats, boxes.contiguous(), box_levels(boxes, valid, ROI_STRIDES)


def synthetic_gt(gen, b, m, canvas, n_valid=None, invalid_frac=0.3,
                 num_classes=8):
    """gt boxes [b, m, 4] of 16-512 px sides inside the canvas, classes and
    valid flags made on the card from ``gen``: ``n_valid`` [b] real boxes
    first (else about ``invalid_frac`` of the slots invalid, anywhere)."""
    import torch

    def u(lo, hi, shape):
        return torch.rand(shape, generator=gen, device="cuda") * (hi - lo) + lo

    w, h = u(16, 512, (b, m)), u(16, 512, (b, m))
    x0 = u(0, 1, (b, m)) * (canvas[1] - w)
    y0 = u(0, 1, (b, m)) * (canvas[0] - h)
    boxes = torch.stack([x0, y0, x0 + w, y0 + h], -1)
    if n_valid is None:
        valid = u(0, 1, (b, m)) >= invalid_frac
    else:
        valid = torch.arange(m, device="cuda")[None] < n_valid[:, None]
    classes = (u(0, 1, (b, m)) * num_classes).to(torch.int32)
    boxes = torch.where(valid[..., None], boxes, torch.zeros_like(boxes))
    return boxes.contiguous(), torch.where(valid, classes, 0), valid


def covering_gt(gen, b, m, canvas):
    """The matcher's worst case: m valid gt boxes [b, m, 4] per image, each
    covering the whole canvas (edges up to 64 px beyond it), so that no
    block of anchors can cull any."""
    import torch

    def u(lo, hi):
        return torch.rand((b, m), generator=gen, device="cuda") * (hi - lo) + lo

    h, w = canvas
    boxes = torch.stack([u(-64, 0), u(-64, 0), u(w, w + 64), u(h, h + 64)],
                        -1)
    return boxes.contiguous(), torch.ones((b, m), dtype=torch.bool,
                                          device="cuda")


def intersecting_pairs(anchors, gt, keep):
    """The (anchor, gt slot) pairs among the slots ``keep`` [B, M] whose
    boxes intersect (a positive intersection, with ``pairwise_iou``'s
    arithmetic), counted on the card: the only pairs whose IoU is not 0."""
    import torch

    pairs = 0
    for g, k in zip(gt, keep):
        g = g[k]
        if g.numel():
            lt = torch.maximum(anchors[:, None, :2], g[None, :, :2])
            rb = torch.minimum(anchors[:, None, 2:], g[None, :, 2:])
            wh = (rb - lt).clamp(min=0)
            pairs += int(((wh[..., 0] * wh[..., 1]) > 0).sum())
    return pairs


def listed_pairs(anchors, gt, keep, block):
    """The (anchor, gt slot) pairs the culled kernel walks: per block of
    ``block`` anchors, its anchors times its listed slots
    (``match_kernel.candidate_lists``, the kernel's test in plain
    PyTorch)."""
    from aldi_tpu_torch.ops.match_kernel import candidate_lists

    _, inside, _, count = candidate_lists(anchors, gt, keep, block)
    return int((count * inside.sum(-1)).sum())


def match_bounds(anchors, gt, gt_valid, best):
    """Least time (ms) the card could take for K1a and for K1b on these
    inputs, what sets each, and the dense bound (every anchor against every
    slot). Bytes: the anchors read once, the gt, flags (and for K1b the
    per-gt best) read once, the outputs written once (K1a 8 B per anchor and
    image plus the per-gt best, K1b 1 B). Operations: MATCH_OPS per IoU
    that these inputs need, over the float32 CUDA-core rate: one per pair
    whose boxes intersect, among the valid slots (K1a) or the valid slots
    whose best IoU is > 0 (K1b); every other IoU is 0 without computing it.
    The dense bound counts every anchor against every such slot. Returns
    one dict per kernel, with the pair counts."""
    n = anchors.shape[0]
    b, m = gt_valid.shape
    gt_bytes = b * m * 17
    out = []
    for keep, n_bytes in (
            (gt_valid, n * 16 + gt_bytes + b * n * 8 + b * m * 4),
            (gt_valid & (best > 0), n * 16 + gt_bytes + b * m * 4 + b * n)):
        pairs = intersecting_pairs(anchors, gt, keep)
        dense = int(keep.sum()) * n
        t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
        t_ops = pairs * MATCH_OPS / PEAK_F32_FLOPS * 1e3
        t_dense = dense * MATCH_OPS / PEAK_F32_FLOPS * 1e3
        out.append(dict(bound_ms=max(t_bytes, t_ops),
                        bound_by="bytes" if t_bytes >= t_ops else "operations",
                        dense_bound_ms=max(t_bytes, t_dense), pairs=pairs,
                        dense_pairs=dense, keep=keep))
    return out


def check_match(label, anchors, gt, valid, plain_iters=3, kernel_iters=20):
    """K1a and K1b against their plain versions (exact equality of vals,
    idx, the per-gt best, the low-quality mask and the labels), with
    times (``ms``, the wrapper's call by ``cuda_ms`` as for every kernel;
    ``kernel_ms``, the kernel alone by ``launch_ms``), bounds and the pairs
    that blocks of ``MATCH_BLOCK`` anchors list (without ``plain_iters``
    the plain versions are not timed). Returns {name: numbers}; fails the
    run on any difference."""
    import torch

    from aldi_tpu_torch.ops.match_kernel import (
        low_quality_mask, low_quality_mask_plain, match_boxes,
        match_boxes_plain, match_iou, match_iou_plain)

    got = match_iou(anchors, gt, valid)
    want = match_iou_plain(anchors, gt, valid)
    lowq = low_quality_mask(anchors, gt, valid, got[2])
    lowq_want = low_quality_mask_plain(anchors, gt, valid, want[2])
    labels = match_boxes(anchors, gt, valid, [0.3, 0.7], [0, -1, 1], True)
    labels_want = match_boxes_plain(anchors, gt, valid, [0.3, 0.7],
                                    [0, -1, 1], True)
    torch.cuda.synchronize()
    diffs = {"vals": int((got[0] != want[0]).sum()),
             "idx": int((got[1] != want[1]).sum()),
             "best": int((got[2] != want[2]).sum()),
             "low-quality mask": int((lowq != lowq_want).sum()),
             "matched idx": int((labels[0] != labels_want[0]).sum()),
             "labels": int((labels[1] != labels_want[1]).sum())}
    ok = not any(diffs.values())
    bounds = match_bounds(anchors, gt, valid, want[2])
    out = {}
    b, m = valid.shape
    n = anchors.shape[0]
    stream = torch.cuda.current_stream().cuda_stream
    inputs = (anchors.data_ptr(), n, gt.data_ptr(), valid.data_ptr())
    scratch = [torch.zeros((b, n), dtype=torch.float32, device="cuda"),
               torch.zeros((b, n), dtype=torch.int32, device="cuda"),
               torch.zeros((b, m), dtype=torch.int32, device="cuda")]
    for (name, kernel, args, fn, plain), bd in zip((
            ("match_iou", match_iou,
             inputs + (m, b) + tuple(t.data_ptr() for t in scratch)
             + (stream,),
             lambda: match_iou(anchors, gt, valid),
             lambda: match_iou_plain(anchors, gt, valid)),
            ("low_quality_mask", low_quality_mask,
             inputs + (want[2].data_ptr(), m, b, scratch[1].data_ptr(),
                       stream),
             lambda: low_quality_mask(anchors, gt, valid, want[2]),
             lambda: low_quality_mask_plain(anchors, gt, valid, want[2]))),
            bounds):
        err = (max(float((got[0] - want[0]).abs().max()),
                   float((got[2] - want[2]).abs().max()))
               if name == "match_iou" else float((lowq != lowq_want).any()))
        out[name] = dict(
            max_abs_err=err, ms=cuda_ms(fn, kernel_iters),
            kernel_ms=launch_ms(kernel, args, kernel_iters),
            plain_ms=(cuda_ms(plain, plain_iters, warmup=1) if plain_iters
                      else None),
            bound_ms=bd["bound_ms"], bound_by=bd["bound_by"],
            dense_bound_ms=bd["dense_bound_ms"], pairs=bd["pairs"],
            dense_pairs=bd["dense_pairs"],
            listed_pairs=listed_pairs(anchors, gt, bd["keep"], MATCH_BLOCK))
    print(f"[kernel] matcher K1a/K1b, {label}: {b} images, "
          f"{anchors.shape[0]} anchors, {m} gt slots, {int(valid.sum())} "
          f"valid; differences from the plain version {diffs} (tolerance: "
          f"exact): {'ok' if ok else 'FAIL'}; positives "
          f"{int((labels[1] == 1).sum())}, low-quality matches "
          f"{int(lowq.sum())}; " + "; ".join(
              f"{k}: wrapper's call {v['ms']:.4f} ms (kernel alone "
              f"{v['kernel_ms']:.4f} ms), plain "
              + ("not timed" if v["plain_ms"] is None
                 else f"{v['plain_ms']:.3f} ms")
              + f", bound {v['bound_ms']:.4f} ms ({v['bound_by']}), dense "
              f"bound (all pairs) {v['dense_bound_ms']:.4f} ms; "
              f"pairs: dense "
              f"{v['dense_pairs']}, "
              + f"listed by blocks of {MATCH_BLOCK} {v['listed_pairs']} ("
              f"{1 - v['listed_pairs'] / max(v['dense_pairs'], 1):.4f} "
              "culled)"
              + f", intersecting {v['pairs']}"
              for k, v in out.items()), flush=True)
    if not ok:
        fail(f"the matcher kernels disagree with their plain versions "
             f"({label})")
    return out


def roi_bwd_bound(grad, boxes, levels, feat_shapes):
    """Least time (ms) the card could take for this ROIAlign backward:
    bytes (the cotangent and the boxes read once, the dense per-level
    gradient written once in the cotangent's dtype) against float32
    operations (4 products and 4 sums per sample and channel that reads
    features)."""
    from aldi_tpu_torch.ops.roi_align import sample_geometry

    b, p, out, _, c = grad.shape
    samples = sum(int(sample_geometry(boxes[i], levels[i], feat_shapes,
                                      ROI_STRIDES, out)[2].sum())
                  for i in range(b))
    esize = grad.element_size()
    n_bytes = (grad.numel() * esize + boxes.numel() * 4 + levels.numel() * 4
               + b * sum(h * w for h, w in feat_shapes) * c * esize)
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = samples * c * 8 / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def roi_bwd_inputs(dtype, seed, b=TRAIN_IMAGES, p=512):
    """Synthetic ROIAlign backward inputs at a training step's shape: the
    boxes and levels of ``synthetic_roi_inputs``, the level shapes and a
    cotangent made on the card from a seed."""
    import torch

    feats, boxes, levels = synthetic_roi_inputs(dtype, seed, b=b, p=p)
    shapes = [(int(f.shape[1]), int(f.shape[2])) for f in feats]
    del feats
    g = torch.Generator(device="cuda").manual_seed(seed + 100)
    grad = torch.randn((b, p, 7, 7, 256), generator=g, device="cuda").to(
        dtype)
    return grad, boxes, levels, shapes


def check_roi_bwd(name, grad, boxes, levels, shapes, plain_iters=2,
                  kernel_iters=10, backward=None):
    """The ROIAlign backward (``backward``, by default the kernel's wrapper
    ``roi_align_bwd``) against ``roi_align_plain_backward`` on these inputs,
    with times, the gradient in the cotangent's dtype. Tolerance: float32,
    1e-5 of the gradient's scale (the sums run in another order);
    bfloat16, one bf16 ulp of each value after the cast."""
    import torch

    from aldi_tpu_torch.ops.roi_align import roi_align_plain_backward
    from aldi_tpu_torch.ops.roi_align_kernel import roi_align_bwd

    backward = backward or roi_align_bwd
    dtype = grad.dtype
    got = backward(grad, boxes, levels, shapes, dtype, ROI_STRIDES)
    want = roi_align_plain_backward(grad, boxes, levels, shapes, dtype,
                                    ROI_STRIDES)
    torch.cuda.synchronize()
    err = max(float((x.float() - y.float()).abs().max())
              for x, y in zip(got, want))
    if dtype == torch.float32:
        scale = max(float(y.abs().max()) for y in want)
        ok = err <= 1e-5 * scale
        tol_text = f"{1e-5 * scale:.3g} (float32: 1e-5 of the scale)"
    else:
        ok = all(bool(((x.float() - y.float()).abs()
                       <= y.float().abs() * 2.0 ** -7 + 1e-6).all())
                 for x, y in zip(got, want))
        tol_text = "one bfloat16 ulp of each value (2^-7 relative)"
    del got, want
    ms = cuda_ms(lambda: backward(grad, boxes, levels, shapes, dtype,
                                  ROI_STRIDES), kernel_iters)
    plain_ms = cuda_ms(lambda: roi_align_plain_backward(
        grad, boxes, levels, shapes, dtype, ROI_STRIDES), plain_iters,
        warmup=1) if plain_iters else None
    bound_ms, bound_by = roi_bwd_bound(grad, boxes, levels, shapes)
    b, p = boxes.shape[:2]
    per_level = torch.bincount(levels[levels >= 0].flatten().long(),
                               minlength=len(shapes)).tolist()
    plain_text = "not timed" if plain_ms is None else f"{plain_ms:.3f} ms"
    print(f"[kernel] roi_align_bwd, {name}: boxes {(b, p)}, valid per level "
          f"p2..p5 {per_level}, dtype {str(dtype).split('.')[-1]}: max abs "
          f"err {err:.3g}, tolerance {tol_text}: {'ok' if ok else 'FAIL'}; "
          f"kernel {ms:.4f} ms (the wrapper's whole call), plain "
          f"{plain_text}, bound {bound_ms:.4f} ms ({bound_by}), "
          f"{bound_ms / ms:.3f} of the bound", flush=True)
    if not ok:
        fail(f"roi_align_bwd disagrees with its plain version ({name})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def attn_bounds(q, h_grid, w_grid):
    """Least times (ms) the card could take for K3a and for K3b on inputs
    shaped like ``q`` [G, N, 64], and what sets each. Operations: the
    function's products, 4 N^2 D per head forward (q.k, P.v) and 10 N^2 D
    backward (q.k, dO.v, dS.k, dS^T.q, P^T.dO), over the dense bf16
    tensor-core peak for bfloat16 inputs and the float32 CUDA-core peak for
    float32. Bytes: forward q, k, v, Bh, Bw read and out, lse written once;
    backward q, k, v, dO, Bh, Bw, lse, delta read and dq, dk, dv, dBh, dBw
    written once."""
    import torch

    g, n, d = q.shape
    es = q.element_size()
    peak = PEAK_BF16_FLOPS if q.dtype == torch.bfloat16 else PEAK_F32_FLOPS
    bias = g * n * (h_grid + w_grid) * 4
    out = []
    for ops, n_bytes in ((4 * n * n * d * g, 4 * g * n * d * es + bias
                          + g * n * 4),
                         (10 * n * n * d * g, 7 * g * n * d * es + 2 * bias
                          + 2 * g * n * 4)):
        t_ops = ops / peak * 1e3
        t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
        out.append((max(t_ops, t_bytes),
                    "operations" if t_ops >= t_bytes else "bytes"))
    return out


def attn_inputs(dtype, seed, g, h_grid, w_grid):
    """Rel-pos attention inputs made on the card from a seed: q, k, v and
    the cotangent standard normal in ``dtype`` (logits q.k/8 of about unit
    scale, as a trained ViT's), Bh and Bw float32 of scale 0.5."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    n = h_grid * w_grid

    def randn(*shape, s=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * s

    q, k, v, dout = (randn(g, n, 64).to(dtype) for _ in range(4))
    return (q, k, v, randn(g, n, h_grid, s=0.5), randn(g, n, w_grid, s=0.5),
            dout)


def sdpa_ms(q, k, v, bh, bw, dout, scale, h_grid, w_grid, iters):
    """Times (ms) of PyTorch's ``scaled_dot_product_attention`` on the same
    inputs, one image's heads per call, with the dense [G, N, N] bias as
    ``attn_mask`` (built outside the timing): the forward, and the backward
    to q, k, v and the dense bias (None, with the reason printed, where the
    backend gives no bias gradient). The yardstick of K3a/K3b only."""
    import torch
    import torch.nn.functional as F

    g, n, _ = q.shape
    keys = torch.arange(n, device=q.device)
    mask = ((bh[:, :, keys // w_grid] + bw[:, :, keys % w_grid])
            .to(q.dtype)[None])
    q4, k4, v4 = (t[None] for t in (q, k, v))
    fwd = cuda_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=mask, scale=scale), iters)
    try:
        leaves = [t.detach().requires_grad_(True) for t in (q4, k4, v4,
                                                             mask)]
        out = F.scaled_dot_product_attention(*leaves[:3], attn_mask=leaves[3],
                                             scale=scale)
        bwd = cuda_ms(lambda: torch.autograd.grad(
            out, leaves, dout[None], retain_graph=True), iters)
    except RuntimeError as e:
        print(f"[kernel] sdpa backward with a bias gradient: not available "
              f"({str(e).splitlines()[0][:120]})", flush=True)
        bwd = None
    return fwd, bwd


def check_attn(name, dtype, h_grid, w_grid, g, seed, kernel_iters=0,
               plain_iters=0, library=False):
    """K3a and K3b against ``flash_attn_plain`` / ``flash_attn_plain_backward``
    on the same inputs (the backward of both from the plain forward's out
    and lse), with times when ``kernel_iters`` is set. Tolerances: float32,
    out and lse 2e-5, the gradients 1e-4, each of its tensor's scale
    (max(1, max |value|)): the same products summed in another order over
    up to 8192 keys; bfloat16, out within 1e-2 of its scale (the kernel
    rounds each tile's probabilities to bfloat16 against the running row
    maximum, the plain version against the row's final maximum), lse 1e-4
    of its scale, dq/dk/dv one bfloat16 ulp of each value plus 1e-4 of the
    scale, dbh/dbw 1e-4 of the scale. Returns {kernel name: numbers}; fails
    the run on any disagreement."""
    import torch

    from aldi_tpu_torch.ops.flash_attn import (attn_delta, flash_attn_plain,
                                               flash_attn_plain_backward)
    from aldi_tpu_torch.ops.flash_attn_kernel import (flash_attn_bwd,
                                                      flash_attn_fwd)

    q, k, v, bh, bw, dout = attn_inputs(dtype, seed, g, h_grid, w_grid)
    scale = 64 ** -0.5
    args = (q, k, v, bh, bw, scale, h_grid, w_grid)
    out, lse = flash_attn_fwd(*args)
    w_out, w_lse = flash_attn_plain(*args)
    delta = attn_delta(w_out, dout)
    bwd_args = (q, k, v, bh, bw, w_lse, delta, dout, scale, h_grid, w_grid)
    grads = flash_attn_bwd(*bwd_args)
    w_grads = flash_attn_plain_backward(*bwd_args)
    torch.cuda.synchronize()
    bf16 = dtype == torch.bfloat16
    errs, bad = {}, []
    for what, got, want, tol, ulp in (
            ("out", out, w_out, 1e-2 if bf16 else 2e-5, False),
            ("lse", lse, w_lse, 1e-4 if bf16 else 2e-5, False),
            *((w, a, b, 1e-4, bf16 and w in ("dq", "dk", "dv"))
              for w, a, b in zip(("dq", "dk", "dv", "dbh", "dbw"), grads,
                                 w_grads))):
        got, want = got.float(), want.float()
        diff = (got - want).abs()
        scale_t = max(1.0, float(want.abs().max()))
        allowed = tol * scale_t + (want.abs() * 2.0 ** -7 if ulp else 0.0)
        errs[what] = float(diff.max())
        if not bool((diff <= allowed).all()) or not bool(
                torch.isfinite(got).all()):
            bad.append(what)
    numbers = {}
    text = ""
    if kernel_iters:
        (b_fwd, by_fwd), (b_bwd, by_bwd) = attn_bounds(q, h_grid, w_grid)
        lib = (sdpa_ms(q, k, v, bh, bw, dout, scale, h_grid, w_grid,
                       kernel_iters) if library else (None, None))
        for kern, fn, plain, bound, by, lib_ms, err in (
                (flash_attn_fwd, lambda: flash_attn_fwd(*args),
                 lambda: flash_attn_plain(*args), b_fwd, by_fwd, lib[0],
                 max(errs["out"], errs["lse"])),
                (flash_attn_bwd, lambda: flash_attn_bwd(*bwd_args),
                 lambda: flash_attn_plain_backward(*bwd_args), b_bwd, by_bwd,
                 lib[1], max(errs[w] for w in ("dq", "dk", "dv", "dbh",
                                               "dbw")))):
            numbers[kern.name] = dict(
                max_abs_err=err, ms=cuda_ms(fn, kernel_iters, warmup=1),
                plain_ms=cuda_ms(plain, plain_iters, warmup=1),
                bound_ms=bound, bound_by=by, library_ms=lib_ms)
        n = h_grid * w_grid
        ops = {flash_attn_fwd.name: 4 * n * n * 64 * g,
               flash_attn_bwd.name: 10 * n * n * 64 * g}
        text = "; " + "; ".join(
            f"{k} {v['ms']:.3f} ms ({ops[k] / v['ms'] / 1e9:.1f} TFLOP/s of "
            f"the function's products, {v['bound_ms'] / v['ms']:.3f} of the "
            f"bound), plain {v['plain_ms']:.3f} ms, sdpa "
            + ("n/a" if v["library_ms"] is None
               else f"{v['library_ms']:.3f}")
            + f" ms, bound {v['bound_ms']:.4f} ms ({v['bound_by']})"
            for k, v in numbers.items())
    print(f"[kernel] flash attention {name}: G={g}, grid {h_grid}x{w_grid} "
          f"(N={h_grid * w_grid}), {str(dtype).split('.')[-1]}: max abs err "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
          + f": {'FAIL ' + str(bad) if bad else 'ok'}" + text, flush=True)
    if bad:
        fail(f"the flash attention kernels disagree with their plain "
             f"versions ({name}: {bad})")
    return numbers


def synthetic_request(gen, canvas):
    """One request: BATCH images of uniform noise in 0..255 on the card and
    their valid sizes (most full-canvas, two smaller)."""
    import torch

    images = torch.rand((BATCH, canvas[0], canvas[1], 3), generator=gen,
                        device="cuda") * 255.0
    sizes = torch.tensor([list(canvas)] * BATCH, dtype=torch.int32)
    sizes[1] = torch.tensor([canvas[0] - 124, canvas[1] - 248])
    sizes[5] = torch.tensor([canvas[0], canvas[1] * 3 // 4])
    return images, sizes.cuda()


def seeded_weights(det, seed):
    """``conditioned_weights`` for ``det``'s module."""
    return conditioned_weights(det.module.state_dict(), seed)


def conditioned_weights(state_dict, seed):
    """A state dict with ``state_dict``'s names and shapes (detectron2's
    names, as the port's modules and the torch oracle carry them) drawn
    from ``seed`` on the CPU, conditioned
    so that a random network behaves like a trained one in the ways the
    serving path cares about: kernels with std gain/sqrt(fan_in), FrozenBN
    statistics near the identity and a small scale on each bottleneck's
    last conv, so activations stay O(1) through all 50 layers; small box
    deltas, so proposals and detections are varied boxes; spread class
    logits, so detections pass the score threshold and fill the top-100.
    (The JAX package's initializers, which ``init_variables`` mirrors, let a
    random R50 saturate: one detection per image on a degenerate box.)"""
    import math

    import torch

    gen = torch.Generator().manual_seed(seed)
    gains = {"stem.conv1": 1 / 64, "body.conv1": 1 / 64,
             "anchor_deltas": 0.1, "bbox_pred": 0.1, "cls_score": 3.0}
    out = {}
    for name, t in state_dict.items():
        mod, leaf = name.rsplit(".", 1)
        if leaf == "weight" and t.dim() > 1:
            g = next((v for k, v in gains.items() if mod.endswith(k)), 1.0)
            x = torch.randn(t.shape, generator=gen) * (
                g / math.sqrt(t[0].numel()))
        elif leaf == "weight" and mod.endswith(("conv3.norm", "bn3")):
            x = torch.rand(t.shape, generator=gen) * 0.2 + 0.1
        elif leaf in ("weight", "running_var"):
            x = torch.rand(t.shape, generator=gen) + 0.5
        else:
            x = torch.randn(t.shape, generator=gen) * 0.05
        out[name] = x
    return out


def check_detections(out, sizes, num_classes, max_det, nonempty=True):
    """Finite values of the expected shape; valid boxes inside their
    image (with ``nonempty``, of positive width and height: YOLO keeps a
    candidate that clipping to its image leaves empty, as the JAX package
    does), classes in range."""
    import torch

    b = sizes.shape[0]
    shapes = {"boxes": (b, max_det, 4), "scores": (b, max_det),
              "classes": (b, max_det), "valid": (b, max_det)}
    for k, s in shapes.items():
        if tuple(out[k].shape) != s:
            fail(f"{k} has shape {tuple(out[k].shape)}, expected {s}")
    v = out["valid"]
    bx = out["boxes"]
    if not (torch.isfinite(bx[v]).all() and torch.isfinite(out["scores"][v])
            .all()):
        fail("non-finite detections")
    if torch.isfinite(out["scores"][~v]).any():
        fail("invalid rows carry finite scores")
    h = sizes[:, 0, None].float().expand_as(v)[v]
    w = sizes[:, 1, None].float().expand_as(v)[v]
    x0, y0, x1, y1 = bx[v].unbind(-1)
    pos = ((x1 > x0) & (y1 > y0)) if nonempty else ((x1 >= x0) & (y1 >= y0))
    if not ((x0 >= 0) & (y0 >= 0) & (x1 <= w) & (y1 <= h) & pos).all():
        fail("a valid box lies outside its image")
    c = out["classes"][v]
    if not ((c >= 0) & (c < num_classes)).all():
        fail("class id out of range")
    return int(v.sum())


class tiny_vit:
    """The port's ``VIT_CONFIGS["b"]`` set to a tiny ViT whose heads are 64
    wide, so that the attention kernels run: embed 128, 2 heads, depth 3,
    global block 1 (over the whole 8x8 grid of a 128 canvas)."""

    def __enter__(self):
        from aldi_tpu_torch.models import vit

        self.saved = vit.VIT_CONFIGS["b"]
        vit.VIT_CONFIGS["b"] = dict(embed_dim=128, depth=3, num_heads=2,
                                    drop_path_rate=0.5, global_blocks=(1,))

    def __exit__(self, *exc):
        from aldi_tpu_torch.models import vit

        vit.VIT_CONFIGS["b"] = self.saved


def config_of(config=None, overrides=None):
    """The port's cfg from ``config`` (a YAML, or the defaults) with
    ``overrides`` ({"A.B": value}) set."""
    from aldi_tpu_torch.config import get_cfg

    cfg = get_cfg()
    if config is not None:
        cfg.merge_from_file(config)
    for key, value in (overrides or {}).items():
        node = cfg
        *parents, leaf = key.split(".")
        for name in parents:
            node = node[name]
        node[leaf] = value
    return cfg


def tiny_trunk(cfg):
    """The backbone cut to its tiny float32 form: ResNet depth 26, or a
    ConvNeXt of depths (1, 1, 2, 1) and dims (16, 32, 64, 128) (the ViT is
    cut by ``tiny_vit``)."""
    cfg.MODEL.RESNETS.DEPTH = 26
    cfg.MODEL.CONVNEXT.DEPTHS = [1, 1, 2, 1]
    cfg.MODEL.CONVNEXT.DIMS = [16, 32, 64, 128]
    cfg.TPU.COMPUTE_DTYPE = "float32"  # the ViT config trains in bf16 (AMP)


def tiny_config(config=None, overrides=None):
    """``config`` (or the defaults) cut to the tiny float32 detector: depth
    26, the tiny ConvNeXt or the tiny ViT, canvas 128, 3 classes, RPN top-k
    64/32, 10 detections per image."""
    cfg = config_of(config, overrides)
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 3
    tiny_trunk(cfg)
    cfg.TPU.CANVAS = (128, 128)
    cfg.MODEL.RPN.PRE_NMS_TOPK_TEST = 64
    cfg.MODEL.RPN.POST_NMS_TOPK_TEST = 32
    cfg.MODEL.ROI_BOX_HEAD.NUM_FC = 2
    cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION = 7
    cfg.TEST.DETECTIONS_PER_IMAGE = 10
    return cfg


def tiny_reference_check(config=None):
    """A tiny float32 detector (``config`` or the defaults, depth 26, the
    tiny ConvNeXt or the tiny ViT, canvas 128, 3 classes) on the card
    against the same detector
    on the CPU, both with ``seeded_weights``, TF32 off: detections agree
    where valid (boxes 1e-3 px, scores 1e-4)."""
    import numpy as np
    import torch

    from aldi_tpu_torch.engine.export import make_serving_fn
    from aldi_tpu_torch.models import build_detector

    cfg = tiny_config(config)
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 255, (2, 128, 128, 3)).astype(np.float32)
    sizes = np.asarray([[128, 128], [100, 120]], np.int32)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        cpu = build_detector(cfg, device="cpu")
        weights = seeded_weights(cpu, seed=0)
        want = make_serving_fn(cpu, weights)(images, sizes)
        got = {k: v.cpu() for k, v in make_serving_fn(
            build_detector(cfg), weights)(images, sizes).items()}
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    m = want["valid"]
    if not torch.equal(got["valid"], m) or not m.any():
        fail("tiny detector: valid detections differ between card and CPU")
    box_err = (got["boxes"][m] - want["boxes"][m]).abs().max().item()
    score_err = (got["scores"][m] - want["scores"][m]).abs().max().item()
    same_cls = torch.equal(got["classes"][m], want["classes"][m])
    print(f"[reference] tiny float32 {model_name(cfg)} detector, card vs CPU: "
          f"{int(m.sum())} "
          f"detections, boxes max abs err {box_err:.3g} (tol 1e-3), scores "
          f"{score_err:.3g} (tol 1e-4), classes equal: {same_cls}", flush=True)
    if box_err > 1e-3 or score_err > 1e-4 or not same_cls:
        fail("tiny detector: card and CPU disagree")


def synthetic_train_batch(gen, canvas, max_gt, num_classes, n):
    """One DAOD batch on the card: n labeled images of uniform noise in
    0..255 with 5-30 gt boxes each (classes 0..num_classes-1, padded to
    max_gt) and n unlabeled noise images; most full-canvas, one smaller."""
    import torch

    def images():
        return torch.rand((n, canvas[0], canvas[1], 3), generator=gen,
                          device="cuda") * 255.0

    sizes = torch.tensor([list(canvas)] * n, dtype=torch.int32)
    sizes[1] = torch.tensor([canvas[0] - 124, canvas[1] - 248])
    sizes = sizes.cuda()
    n_gt = torch.randint(5, 31, (n,), generator=gen, device="cuda")
    boxes, classes, valid = synthetic_gt(
        gen, n, max_gt, (canvas[0] - 124, canvas[1] - 248), n_valid=n_gt,
        num_classes=num_classes)
    return {"labeled": {"image": images(), "sizes": sizes, "boxes": boxes,
                        "classes": classes, "valid": valid},
            "unlabeled": {"image": images(), "sizes": sizes.clone()}}


def params_of(module):
    return {k: v.detach().clone() for k, v in module.named_parameters()}


def training_phase(card, kernels, config=FLAGSHIP, overrides=None,
                   per_step=None, absent=()):
    """The DAOD step of ``config`` (with ``overrides``) at full width
    through its entry points (see the module docstring). ``per_step``:
    {kernel name: launches per step} that the timed steps must show;
    ``absent``: kernels they must not launch. Under MODEL.LOAD_PROPOSALS
    each labeled image carries PRECOMPUTED_PROPOSAL_TOPK_TRAIN proposals
    (``synthetic_proposals``), no ``loss_rpn_*`` may appear, and the RPN
    head, which no loss reaches, is left out of the parameters that must
    move. Returns the launch counts of the timed steps, K2's and K1's
    numbers at the step's own launches and those launches
    (``KernelLaunches``)."""
    import torch

    from aldi_tpu_torch.engine.train_step import (create_train_state,
                                                  draw_step, make_train_step,
                                                  stream_flags)
    from aldi_tpu_torch.models import build_detector

    cfg = config_of(config, overrides)
    name = model_name(cfg)
    flags = stream_flags(cfg)
    if flags.distill or flags.align:
        images = (f"{2 * TRAIN_IMAGES} ({TRAIN_IMAGES} labeled + "
                  f"{TRAIN_IMAGES} unlabeled images per step)")
    else:
        images = f"{TRAIN_IMAGES} (labeled images per step)"
    print(f"[train] {name} reduction: SOLVER.IMS_PER_BATCH "
          f"{cfg.SOLVER.IMS_PER_BATCH} -> {images}; widths, depth and "
          f"canvas as published", flush=True)
    cfg.SOLVER.IMS_PER_BATCH = 2 * TRAIN_IMAGES
    t0 = time.perf_counter()
    det = build_detector(cfg)
    state = create_train_state(cfg, det, seeded_weights(det, seed=0))
    step = make_train_step(cfg, det)
    gen = torch.Generator(device="cuda").manual_seed(2)
    n_steps = 1 + TIMED_STEPS + 2  # warm-up, timed, staged, traced
    batches = [synthetic_train_batch(gen, det.canvas, cfg.TPU.MAX_GT,
                                     det.num_classes, TRAIN_IMAGES)
               for _ in range(n_steps)]
    if cfg.MODEL.LOAD_PROPOSALS:
        for b in batches:
            lab = b["labeled"]
            lab["pboxes"], lab["pvalid"] = synthetic_proposals(
                gen, lab["boxes"], lab["valid"], lab["sizes"],
                cfg.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TRAIN)
    draws = [draw_step(gen, det, TRAIN_IMAGES, TRAIN_IMAGES)
             for _ in range(n_steps)]
    torch.cuda.synchronize()
    print(f"[train] {name}, {det.num_classes} classes, canvas {det.canvas}, "
          f"{str(det.dtype).split('.')[-1]}, {cfg.SOLVER.OPTIMIZER or 'SGD'}, "
          f"BACKWARD_AT_END {cfg.SOLVER.BACKWARD_AT_END}, activation "
          f"checkpointing {cfg.VIT.USE_ACT_CHECKPOINT and 'ViT' in name}; "
          f"state, batches and draws made in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    start = params_of(state.student)

    t0 = time.perf_counter()
    with KernelLaunches(det) as recorded:  # K1's and K2's launches
        state, m = step(state, batches[0], draws[0])
        torch.cuda.synchronize()
    print(f"[train] {name} warm-up step: "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms; its K2 launches "
          f"(boxes per image, valid boxes per level p2..p5): " + "; ".join(
              f"{r['kind']} {tuple(r['boxes'].shape[:2])} "
              f"{torch.bincount(r['levels'][r['levels'] >= 0].long(), minlength=4).tolist()}"
              for r in recorded.launches if r["kind"] != "match")
          + "; its K1 launches (valid gt per image): " + "; ".join(
              f"{r['site']} {r['valid'].sum(-1).tolist()}"
              for r in recorded.launches if r["kind"] == "match")
          + f"; box-head calls {recorded.calls}, with levels that are "
          f"not contiguous (its .contiguous() copies them before K2): "
          + ("none" if not recorded.copies else "; ".join(
              f"call {k + 1}: {n} levels, first {shape} strides {stride}, "
              f"copy {ms:.4f} ms" for k, n, shape, stride, ms
              in recorded.copies)), flush=True)
    if recorded.copies:
        fail(f"{name}: {len(recorded.copies)} box-head calls copy pyramid "
             f"levels before K2 (a stream's features are not NHWC)")

    for k in (*kernels, *absent):
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    times, metrics = [], []
    for i in range(1, 1 + TIMED_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, batches[i], draws[i])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
        if state.step == 2:
            teacher = params_of(state.teacher)
            diff = max(float((teacher[k] - v).abs().max())
                       for k, v in params_of(state.student).items())
            if not diff > 0:
                fail("the teacher equals the student after step 2")
    launches = {k.name: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated() / 2**30
    for i, mm in enumerate(metrics):
        bad = [k for k, v in mm.items() if not math.isfinite(v)]
        if bad:
            fail(f"non-finite losses at timed step {i}: {bad}")
    for kname, n in launches.items():
        if n == 0:
            fail(f"the {name} training path never launched {kname}")
    no_launches(f"{name} training", absent)
    if cfg.MODEL.LOAD_PROPOSALS and any(k.startswith("loss_rpn")
                                        for k in metrics[-1]):
        fail(f"{name}: RPN losses under MODEL.LOAD_PROPOSALS: "
             f"{sorted(metrics[-1])}")
    for kname, n in (per_step or {}).items():
        if launches[kname] != n * TIMED_STEPS:
            fail(f"{name}: {launches[kname]} launches of {kname} in "
                 f"{TIMED_STEPS} steps, {n} per step expected")
    if stream_flags(cfg).align:
        a = cfg.DOMAIN_ADAPT.ALIGN
        kinds = [k for k, on in (("img", a.IMG_DA_ENABLED),
                                 ("ins", a.INS_DA_ENABLED)) if on]
        want = {f"loss_da_{k}_{s}" for k in kinds
                for s in ("source_strong", "target_weak")}
        if not want <= set(metrics[-1]):
            fail(f"{name}: alignment losses missing: "
                 f"{sorted(want - set(metrics[-1]))}")
        print(f"[train] {name}, alignment losses of the timed steps: "
              + "; ".join(f"{k} " + ", ".join(f"{mm[k]:.5f}"
                                              for mm in metrics)
                          for k in sorted(want)), flush=True)
    moved = frozen_moved = 0
    # under MODEL.LOAD_PROPOSALS no loss reaches the RPN head: its zero
    # gradient moves it by weight decay alone, below float32's step at
    # the warm-up's learning rates
    idle = ("proposal_generator.",) if cfg.MODEL.LOAD_PROPOSALS else ()
    for pname, p in state.student.named_parameters():
        changed = not torch.equal(p.detach(), start[pname])
        if not p.requires_grad:
            frozen_moved += changed
        elif not pname.startswith(idle):
            moved += changed
    if frozen_moved:
        fail(f"{frozen_moved} frozen parameters moved")
    n_trainable = sum(p.requires_grad and not n.startswith(idle)
                      for n, p in state.student.named_parameters())
    n_frozen = sum(not p.requires_grad for p in state.student.parameters())
    if moved < n_trainable:
        fail(f"only {moved} of {n_trainable} trainable parameters moved")
    med = sorted(times)[len(times) // 2]
    print(f"[train] {name}, {TIMED_STEPS} steps: ms "
          f"{', '.join(f'{x:.2f}' for x in times)} (median {med:.2f}), "
          f"{2 * TRAIN_IMAGES * 1e3 / med:.2f} images/s at the median; "
          f"launches {launches}; peak device memory {peak:.2f} GiB; "
          f"num_pseudo_labels "
          f"{[mm.get('num_pseudo_labels', 0.0) for mm in metrics]}; "
          f"{moved} of {n_trainable} trainable parameters moved, "
          f"{n_frozen} frozen ones did not; card {card}", flush=True)
    print(f"[train] {name}, losses of the last timed step: " + json.dumps(
        {k: round(v, 5) for k, v in metrics[-1].items()}), flush=True)

    stages = {}
    t = [time.perf_counter()]

    def mark(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        stages[name] = (now - t[0]) * 1e3
        t[0] = now

    torch.cuda.synchronize()
    t[0] = time.perf_counter()
    state, _ = step(state, batches[-2], draws[-2], mark=mark)
    print(f"[train] {name}, one step by stage (ms, synchronized): "
          + "; ".join(f"{k} {v:.2f}" for k, v in stages.items()), flush=True)
    traced = device_busy(lambda: step(state, batches[-1], draws[-1]))
    if traced is None:
        print(f"[train] {name} device busy share: not measured (the profiler "
              "saw no device events)")
    else:
        busy, top, per_kernel, converters, _ = traced
        print(f"[train] {name}, traced step: device busy {busy:.2f} ms of the "
              f"{med:.2f} ms median step, idle share "
              f"{max(0.0, 1 - busy / med):.3f}; top kernels: "
              + "; ".join(f"{k[:60]} {ms:.2f} ms x{n}" for k, ms, n in top),
              flush=True)
        print(f"[train] {name}, traced step: "
              + layout_conversions(per_kernel, converters), flush=True)
    del state, batches, draws
    torch.cuda.empty_cache()
    step_kernels = time_step_launches(name, recorded.launches)
    return launches, step_kernels, recorded.launches


def moved(tree, device):
    """Tensors of a nested structure (dicts, lists, tuples, dataclasses such
    as ``Instances``) moved to ``device``."""
    import dataclasses

    import torch

    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: moved(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(moved(v, device) for v in tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: moved(getattr(tree, f.name), device)
            for f in dataclasses.fields(tree)})
    return tree


def check_card_teacher(card, got, want, module, images, sizes, draws):
    """The card's teacher pass (``got``: ctx, pseudo-labels, metrics)
    against the CPU's (``want``, moved to the card): FPN features within
    1e-4 of each level's scale, pseudo-labels' valid flags and classes
    equal and boxes within 1e-3 px. Then, on the CPU's pseudo-labels, the
    card's anchor sampler (K1a/K1b on valid gt) must pick the CPU's anchor
    set exactly, and the card's objectness and deltas at that set must
    agree within 1e-4 of their scale."""
    import torch

    from aldi_tpu_torch.models.rpn import label_anchors_sampled

    (ctx, pseudo, _), (w_ctx, w_pseudo, w_metrics) = got, want

    def rel(a, b):
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-6)

    feat_err = max(rel(a, b) for a, b in zip(ctx["feats"], w_ctx["feats"]))
    same_valid = torch.equal(pseudo.valid, w_pseudo.valid)
    m = w_pseudo.valid
    same_cls = torch.equal(pseudo.classes[m], w_pseudo.classes[m])
    box_err = float((pseudo.boxes[m] - w_pseudo.boxes[m]).abs().max()) \
        if bool(m.any()) else 0.0
    idx, valid, fg, _ = label_anchors_sampled(
        card.anchors_cat, w_pseudo.boxes, w_pseudo.valid, draws,
        card.rpn_params["batch_size_per_image"],
        card.rpn_params["positive_fraction"])
    same_set = all(torch.equal(x, w_ctx[k]) for x, k in (
        (idx, "anchor_idx"), (valid, "anchor_valid"), (fg, "anchor_fg")))
    own_set = torch.equal(ctx["anchor_idx"], w_ctx["anchor_idx"])
    _, logits, deltas, _ = card.forward_teacher(module, images, sizes)
    head_err = max(
        rel(torch.gather(logits, 1, idx), w_ctx["t_obj"]),
        rel(torch.gather(deltas, 1, idx[..., None].expand(-1, -1, 4)),
            w_ctx["t_delta"]))
    n_pseudo = float(w_metrics["num_pseudo_labels"])
    print(f"[reference] tiny teacher pass, card vs CPU: {n_pseudo:g} "
          f"pseudo-labels per image; features max err / scale "
          f"{feat_err:.3g} (tol 1e-4); pseudo-labels valid equal {same_valid},"
          f" classes equal {same_cls}, boxes max abs err {box_err:.3g} (tol "
          f"1e-3); anchor set from the CPU's pseudo-labels equal {same_set}; "
          f"from its own {own_set}; objectness and deltas at it max err / "
          f"scale {head_err:.3g} (tol 1e-4)", flush=True)
    if not n_pseudo > 0:
        fail("tiny teacher pass: no pseudo-labels to check")
    if (feat_err > 1e-4 or not same_valid or not same_cls or box_err > 1e-3
            or not same_set or head_err > 1e-4):
        fail("tiny teacher pass: card and CPU disagree")


def tiny_train_reference_check(config=FLAGSHIP, overrides=None):
    """One DAOD step of a tiny float32 detector (depth 26, the tiny ConvNeXt
    or the tiny ViT, canvas 128, 3 classes, the recipe of ``config`` with
    ``overrides``) on the card against
    the same step on the CPU: the same seeded weights, batch and draws (made on the CPU and
    moved to the card), TF32 off for matrix products and cuDNN. The card's
    teacher pass is held against the CPU's (``check_card_teacher``), and
    the card's step then goes on from the CPU's teacher context and
    pseudo-labels: the low-quality match tests IoU equality, and
    pseudo-label boxes one ulp apart on the two devices could break a tie.
    So the distill stream's anchor matching and sampling on the card run on
    the CPU's pseudo-labels. Losses agree within 1e-4 relative, parameters
    within 1e-5. With AdamW (the ViT recipe) the first step is lr * sign(g)
    nearly, and an entry whose gradient sits at its tensor's float32 noise
    moves by up to the learning rate either way on each device: there 99%
    of the entries are held to 1e-5 and all to 2.5 x the learning rate (a
    flipped sign moves an entry by 2 x the learning rate, plus rounding)."""
    import numpy as np
    import torch

    from aldi_tpu_torch.engine.train_step import (create_train_state,
                                                  draw_step, make_train_step)
    from aldi_tpu_torch.models import build_detector

    cfg = config_of(config, overrides)
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 3
    tiny_trunk(cfg)
    cfg.TPU.CANVAS = (128, 128)
    cfg.TPU.MAX_GT = 8
    for k, v in (("PRE_NMS_TOPK_TRAIN", 64), ("POST_NMS_TOPK_TRAIN", 32),
                 ("PRE_NMS_TOPK_TEST", 64), ("POST_NMS_TOPK_TEST", 32)):
        cfg.MODEL.RPN[k] = v
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 16
    cfg.TEST.DETECTIONS_PER_IMAGE = 10
    cfg.DOMAIN_ADAPT.TEACHER.THRESHOLD = 0.5
    cfg.SOLVER.BASE_LR = 0.01
    cfg.SOLVER.WARMUP_ITERS = 0
    rng = np.random.default_rng(0)
    boxes = np.zeros((2, 8, 4), np.float32)
    boxes[:, :3, :2] = rng.uniform(0, 80, (2, 3, 2))
    boxes[:, :3, 2:] = boxes[:, :3, :2] + rng.uniform(12, 48, (2, 3, 2))
    batch = {"labeled": {
        "image": rng.uniform(0, 255, (2, 128, 128, 3)).astype(np.float32),
        "sizes": np.array([[128, 128], [112, 120]], np.int32),
        "boxes": boxes, "classes": rng.integers(0, 3, (2, 8)).astype(
            np.int32), "valid": np.arange(8)[None].repeat(2, 0) < 3},
        "unlabeled": {
        "image": rng.uniform(0, 255, (2, 128, 128, 3)).astype(np.float32),
        "sizes": np.array([[128, 128], [120, 100]], np.int32)}}
    batch = {s: {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}
             for s, d in batch.items()}
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        cpu, card = build_detector(cfg, device="cpu"), build_detector(cfg)
        weights = seeded_weights(cpu, seed=1)
        draws = draw_step(torch.Generator().manual_seed(3), cpu, 2, 2)
        teacher_ctx = {}
        cpu_teacher_ctx = cpu.forward_teacher_ctx
        card_teacher_ctx = card.forward_teacher_ctx

        def record(*args, **kwargs):
            teacher_ctx["cpu"] = cpu_teacher_ctx(*args, **kwargs)
            return teacher_ctx["cpu"]

        def from_cpu(module, images, sizes, t_draws, **kwargs):
            got = card_teacher_ctx(module, images, sizes, t_draws, **kwargs)
            want = moved(teacher_ctx["cpu"], card.device)
            check_card_teacher(card, got, want, module, images, sizes,
                               t_draws)
            return want

        cpu.forward_teacher_ctx = record
        card.forward_teacher_ctx = from_cpu
        results = []
        for det in (cpu, card):
            state = create_train_state(cfg, det, weights)
            step = make_train_step(cfg, det)
            state, m = step(state, moved(batch, det.device),
                            moved(draws, det.device))
            results.append(({k: float(v) for k, v in m.items()},
                            params_of(state.student)))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    (want_m, want_p), (got_m, got_p) = results
    loss_err = max(abs(got_m[k] - v) / max(abs(v), 1e-3)
                   for k, v in want_m.items())
    diffs = [(got_p[k].cpu() - v).abs() for k, v in want_p.items()]
    param_err = max(float(d.max()) for d in diffs)
    beyond = sum(int((d > 1e-5).sum()) for d in diffs)
    total = sum(d.numel() for d in diffs)
    adamw = (cfg.SOLVER.OPTIMIZER or "SGD").upper() == "ADAMW"
    ok = loss_err <= 1e-4 and (
        beyond <= 0.01 * total and param_err <= 2.5 * cfg.SOLVER.BASE_LR
        if adamw else param_err <= 1e-5)
    print(f"[reference] tiny float32 {model_name(cfg)} DAOD step "
          f"({'AdamW' if adamw else 'SGD'}), card vs CPU: losses "
          f"{ {k: round(v, 5) for k, v in want_m.items()} }; worst relative "
          f"loss error {loss_err:.3g} (tol 1e-4), parameters max abs err "
          f"{param_err:.3g}, {beyond} of {total} entries beyond 1e-5 (tol "
          + (f"1%, all within {2.5 * cfg.SOLVER.BASE_LR:g})" if adamw
             else "0)"), flush=True)
    if not ok:
        fail("tiny DAOD step: card and CPU disagree")


CONVERSIONS = ("nchwToNhwcKernel", "nhwcToNchwKernel")


def layout_conversions(per_kernel, converters):
    """A log line's text: the layout-conversion kernels of a trace, by kind,
    and the operators that launched them (``device_busy``)."""
    text = "layout conversions " + "; ".join(
        f"{kind} {sum(n for k, (_, n) in per_kernel.items() if kind in k)}"
        f" launches, "
        f"{sum(ms for k, (ms, _) in per_kernel.items() if kind in k):.2f} ms"
        for kind in CONVERSIONS)
    if converters:
        text += "; launched by " + "; ".join(
            f"{op} x{n}" for op, n in sorted(converters.items(),
                                            key=lambda kv: -kv[1]))
    return text


def device_busy(fn):
    """Trace one call of ``fn`` (a request or a step) with torch.profiler.
    Returns the device's busy time in ms (the union of its kernel and copy
    intervals), the six kernels with the most time (name, ms, calls),
    {name: (ms, calls)} of every kernel and {operator and its first input
    shapes: count} of the layout-conversion kernels' launching operators
    and {name: (device ms, count)} of the port's ``aldi/`` profiler ranges
    (``aldi_tpu_torch/utils/tracing.py``: the device time of the kernels
    launched inside each); or None when the trace holds no device
    events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        return None
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    per_kernel = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, n = per_kernel.get(e.name, (0.0, 0))
            per_kernel[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:6]
    converters = {}
    for e in prof.events():
        for k in getattr(e, "kernels", None) or []:
            if any(kind in k.name for kind in CONVERSIONS):
                op = f"{e.name} {e.input_shapes[:2]}"
                converters[op] = converters.get(op, 0) + 1
    ranges = {}
    for e in prof.events():
        if e.name.startswith("aldi/"):
            ms, n = ranges.get(e.name, (0.0, 0))
            ranges[e.name] = (ms + e.device_time_total / 1e3, n + 1)
    return (busy_us / 1e3, [(k, ms, n) for k, (ms, n) in top], per_kernel,
            converters, ranges)


def serving_phase(card, config, kernels, numbers=None):
    """One detector of ``config`` through ``build_detector`` and
    ``make_serving_fn`` at full width (see the module docstring). With
    ``numbers``, K2's forward is held against its plain version on the last
    request's real proposals and its numbers stored there. Returns the
    launch counts of the timed requests."""
    import torch

    from aldi_tpu_torch.config import get_cfg
    from aldi_tpu_torch.engine.export import make_serving_fn
    from aldi_tpu_torch.models import build_detector

    cfg = get_cfg()
    cfg.merge_from_file(config)
    t0 = time.perf_counter()
    det = build_detector(cfg)
    fn = make_serving_fn(det, seeded_weights(det, seed=0))
    torch.cuda.synchronize()
    name = model_name(cfg)
    print(f"[serving] {name}, {det.num_classes} classes, canvas {det.canvas}, "
          f"{str(det.dtype).split('.')[-1]}; built and seeded in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(1)
    requests = [synthetic_request(gen, det.canvas)
                for _ in range(1 + TIMED_REQUESTS)]
    t0 = time.perf_counter()
    out = fn(*requests[0])
    torch.cuda.synchronize()
    print(f"[serving] {name} warm-up request: "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms", flush=True)

    for k in kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    latencies, n_det = [], 0
    for images, sizes in requests[1:]:
        t0 = time.perf_counter()
        out = fn(images, sizes)
        torch.cuda.synchronize()
        latencies.append((time.perf_counter() - t0) * 1e3)
        n_det += check_detections(out, sizes, det.num_classes,
                                  cfg.TEST.DETECTIONS_PER_IMAGE)
    launches = {k.name: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated() / 2**30
    for kname, n in launches.items():
        if n == 0:
            fail(f"the {name} serving path never launched {kname}")
    if n_det == 0:
        fail(f"{name}: no valid detections in any request")
    lat = sorted(latencies)
    median = lat[len(lat) // 2]
    print(f"[serving] {name}, {TIMED_REQUESTS} requests of {BATCH} images: "
          f"latency ms {', '.join(f'{x:.2f}' for x in latencies)} (median "
          f"{median:.2f}), {BATCH * 1e3 / median:.2f} images/s at the "
          f"median; {n_det} valid detections; launches {launches}; peak "
          f"device memory {peak:.2f} GiB; card {card}", flush=True)

    images, sizes = requests[-1]
    stages = getattr(getattr(det.module.backbone, "bottom_up", None),
                     "stages", None)
    if stages is not None:
        print(f"[serving] {name}: " + trunk_scale(det, images), flush=True)
    if numbers is not None:  # K2 on the last request's real proposals
        feats, pboxes, levels, copied = request_proposals(det, images, sizes)
        print(f"[serving] {name}: {copied} of {len(feats)} pyramid levels "
              f"were not contiguous before the pooler (box_pooler's "
              f".contiguous() copies those)", flush=True)
        numbers["roi_align_fwd"] = check_roi(
            "serving request, real proposals", feats, pboxes, levels)
        del feats

    traced = device_busy(lambda: fn(images, sizes))
    if traced is None:
        print(f"[serving] {name} device busy share: not measured (the "
              "profiler saw no device events)")
    else:
        busy, top, per_kernel, converters, ranges = traced
        print(f"[serving] {name}, traced request: device busy {busy:.2f} ms "
              f"of the {median:.2f} ms median request, idle share "
              f"{max(0.0, 1 - busy / median):.3f}; top kernels: "
              + "; ".join(f"{k[:60]} {ms:.2f} ms x{n}" for k, ms, n in top),
              flush=True)
        staged = sum(ms for k, (ms, _) in ranges.items()
                     if k.startswith("aldi/serve/"))
        print(f"[serving] {name}, traced request by range (device ms, "
              f"count): " + "; ".join(f"{k} {ms:.2f} x{n}" for k, (ms, n)
                                      in sorted(ranges.items()))
              + f"; the four stages {100 * staged / busy:.1f}% of the busy "
              "time", flush=True)
        print(f"[serving] {name}, traced request: "
              + layout_conversions(per_kernel, converters), flush=True)
    del det, fn, requests, out
    torch.cuda.empty_cache()
    return launches


def trunk_scale(det, images):
    """A log line's text: the standard deviation of a ConvNeXt trunk's
    residual stream at the end of each stage (before the output LN) on
    one request, and of its p2..p6 levels: O(1) shows that the seeded
    weights keep the activations in range through every block."""
    import torch

    stages = det.module.backbone.bottom_up.stages
    seen = []
    hooks = [stage[-1].register_forward_hook(
        lambda _m, _i, out: seen.append(float(out.float().std())))
        for stage in stages]
    try:
        with torch.inference_mode():
            feats = det.backbone(det.preprocess(images))
    finally:
        for h in hooks:
            h.remove()
    return ("residual stream std after stages 0-3 " + fmt(seen, 3)
            + "; p2..p6 std " + fmt([float(f.float().std()) for f in feats],
                                    3))


def request_proposals(det, images, sizes):
    """The pooler's inputs of one request: the levels p2..p5 as the box
    head hands them to ``box_pooler``, the proposals [B, P, 4] float32 and
    their levels; and how many levels were not contiguous before (the box
    head's ``.contiguous()`` copies those)."""
    import torch

    from aldi_tpu_torch.ops.roi_align import box_levels

    with torch.inference_mode():
        feats = det.backbone(det.preprocess(images))
        logits, deltas = det.rpn_head(feats)
        pboxes, _, pvalid = det.proposals(logits, deltas, sizes)
    copied = sum(not f.is_contiguous() for f in feats[:-1])
    feats = [f.contiguous() for f in feats[:-1]]
    pboxes = pboxes.float().contiguous()
    return feats, pboxes, box_levels(pboxes, pvalid, det.roi_strides), copied


def artifact_level_copies(model, images, sizes):
    """One request through a loaded artifact's graph, node by node: the
    pyramid levels K2's forward op takes that the graph had to copy first
    (a ``contiguous`` or ``clone`` node whose input was not contiguous),
    as (node, shape, strides): the artifact's counterpart of a box-head
    call that copies a level. The graph may hold a ``contiguous`` node that
    copies nothing."""
    import torch

    graph_module = model.module
    feeds = {f for n in graph_module.graph.nodes
             if n.op == "call_function"
             and str(n.target).startswith("aldi_tpu_torch.roi_align_fwd")
             for f in n.args[0]}
    copies = []

    class Probe(torch.fx.Interpreter):
        def run_node(self, n):
            if n in feeds and n.op == "call_function" and any(
                    s in str(n.target) for s in ("contiguous", "clone")):
                x = self.env[n.args[0]]
                if not x.is_contiguous():
                    copies.append((n.name, tuple(x.shape), x.stride()))
            return super().run_node(n)

    with torch.no_grad():
        Probe(graph_module).run(images, sizes)
    return copies


def kernel_ops_of(program):
    """The kernels' custom ops the exported graph calls, with their
    counts."""
    ops = {}
    for node in program.graph.nodes:
        name = str(node.target)
        if node.op == "call_function" and name.startswith("aldi_tpu_torch."):
            ops[name.split(".")[1]] = ops.get(name.split(".")[1], 0) + 1
    return ops


def outputs_differ(got, want):
    """{output: max abs err (or the count of unequal entries for valid and
    classes)} over the outputs that are not bitwise equal; boxes and scores
    compared where both are valid."""
    import torch

    diff = {}
    for k in ("valid", "classes"):
        if not torch.equal(got[k], want[k]):
            diff[k] = int((got[k] != want[k]).sum())
    m = got["valid"] & want["valid"]
    for k in ("boxes", "scores"):
        if not torch.equal(got[k][m], want[k][m]):
            diff[k] = (got[k][m].float() - want[k][m].float()).abs().max(
            ).item()
    return diff


def artifact_phase(card, config, kernels, per_request):
    """The serving artifact of ``config`` at full width (see the module
    docstring): exported for ``cuda`` through ``export_inference`` with
    ``seeded_weights``, saved into a temporary directory, loaded with
    ``load_artifact`` and served, every request held bitwise against the
    eager ``make_serving_fn`` on the same weights. ``per_request``: the
    launches each request must make of each kernel. Returns the launch
    counts of the timed artifact requests."""
    import gc
    import tempfile

    import torch

    from aldi_tpu_torch.config import get_cfg
    from aldi_tpu_torch.engine.export import (export_inference, load_artifact,
                                              make_serving_fn, save_artifact)
    from aldi_tpu_torch.models import build_detector

    cfg = get_cfg()
    cfg.merge_from_file(config)
    det = build_detector(cfg)
    name = model_name(cfg)
    t0 = time.perf_counter()
    programs = export_inference(det, seeded_weights(det, seed=0), BATCH,
                                platforms=("cuda",))
    export_s = time.perf_counter() - t0
    program = programs["cuda"]
    ops = kernel_ops_of(program)
    print(f"[artifact] {name}: exported for cuda in {export_s:.2f} s; the "
          f"graph calls the kernels' ops {ops}", flush=True)
    if ops != per_request:
        fail(f"{name} artifact: the exported graph calls {ops}, expected "
             f"{per_request}")
    fn = make_serving_fn(det)
    gen = torch.Generator(device="cuda").manual_seed(1)
    requests = [synthetic_request(gen, det.canvas)
                for _ in range(1 + TIMED_REQUESTS)]
    with tempfile.TemporaryDirectory(prefix="aldi_smoke_artifact_") as tmp:
        t0 = time.perf_counter()
        save_artifact(tmp, programs, det, cfg, BATCH)
        save_s = time.perf_counter() - t0
        del programs, program
        size = sum(os.path.getsize(os.path.join(tmp, f))
                   for f in os.listdir(tmp))
        t0 = time.perf_counter()
        model = load_artifact(tmp)
        load_s = time.perf_counter() - t0
    if model.platform != "cuda" or model.meta["platforms"] != ["cuda"]:
        fail(f"{name} artifact: loaded {model.platform}, platforms "
             f"{model.meta['platforms']}")
    t0 = time.perf_counter()
    model(*requests[0])
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    fn(*requests[0])
    copies = artifact_level_copies(model, *requests[0])
    torch.cuda.synchronize()
    print(f"[artifact] {name}: pyramid levels the loaded graph copies "
          f"before K2: {copies or 'none'}", flush=True)
    if copies:
        fail(f"{name} artifact: the loaded graph copies pyramid levels "
             f"before K2: {copies}")

    for k in kernels:
        k.launches = 0
    latencies, outs, n_det = [], [], 0
    for images, sizes in requests[1:]:
        t0 = time.perf_counter()
        out = model(images, sizes)
        torch.cuda.synchronize()
        latencies.append((time.perf_counter() - t0) * 1e3)
        n_det += check_detections(
            out, sizes, det.num_classes, cfg.TEST.DETECTIONS_PER_IMAGE,
            nonempty=cfg.MODEL.META_ARCHITECTURE == "GeneralizedRCNN")
        outs.append(out)
    launches = {k.name: k.launches for k in kernels}
    want = {k.name: n * TIMED_REQUESTS for k, n in zip(
        kernels, (per_request.get(k.name, 0) for k in kernels))}
    if launches != want:
        fail(f"{name} artifact: {TIMED_REQUESTS} requests launched "
             f"{launches}, expected {want}")
    eager = []
    for (images, sizes), out in zip(requests[1:], outs):
        t0 = time.perf_counter()
        ref = fn(images, sizes)
        torch.cuda.synchronize()
        eager.append((time.perf_counter() - t0) * 1e3)
        diff = outputs_differ(out, ref)
        if diff:
            fail(f"{name} artifact: outputs differ from the eager serving "
                 f"path on the same request: {diff}")
    print(f"[artifact] {name}, {BATCH} x {det.canvas[0]}x{det.canvas[1]} "
          f"{str(det.dtype).split('.')[-1]}: export {export_s:.2f} s, save "
          f"{save_s:.2f} s ({size / 1e6:.1f} MB on disk), load {load_s:.2f} "
          f"s, warm-up request {warm_ms:.1f} ms; {TIMED_REQUESTS} requests: "
          f"artifact ms {fmt(latencies)} (median {median(latencies):.2f}), "
          f"eager ms {fmt(eager)} (median {median(eager):.2f}); {n_det} "
          f"valid detections, every output bitwise equal to eager; launches "
          f"{launches}; card {card}", flush=True)
    images, sizes = requests[-1]
    for label, call, ms in (("artifact", model, median(latencies)),
                            ("eager", fn, median(eager))):
        traced = device_busy(lambda: call(images, sizes))
        if traced is None:
            print(f"[artifact] {name}, traced {label} request: device busy "
                  "not measured (the profiler saw no device events)")
            continue
        busy, _, per_kernel, _, _ = traced
        print(f"[artifact] {name}, traced {label} request: device busy "
              f"{busy:.2f} ms of the {ms:.2f} ms median, idle share "
              f"{max(0.0, 1 - busy / ms):.3f}, "
              f"{sum(n for _, n in per_kernel.values())} device kernels and "
              "copies", flush=True)
    del det, fn, model, requests, outs
    gc.collect()  # the programs' graphs are reference cycles
    torch.cuda.empty_cache()
    return launches


def tiny_artifact_check():
    """The tiny float32 R50-FPN of ``tiny_reference_check`` on the card
    with ``seeded_weights``, exported for ``cpu`` and ``cuda``, saved and
    loaded: the ``cuda`` program bitwise equal to the eager serving path
    on the card, and the ``cpu`` program within ``tiny_reference_check``'s
    tolerances of it (TF32 off)."""
    import tempfile

    import numpy as np
    import torch

    from aldi_tpu_torch.engine.export import (export_inference, load_artifact,
                                              make_serving_fn, save_artifact)
    from aldi_tpu_torch.models import build_detector

    cfg = tiny_config()
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 255, (2, 128, 128, 3)).astype(np.float32)
    sizes = np.asarray([[128, 128], [100, 120]], np.int32)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        det = build_detector(cfg)
        programs = export_inference(det, seeded_weights(det, seed=0), 2)
        eager = make_serving_fn(det)(images, sizes)
        with tempfile.TemporaryDirectory(prefix="aldi_smoke_tiny_") as tmp:
            save_artifact(tmp, programs, det, cfg, 2)
            models = {p: load_artifact(tmp, platform=p)
                      for p in ("cpu", "cuda")}
        got = {p: m(images, sizes) for p, m in models.items()}
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    if sorted(programs) != ["cpu", "cuda"]:
        fail(f"tiny artifact: export_inference on a card wrote "
             f"{sorted(programs)}, expected cpu and cuda")
    diff = outputs_differ(got["cuda"], eager)
    if diff:
        fail(f"tiny artifact: the cuda program differs from eager: {diff}")
    cpu, on_card = ({k: v.cpu() for k, v in got[p].items()}
                    for p in ("cpu", "cuda"))
    m = on_card["valid"]
    if not torch.equal(cpu["valid"], m) or not m.any():
        fail("tiny artifact: valid detections differ between the cpu and "
             "the cuda program")
    box_err = (cpu["boxes"][m] - on_card["boxes"][m]).abs().max().item()
    score_err = (cpu["scores"][m] - on_card["scores"][m]).abs().max().item()
    same_cls = torch.equal(cpu["classes"][m], on_card["classes"][m])
    print(f"[artifact] tiny float32 R26-FPN: the cuda program equals eager "
          f"bitwise; cpu vs cuda program: {int(m.sum())} detections, boxes "
          f"max abs err {box_err:.3g} (tol 1e-3), scores {score_err:.3g} "
          f"(tol 1e-4), classes equal: {same_cls}", flush=True)
    if box_err > 1e-3 or score_err > 1e-4 or not same_cls:
        fail("tiny artifact: the cpu and cuda programs disagree")


class KernelLaunches:
    """While active, records every K2 forward and backward launch (copies
    of its boxes and levels, its level shapes, channels, dtype and
    strides) and every K1a launch (copies of its anchors, gt and flags and
    its call site: the teacher's ``forward_teacher_ctx`` or a student
    stream's ``forward_train``, which holds the teacher's pseudo-labels in
    the distill stream; K1b follows each on the same inputs); and, per call of
    the box head, the levels it hands to ``box_pooler`` that are not
    contiguous (the box head's ``.contiguous()`` copies them before K2),
    with the shape and strides of the first and the time of that copy on
    the card."""

    def __init__(self, det):
        self.det = det
        self.launches = []
        self.calls = 0
        self.copies = []  # (call, levels, shape, strides, ms)
        self.site = self.pseudo = None

    def __enter__(self):
        from aldi_tpu_torch.ops.match_kernel import MatchIou
        from aldi_tpu_torch.ops.roi_align_kernel import (RoiAlignBwd,
                                                         RoiAlignFwd)

        self.saved = (RoiAlignFwd.__call__, RoiAlignBwd.__call__,
                      MatchIou.__call__)
        fwd, bwd, match = self.saved
        rec = self.launches

        def fwd_call(kernel, features, boxes, levels, strides, output_size=7,
                     sampling_ratio=2):
            rec.append(dict(kind="forward", boxes=boxes.clone(),
                            levels=levels.clone(), strides=list(strides),
                            hws=[tuple(f.shape[1:3]) for f in features],
                            c=features[0].shape[-1],
                            dtype=features[0].dtype, out=output_size))
            return fwd(kernel, features, boxes, levels, strides, output_size,
                       sampling_ratio)

        def bwd_call(kernel, grad, boxes, levels, feat_shapes, feat_dtype,
                     strides, sampling_ratio=2):
            rec.append(dict(kind="backward", boxes=boxes.clone(),
                            levels=levels.clone(), strides=list(strides),
                            hws=[tuple(hw) for hw in feat_shapes],
                            c=grad.shape[-1], dtype=grad.dtype,
                            out=grad.shape[2]))
            return bwd(kernel, grad, boxes, levels, feat_shapes, feat_dtype,
                       strides, sampling_ratio)

        def match_call(kernel, anchors, gt_boxes, gt_valid):
            if self.site is None:
                fail("a K1 call outside the teacher's and the streams' "
                     "forward passes")
            rec.append(dict(kind="match", anchors=anchors.clone(),
                            gt=gt_boxes.clone(), valid=gt_valid.clone(),
                            site=self.site))
            return match(kernel, anchors, gt_boxes, gt_valid)

        teacher_ctx, forward_train = (self.det.forward_teacher_ctx,
                                      self.det.forward_train)

        def teacher_call(*args, **kwargs):
            self.site = "teacher distill anchors (pseudo-labels)"
            out = teacher_ctx(*args, **kwargs)
            self.site, self.pseudo = None, out[1]
            return out

        def train_call(module, images, sizes, gt, draws, **kwargs):
            self.site = ("distill stream RPN loss (pseudo-labels)"
                         if gt is self.pseudo else
                         "strong stream RPN loss (labeled gt)")
            out = forward_train(module, images, sizes, gt, draws, **kwargs)
            self.site = None
            return out

        RoiAlignFwd.__call__, RoiAlignBwd.__call__ = fwd_call, bwd_call
        MatchIou.__call__ = match_call
        box_head = self.det.box_head

        def head(features, *args, **kwargs):
            strided = [f for f in features[:-1] if not f.is_contiguous()]
            if strided:
                self.copies.append((
                    self.calls, len(strided), tuple(strided[0].shape),
                    strided[0].stride(),
                    cuda_ms(lambda: [f.contiguous() for f in strided], 3,
                            warmup=1)))
            self.calls += 1
            return box_head(features, *args, **kwargs)

        self.det.box_head = head
        self.det.forward_teacher_ctx = teacher_call
        self.det.forward_train = train_call
        return self

    def __exit__(self, *exc):
        from aldi_tpu_torch.ops.match_kernel import MatchIou
        from aldi_tpu_torch.ops.roi_align_kernel import (RoiAlignBwd,
                                                         RoiAlignFwd)

        (RoiAlignFwd.__call__, RoiAlignBwd.__call__,
         MatchIou.__call__) = self.saved
        del (self.det.box_head, self.det.forward_teacher_ctx,
             self.det.forward_train)


def time_step_launches(model, launches, seed=40, plain_iters=1,
                       backward=None):
    """K2's forward and backward (``backward``: as for ``check_roi_bwd``)
    and K1a/K1b at one training step's own launches: each recorded K2
    launch's real boxes and levels with seeded random features or cotangent
    of its shapes, each K1 call's own anchors and gt, held against the plain
    versions and timed. Returns the per-launch numbers."""
    import torch

    out, total = [], {"forward": 0.0, "backward": 0.0, "match": 0.0}
    for i, rec in enumerate(launches):
        if rec["kind"] == "match":  # K1a and K1b on this call's inputs
            r = check_match(f"{model} step, {rec['site']}", rec["anchors"],
                            rec["gt"], rec["valid"], plain_iters=plain_iters,
                            kernel_iters=10)
            total["match"] += sum(v["ms"] for v in r.values())
            out.append(dict(kind="match", site=rec["site"],
                            valid_gt=rec["valid"].sum(-1).tolist(), **r))
            continue
        if rec["strides"] != ROI_STRIDES or rec["out"] != 7:
            fail(f"{model}: a K2 launch with strides {rec['strides']} and "
                 f"output {rec['out']}, not the pooler's")
        g = torch.Generator(device="cuda").manual_seed(seed + i)
        b, p = rec["boxes"].shape[:2]
        name = f"{model} step launch {i + 1} ({rec['kind']})"
        if rec["kind"] == "forward":
            feats = [torch.randn((b, h, w, rec["c"]), generator=g,
                                 device="cuda").to(rec["dtype"])
                     for h, w in rec["hws"]]
            r = check_roi(name, feats, rec["boxes"], rec["levels"],
                          plain_iters=plain_iters, kernel_iters=10)
            del feats
        else:
            grad = torch.randn((b, p, 7, 7, rec["c"]), generator=g,
                               device="cuda").to(rec["dtype"])
            r = check_roi_bwd(name, grad, rec["boxes"], rec["levels"],
                              rec["hws"], plain_iters=plain_iters,
                              kernel_iters=10, backward=backward)
        total[rec["kind"]] += r["ms"]
        out.append(dict(kind=rec["kind"], boxes=[b, p], **r))
    print(f"[train] {model}: K2 and K1a + K1b at the step's own launches, "
          "per step: " + "; ".join(
              f"{k} {sum(o['kind'] == k for o in out)} launches, {v:.4f} ms"
              for k, v in total.items()), flush=True)
    return out


DECODER_SHORTS = (800, 896, 1024)  # MIN_SIZE_TRAIN's ends and a middle
DECODER_IMAGES = 16  # per format


def host_cpu():
    """The host CPU as /proc/cpuinfo names it, and the core count."""
    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break
                key, _, value = line.partition(":")
                fields[key.strip()] = value.strip()
    except OSError:
        pass
    return (f"{fields.get('model name', 'unknown')} (vendor "
            f"{fields.get('vendor_id', '?')}, family "
            f"{fields.get('cpu family', '?')}, model "
            f"{fields.get('model', '?')}); os.cpu_count() {os.cpu_count()}")


def texture_split(root, name, n, seed, fmt, size=(1024, 2048)):
    """``n`` noise-textured images of ``size`` (h, w), which a PNG or JPEG
    coder treats as it does a photograph (a smooth random field, bicubic
    from 1/32 of the size, plus per-pixel noise of std 12; not the
    trainer phase's flat rectangles): PNGs at PIL's default compression or
    JPEGs at quality 95, written by 8 threads, with a COCO json of 3 boxes
    each. Returns (json path, image dir, image paths)."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from PIL import Image

    h, w = size
    img_dir = os.path.join(root, name, "images")
    os.makedirs(img_dir, exist_ok=True)
    ext = {"png": "png", "jpeg": "jpg"}[fmt]

    def one(i):
        rng = np.random.default_rng((seed, i))
        field = Image.fromarray(rng.integers(
            0, 256, (h // 32, w // 32, 3), np.uint8)).resize(
                (w, h), Image.BICUBIC)
        img = np.asarray(field, np.int16) + rng.normal(
            0, 12, (h, w, 3)).astype(np.int16)
        path = os.path.join(img_dir, f"{i:04d}.{ext}")
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
            path, **({"quality": 95} if fmt == "jpeg" else {}))
        return path

    with ThreadPoolExecutor(8) as pool:
        paths = list(pool.map(one, range(n)))
    coco = {"images": [{"id": i + 1, "file_name": os.path.basename(p),
                        "height": h, "width": w}
                       for i, p in enumerate(paths)],
            "annotations": [{"id": 3 * i + k + 1, "image_id": i + 1,
                             "category_id": k + 1,
                             "bbox": [100 + 300 * k, 200, 200, 150],
                             "area": 30000, "iscrowd": 0}
                            for i in range(n) for k in range(3)],
            "categories": [{"id": c + 1, "name": f"class{c}"}
                           for c in range(8)]}
    path = os.path.join(root, name, "annotations.json")
    with open(path, "w") as f:
        json.dump(coco, f)
    return path, img_dir, paths


def loader_images_per_s(cfg, threads, batches):
    """``WeakStrongLoader`` at SOLVER.IMS_PER_BATCH (24 + 24) with
    ``threads`` TPU.DATA_THREADS per stream: images/s over ``batches``
    batches from its construction (the prefetch ramp included), its pools
    drained afterwards, untimed."""
    from aldi_tpu_torch.data.loader import WeakStrongLoader

    t0 = time.perf_counter()
    loader = WeakStrongLoader(cfg, tuple(cfg.TPU.CANVAS), seed=0,
                              num_threads=threads)
    n = 0
    for _ in range(batches):
        b = next(loader)
        n += b["labeled"]["image"].shape[0] + b["unlabeled"]["image"].shape[0]
    dt = time.perf_counter() - t0
    for stream in (loader.labeled, loader.unlabeled):
        stream._pool.shutdown(wait=True, cancel_futures=True)
    return n / dt


def decoder_phase(card):
    """The host decoder on the card's host (``aldi_tpu_torch/data/
    native.py``, ``csrc/native_decode.cpp``): the loaders' branch and why
    (native where the core builds with libjpeg and libpng, else PIL, as the
    JAX package decides), the core without its codecs built (compiler,
    version, seconds; a core that does not build fails the run) and held
    bitwise against ``load_resize_pad_plain`` on noise-textured 2048x1024
    PNGs and JPEGs; one image per call on one thread: PIL's decode alone,
    that core and ``apply_transform`` on the loaders' branch; both on a
    thread pool of 1 and 8; ``WeakStrongLoader`` at 24 + 24 with 8 and 1
    threads and ``TestLoader`` on the loaders' branch. Returns the
    numbers."""
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from aldi_tpu_torch.config import get_cfg
    from aldi_tpu_torch.data import native
    from aldi_tpu_torch.data.catalog import (DatasetCatalog,
                                             register_coco_instances)
    from aldi_tpu_torch.data.loader import TestLoader
    from aldi_tpu_torch.data.transforms import apply_transform
    from aldi_tpu_torch.ops import _build

    t_phase = time.perf_counter()
    compiler = _build.cxx()
    version = subprocess.run([compiler, "--version"], capture_output=True,
                             text=True).stdout.splitlines()[0]
    t0 = time.perf_counter()
    branch, why = native.decoder()
    branch_s = time.perf_counter() - t0
    print(f"[decoder] the loaders' branch: {branch} ({why}), decided in "
          f"{branch_s:.2f} s; compiler {compiler} ({version}); host CPU "
          f"{host_cpu()}; card {card}", flush=True)
    t0 = time.perf_counter()
    try:
        core = native.Core(codecs=False)
    except (RuntimeError, OSError) as e:
        fail(f"the native core without codecs did not build on this "
             f"machine: {e}")
    build_s = time.perf_counter() - t0
    print(f"[decoder] the core without its codecs (PIL decodes, the core "
          f"resizes; no branch of the loaders) built and loaded in "
          f"{build_s:.2f} s", flush=True)
    numbers = {"decoder": branch, "how": why, "branch_s": branch_s,
               "build_s": build_s, "host_cpu": host_cpu(), "card": card}
    tmp = tempfile.mkdtemp(prefix="aldi_smoke_decoder_")

    def loaders(r):
        return apply_transform(r, (896, False, None), 2048, (1024, 2048))

    def core_only(r):
        return core.load_resize_pad(r["file_name"], 896, 2048, 1024, 2048,
                                    True, False)

    try:
        t0 = time.perf_counter()
        splits = {fmt: texture_split(tmp, f"decoder_{fmt}", DECODER_IMAGES,
                                     seed, fmt)
                  for fmt, seed in (("png", 31), ("jpeg", 32))}
        sizes = {fmt: sum(os.path.getsize(p) for p in s[2]) / len(s[2]) / 2**20
                 for fmt, s in splits.items()}
        print(f"[decoder] {DECODER_IMAGES} PNGs and {DECODER_IMAGES} JPEGs "
              f"(quality 95) of 2048x1024 noise texture written in "
              f"{time.perf_counter() - t0:.2f} s; mean MiB per file "
              f"{json.dumps(sizes)}", flush=True)

        # the core against its plain version, bitwise
        checks = 0
        for k, (short, flip) in enumerate(
                (s, f) for s in DECODER_SHORTS for f in (False, True)):
            for fmt, (_, _, paths) in splits.items():
                args = (short, 2048, 1024, 2048, True, flip)
                path = paths[k % len(paths)]
                got = core.load_resize_pad(path, *args)
                want = native.load_resize_pad_plain(path, *args)
                if got[1:] != want[1:] or not np.array_equal(got[0],
                                                              want[0]):
                    err = int(np.abs(got[0].astype(np.int32)
                                     - want[0].astype(np.int32)).max())
                    fail(f"the native core differs from its plain version "
                         f"on a {fmt} at short edge {short}, flip {flip}: "
                         f"{got[1:]} against {want[1:]}, max abs err {err}")
                checks += 1
        print(f"[decoder] the core bitwise equal to load_resize_pad_plain "
              f"in {checks} calls (short edges {DECODER_SHORTS}, flipped "
              f"and not, BGR, PNG and JPEG; max abs err 0)", flush=True)

        # one image per call, one thread, short edge 896: PIL's decode
        # alone, the core without its codecs, the loaders' branch
        per_call = {}
        for fmt, (_, _, paths) in splits.items():
            recs = [{"file_name": p, "image_id": i, "annotations": []}
                    for i, p in enumerate(paths)]
            row = {}
            for label, fn in (("decode", lambda r: native.decode_rgb(
                    r["file_name"])), ("core", core_only),
                    (f"loaders_{branch}", loaders)):
                times = []
                for r in recs:
                    t0 = time.perf_counter()
                    fn(r)
                    times.append((time.perf_counter() - t0) * 1e3)
                row[f"{label}_ms"] = median(times)
            per_call[fmt] = row
            print(f"[decoder] one {fmt} per call on one thread, median of "
                  f"{len(recs)} ms: PIL's decode alone "
                  f"{row['decode_ms']:.2f}; at short edge 896 the core "
                  f"{row['core_ms']:.2f}, apply_transform on the loaders' "
                  f"branch ({branch}) {row[f'loaders_{branch}_ms']:.2f}; "
                  f"card {card}", flush=True)
        numbers["per_call"] = per_call

        # images/s on a pool of 1 and 8 threads (no loader: each image its
        # own task), to tell the decode's own scaling from the loader's
        # batches in flight
        recs = [{"file_name": p, "image_id": i, "annotations": []}
                for i, p in enumerate(splits["png"][2] * 2)]
        pool_rates = {}
        for threads in (1, 8):
            for label, fn in (("core", core_only),
                              (f"loaders ({branch})", loaders)):
                with ThreadPoolExecutor(threads) as pool:
                    t0 = time.perf_counter()
                    list(pool.map(fn, recs))
                    rate = len(recs) / (time.perf_counter() - t0)
                pool_rates[f"{label}, {threads} threads"] = rate
        numbers["pool_images_per_s"] = pool_rates
        print(f"[decoder] short edge 896 on a thread pool, {len(recs)} "
              f"PNGs, images/s: {json.dumps(pool_rates)}; card {card}",
              flush=True)

        # the training loader at the published 24 + 24 on the PNG split
        # (Cityscapes' format), and the test loader, on the loaders' branch
        names = {}
        for fmt, (jpath, img_dir, _) in splits.items():
            names[fmt] = f"smoke_decoder_{fmt}"
            if names[fmt] not in DatasetCatalog:
                register_coco_instances(names[fmt], {}, jpath, img_dir)
        cfg = get_cfg()
        cfg.merge_from_file(FLAGSHIP)
        cfg.DATASETS.TRAIN = (names["png"],)
        cfg.DATASETS.UNLABELED = (names["png"],)
        cfg.DATASETS.TEST = (names["png"],)
        rates = {f"{branch}, {threads} threads": loader_images_per_s(
            cfg, threads, batches) for threads, batches in ((8, 3), (1, 2))}
        numbers["weak_strong_images_per_s"] = rates
        print(f"[decoder] WeakStrongLoader at 24 + 24 PNGs on the loaders' "
              f"branch ({branch}), TPU.PREFETCH {cfg.TPU.PREFETCH}, "
              f"images/s (from construction, 3 batches at 8 threads, 2 at "
              f"1): {json.dumps(rates)}; the trainer takes 48 images per "
              f"step (~0.8 s: 60 images/s); host CPU {host_cpu()}; card "
              f"{card}", flush=True)
        t0 = time.perf_counter()
        n = sum(len(m) for _, m in TestLoader(names["png"], cfg,
                                              (1024, 2048), batch_size=8))
        numbers["test_images_per_s"] = {branch: n / (time.perf_counter()
                                                     - t0)}
        print(f"[decoder] TestLoader (eval, one thread, MIN_SIZE_TEST "
              f"{cfg.INPUT.MIN_SIZE_TEST}: scale 1) on {DECODER_IMAGES} "
              f"PNGs, the loaders' branch, images/s: "
              f"{json.dumps(numbers['test_images_per_s'])}; card {card}",
              flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    numbers["phase_s"] = time.perf_counter() - t_phase
    print(f"[time] the decoder phase took {numbers['phase_s']:.1f} s",
          flush=True)
    print("[decoder] " + json.dumps(numbers), flush=True)
    return numbers


def write_synthetic_coco(root, name, n, seed, num_classes=8,
                         size=(1024, 2048), box_px=(16, 512)):
    """``n`` PNG images of ``size`` (h, w) with 5-30 boxes of ``box_px``
    sides of ``num_classes`` classes each (filled rectangles in class
    colors on a smooth gradient) and their COCO json under ``root/name``,
    written by 8 threads. Returns (json path, image dir)."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from PIL import Image

    h, w = size
    img_dir = os.path.join(root, name, "images")
    os.makedirs(img_dir, exist_ok=True)
    colors = np.random.default_rng(0).integers(40, 256, (num_classes, 3))
    ramp = (np.add.outer(np.arange(h) * 60 // h, np.arange(w) * 40 // w)
            .astype(np.uint8)[..., None])

    def one(i):
        rng = np.random.default_rng((seed, i))
        img = ramp + rng.integers(0, 60, 3).astype(np.uint8)
        anns = []
        for _ in range(int(rng.integers(5, 31))):
            bw, bh = (int(x) for x in rng.integers(box_px[0],
                                                   box_px[1] + 1, 2))
            x0, y0 = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
            c = int(rng.integers(0, num_classes))
            img[y0:y0 + bh, x0:x0 + bw] = colors[c]
            anns.append({"image_id": i + 1, "category_id": c + 1,
                         "bbox": [x0, y0, bw, bh], "area": bw * bh,
                         "iscrowd": 0})
        Image.fromarray(img).save(os.path.join(img_dir, f"{i:04d}.png"),
                                  compress_level=1)
        return anns

    with ThreadPoolExecutor(8) as pool:
        per_image = list(pool.map(one, range(n)))
    annotations = [dict(a, id=k + 1) for k, a in enumerate(
        a for anns in per_image for a in anns)]
    coco = {"images": [{"id": i + 1, "file_name": f"{i:04d}.png",
                        "height": h, "width": w} for i in range(n)],
            "annotations": annotations,
            "categories": [{"id": c + 1, "name": f"class{c}"}
                           for c in range(num_classes)]}
    path = os.path.join(root, name, "annotations.json")
    with open(path, "w") as f:
        json.dump(coco, f)
    return path, img_dir


def reference_pth(path, num_classes):
    """A reference ALDI ``.pth`` at ``path``: ``model`` and ``ema`` (keys
    prefixed ``model.``) under detectron2's names, the state dicts of the
    torch oracle's R50-FPN (``tests/torch_rcnn_oracle.py``) with weights
    from seeds 1 and 2, conditioned as ``conditioned_weights`` conditions
    them (the oracle's own ``randomize`` lets a random R50 reach losses in
    the hundreds, and its training diverges within three steps). Returns
    both state dicts."""
    import importlib.util

    import torch

    # by its path: a package named ``tests`` elsewhere on the path would
    # shadow the repository's directory
    spec = importlib.util.spec_from_file_location(
        "torch_rcnn_oracle", os.path.join(ROOT, "tests",
                                          "torch_rcnn_oracle.py"))
    oracle = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(oracle)
    model, ema = (conditioned_weights(oracle.build_r50_fpn_rcnn(
        num_classes).state_dict(), seed) for seed in (1, 2))
    torch.save({"model": model,
                "ema": {f"model.{k}": v for k, v in ema.items()},
                "iteration": 5000}, path)
    return model, ema


def equal_state(got, want):
    """Names of ``want``'s tensors that ``got`` (a state dict) lacks or
    holds with other values."""
    return [k for k, v in want.items()
            if k not in got or not torch_equal(got[k], v)]


def torch_equal(a, b):
    import torch

    return torch.equal(a.detach().cpu(), b.detach().cpu())


class TrainerProbe:
    """While active, watches the trainer that ``train_net.main`` builds:
    after ``resume_or_load``, checks its student and teacher against
    ``expect`` ({"student": state dict, "teacher": ..., "step": int}) and
    keeps the trainer; counts kernel launches inside evaluations apart
    from the rest (the steps); times each checkpoint save
    (synchronized); checks every box-head call of a training step for
    levels that are not contiguous (NHWC) before K2; and writes metrics
    every iteration (``WRITE_PERIOD`` 1), so that each iteration's
    ``images_per_sec`` and ``data_time`` are in ``metrics.json``. Each
    step runs inside a ``STEP_MARK`` range of torch.profiler, and the
    first step after ``reset(..., record=True)`` inside ``KernelLaunches``
    (its K1 and K2 launches in ``recorded``)."""

    def __init__(self, kernels):
        self.kernels = kernels
        self.head_calls, self.copies, self.in_step = 0, [], False
        self.recorded = None
        self.reset(None)

    def counts(self):
        return {k.name: k.launches for k in self.kernels}

    def reset(self, expect, record=False):
        """Launch counts to 0 and the checks of the next run's
        ``resume_or_load``; forgets the last trainer. With ``record``, the
        next step's K1 and K2 launches are recorded."""
        for k in self.kernels:
            k.launches = 0
        self.eval_launches = {k.name: 0 for k in self.kernels}
        self.eval_images_per_sec, self.save_s = [], []
        self.expect, self.trainer, self.record = expect, None, record

    def step_launches(self):
        """Launches since ``reset`` outside evaluations."""
        return {k: n - self.eval_launches[k]
                for k, n in self.counts().items()}

    def __enter__(self):
        import torch

        import aldi_tpu_torch.engine.trainer as tm
        from aldi_tpu_torch.engine.checkpoint import Checkpointer
        from aldi_tpu_torch.models.rcnn import RCNNDetector

        self.saved = (tm.WRITE_PERIOD, tm.inference_on_dataset,
                      tm.make_train_step, tm.ALDITrainer.resume_or_load,
                      Checkpointer.save, RCNNDetector.box_head)
        (_, infer, make_step, resume_or_load, save, box_head) = self.saved

        def probed_infer(*args, **kwargs):
            before = self.counts()
            out = infer(*args, **kwargs)
            for k, n in self.counts().items():
                self.eval_launches[k] += n - before[k]
            self.eval_images_per_sec.append(out["images_per_sec"])
            return out

        def probed_make_step(cfg, det):
            step = make_step(cfg, det)

            def probed_step(*args, **kwargs):
                self.in_step = True
                try:
                    if self.record:
                        self.record = False
                        with KernelLaunches(det) as self.recorded:
                            return step(*args, **kwargs)
                    with torch.profiler.record_function(STEP_MARK):
                        return step(*args, **kwargs)
                finally:
                    self.in_step = False
            return probed_step

        def probed_resume_or_load(trainer, resume=False):
            resume_or_load(trainer, resume)
            self.trainer = trainer
            if self.expect is not None:
                st = trainer.state
                bad = (equal_state(st.student.state_dict(),
                                   self.expect["student"])
                       + equal_state(st.teacher.state_dict(),
                                     self.expect["teacher"]))
                if bad or st.step != self.expect["step"]:
                    fail(f"after resume_or_load (resume={resume}) the "
                         f"trainer is at iteration {st.step}, not "
                         f"{self.expect['step']}, or holds other weights "
                         f"than expected: {bad[:5]}")

        def probed_save(ckpt, *args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = save(ckpt, *args, **kwargs)
            self.save_s.append(time.perf_counter() - t0)
            return out

        def probed_head(det, features, *args, **kwargs):
            if self.in_step:
                strided = [f for f in features[:-1] if not f.is_contiguous()]
                if strided:
                    self.copies.append((self.head_calls, len(strided),
                                        tuple(strided[0].shape),
                                        strided[0].stride()))
                self.head_calls += 1
            return box_head(det, features, *args, **kwargs)

        tm.WRITE_PERIOD = 1
        tm.inference_on_dataset = probed_infer
        tm.make_train_step = probed_make_step
        tm.ALDITrainer.resume_or_load = probed_resume_or_load
        Checkpointer.save = probed_save
        RCNNDetector.box_head = probed_head
        return self

    def __exit__(self, *exc):
        import aldi_tpu_torch.engine.trainer as tm
        from aldi_tpu_torch.engine.checkpoint import Checkpointer
        from aldi_tpu_torch.models.rcnn import RCNNDetector

        (tm.WRITE_PERIOD, tm.inference_on_dataset, tm.make_train_step,
         tm.ALDITrainer.resume_or_load, Checkpointer.save,
         RCNNDetector.box_head) = self.saved


STEP_MARK = "aldi trainer step"  # the probe's profiler range around a step


def trace_iterations(path):
    """The trainer's ``TPU.PROFILE_DIR`` trace (a Chrome trace of three
    iterations) read per iteration: each from the start of its step's
    ``STEP_MARK`` range to the next one's (the last to the trace's end),
    with the device's busy time in it (the union of kernel, copy and set
    intervals, clipped to the iteration) and the host's time inside CUDA
    runtime calls of 1 ms or more (the host waiting on the card), keyed by
    the call, the innermost operator around it and whether the step's
    thread or another one (the prefetcher's) made it. Returns
    ([(iteration ms, busy ms, {call: ms})], device events) or None when
    the trace holds no device events."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    span = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e)
            for e in events]
    device = sorted((a, b) for a, b, e in span
                    if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    marks = [(a, e.get("tid")) for a, _, e in span
             if e.get("cat") == "user_annotation"
             and e.get("name") == STEP_MARK]
    if not device or not marks:
        return None
    starts, step_tid = sorted(a for a, _ in marks), marks[0][1]
    ops = [(a, b, e) for a, b, e in span if e.get("cat") == "cpu_op"]

    def around(a, b, tid):
        inner = [(b2 - a2, e["name"]) for a2, b2, e in ops
                 if e.get("tid") == tid and a2 <= a and b <= b2]
        return min(inner)[1] if inner else "no operator"

    end = max(b for _, b, _ in span)
    out = []
    for lo, hi in zip(starts, starts[1:] + [end]):
        busy, last = 0.0, lo
        for a, b in device:
            a, b = max(a, last), min(b, hi)
            if b > a:
                busy += b - a
                last = b
        waits = {}
        for a, b, e in span:
            if (e.get("cat") == "cuda_runtime" and lo <= a < hi
                    and b - a >= 1e3):
                thread = ("step thread" if e.get("tid") == step_tid
                          else "other thread")
                key = f"{e['name']} in {around(a, b, e.get('tid'))} " \
                      f"({thread})"
                waits[key] = waits.get(key, 0.0) + (b - a) / 1e3
        out.append(((hi - lo) / 1e3, busy / 1e3, waits))
    return out, len(device)


TRAINER_KEYS = {
    "iteration", "total_loss", "num_pseudo_labels", "images_per_sec",
    "data_time", "dispatch_time", "loss_rpn_cls_source_strong",
    "loss_rpn_loc_source_strong", "loss_cls_source_strong",
    "loss_box_reg_source_strong", "loss_rpn_cls_distill",
    "loss_rpn_loc_distill", "loss_cls_distill", "loss_box_reg_distill",
    "loss_obj_bce_distill", "loss_rpn_l1_distill", "loss_cls_ce_distill",
    "loss_roih_l1_distill"}


def trainer_phase(card, kernels, then=None):
    """The flagship trained, checkpointed, resumed and evaluated through
    ``aldi_tpu_torch/tools/train_net.py`` ``main`` at the published
    SOLVER.IMS_PER_BATCH 48 (see the module docstring). ``then``, if
    given, is called with {"tmp", "names", "weights"} (the synthetic
    splits' directory and registered names, the reference ``.pth``) before
    they are deleted. Returns the launch counts of the first run's
    training steps and of its evaluation, and the first step's recorded K1
    and K2 launches (``KernelLaunches``)."""
    import gc
    import shutil
    import tempfile

    import torch

    import aldi_tpu_torch.engine.trainer as tm
    from aldi_tpu_torch.config import get_cfg
    from aldi_tpu_torch.data import native
    from aldi_tpu_torch.data.catalog import (DatasetCatalog,
                                             register_coco_instances)
    from aldi_tpu_torch.engine.checkpoint_convert import \
        reference_state_dict_to_port
    from aldi_tpu_torch.models import build_detector
    from aldi_tpu_torch.tools import train_net

    def release():
        gc.collect()
        torch.cuda.empty_cache()

    tmp = tempfile.mkdtemp(prefix="aldi_smoke_trainer_")
    try:
        t0 = time.perf_counter()
        names = {}
        for split, n, seed in (("train", 48, 1), ("unlabeled", 48, 2),
                               ("val", 16, 3)):
            names[split] = f"smoke_{split}"
            if names[split] not in DatasetCatalog:
                register_coco_instances(names[split], {}, *write_synthetic_coco(
                    tmp, names[split], n, seed))
        weights = os.path.join(tmp, "reference.pth")
        model_sd, ema_sd = reference_pth(weights, 8)
        cfg = get_cfg()
        cfg.merge_from_file(FLAGSHIP)
        target = build_detector(cfg, device="cpu").module.state_dict()
        from_ema = reference_state_dict_to_port(ema_sd, target)
        if not equal_state(from_ema, reference_state_dict_to_port(model_sd,
                                                                  target)):
            fail("the reference .pth's model and ema entries are equal")
        del model_sd, ema_sd, target
        print(f"[trainer] synthetic COCO splits (train 48, unlabeled 48, val "
              f"16 PNGs of 2048x1024, 8 classes, 5-30 boxes of 16-512 px) "
              f"and a reference .pth written in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)

        out = os.path.join(tmp, "out")

        def main(*flags, **over):
            opts = {"MODEL.WEIGHTS": weights,
                    "DATASETS.TRAIN": f"('{names['train']}',)",
                    "DATASETS.UNLABELED": f"('{names['unlabeled']}',)",
                    "DATASETS.TEST": f"('{names['val']}',)",
                    "SOLVER.MAX_ITER": 4, "SOLVER.CHECKPOINT_PERIOD": 2,
                    "TEST.EVAL_PERIOD": 4, "OUTPUT_DIR": out, **over}
            args = train_net.default_argument_parser().parse_args(
                ["--config-file", FLAGSHIP, *flags]
                + [str(x) for kv in opts.items() for x in kv])
            return train_net.main(args)

        def iterations():
            with open(os.path.join(out, "metrics.json")) as f:
                return [json.loads(line) for line in f]

        with TrainerProbe(kernels) as probe:
            # 1. from the reference .pth's EMA entry: 4 iterations, a
            # checkpoint at 2 and 4, an eval at 4; the smallest
            # TPU.GRAD_ACCUM that fits the card
            for accum in (1, 2, 3, 4, 6):
                shutil.rmtree(out, ignore_errors=True)
                probe.reset({"student": from_ema, "teacher": from_ema,
                             "step": 0}, record=True)
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                try:
                    results = main(**{"TPU.GRAD_ACCUM": accum})
                    break
                except torch.cuda.OutOfMemoryError as e:
                    print(f"[trainer] 24 + 24 images with TPU.GRAD_ACCUM "
                          f"{accum}: out of device memory ({e})", flush=True)
                    probe.trainer = None
                    release()
            else:
                fail("24 + 24 images do not fit the card at any "
                     "TPU.GRAD_ACCUM up to 6")
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 2**30
            peak_reserved = torch.cuda.max_memory_reserved() / 2**30
            launches, eval_launches = probe.step_launches(), dict(
                probe.eval_launches)
            lines = iterations()
            accum = probe.trainer.cfg.TPU.GRAD_ACCUM

            if [m["iteration"] for m in lines] != [1, 2, 3, 4]:
                fail(f"metrics.json holds iterations "
                     f"{[m['iteration'] for m in lines]}, not 1-4")
            for m in lines:
                if set(m) != TRAINER_KEYS:
                    fail(f"metrics.json keys differ from the JAX trainer's: "
                         f"{sorted(set(m) ^ TRAINER_KEYS)}")
                bad = [k for k, v in m.items() if not math.isfinite(v)]
                if bad:
                    fail(f"non-finite metrics at iteration "
                         f"{m['iteration']}: {bad}")
            for f in ("model_0000002.pth", "model_0000004.pth",
                      "last_checkpoint", "config.yaml"):
                if not os.path.exists(os.path.join(out, f)):
                    fail(f"the trainer wrote no {f}")
            ap50 = results.get(names["val"], {}).get("bbox/AP50")
            if ap50 is None or not math.isfinite(ap50):
                fail(f"the eval at iteration 4 gave no finite bbox/AP50: "
                     f"{results}")
            with open(os.path.join(out, "trainer_state.json")) as f:
                state_json = json.load(f)
            if state_json != {"best_ap50": {names["val"]: ap50}}:
                fail(f"trainer_state.json holds {state_json}, not the "
                     f"best-AP50 map")
            for k in kernels:
                if launches[k.name] == 0:
                    fail(f"the trainer's steps never launched {k.name}")
            if eval_launches["roi_align_fwd"] == 0:
                fail("the trainer's eval never launched roi_align_fwd")
            if probe.copies:
                fail(f"{len(probe.copies)} box-head calls of the trainer's "
                     f"steps copy pyramid levels before K2: {probe.copies}")
            per_it = [m["images_per_sec"] for m in lines]
            data_time = [m["data_time"] for m in lines]
            decoder = "%s (%s)" % native.decoder()
            print(f"[trainer] R50-FPN through train_net main, "
                  f"SOLVER.IMS_PER_BATCH 48 (24 labeled + 24 unlabeled "
                  f"images of 1024x2048, bfloat16), TPU.GRAD_ACCUM {accum}, "
                  f"from the reference .pth's EMA entry: 4 iterations in "
                  f"{wall:.2f} s (start, eval and checkpoints included); "
                  f"images/s per iteration {fmt(per_it)} (median of "
                  f"iterations 2-4 {median(per_it[1:]):.2f}); data_time s "
                  f"{fmt(data_time, 4)} (median {median(data_time):.4f}, "
                  f"host decoder {decoder}); dispatch_time s "
                  f"{fmt([m['dispatch_time'] for m in lines], 3)}; peak "
                  f"device memory {peak:.2f} GiB allocated, "
                  f"{peak_reserved:.2f} GiB reserved; eval of 16 images "
                  f"{probe.eval_images_per_sec[0]:.2f} images/s, bbox/AP50 "
                  f"{ap50:.4f}; checkpoint saves s {fmt(probe.save_s, 3)}; "
                  f"launches in the steps {launches}, in the eval "
                  f"{eval_launches}; {probe.head_calls} box-head calls of "
                  f"the steps checked, none copies a level; card {card}",
                  flush=True)
            print("[trainer] losses of iteration 4: " + json.dumps(
                {k: round(v, 5) for k, v in lines[-1].items()
                 if k.startswith(("loss", "total", "num"))}), flush=True)
            saved = torch.load(os.path.join(out, "model_0000004.pth"),
                               weights_only=True)
            del results
            probe.reset({"student": saved["model"], "teacher": {
                k[len("model."):]: v for k, v in saved["ema"].items()},
                "step": 4})
            del saved
            release()

            # 2. --resume to 6: goes on at 4 from the saved state
            main("--resume", **{"SOLVER.MAX_ITER": 6,
                                "TPU.GRAD_ACCUM": accum})
            lines = iterations()
            if [m["iteration"] for m in lines][-2:] != [5, 6] or \
                    not os.path.exists(os.path.join(out, "model_0000006.pth")):
                fail("the resumed run did not go on from 4 to 6")
            print(f"[trainer] --resume: went on at iteration 4 with the "
                  f"saved student, teacher and step and ended at 6 "
                  f"(model_0000006.pth); images/s "
                  f"{fmt([m['images_per_sec'] for m in lines[-2:]])}",
                  flush=True)
            probe.reset(None)
            release()

            # 3. --eval-only --resume: the teacher at iteration 6
            ap = main("--eval-only", "--resume",
                      **{"SOLVER.MAX_ITER": 6})[names["val"]]
            if not math.isfinite(ap["bbox/AP50"]):
                fail(f"--eval-only gave {ap}")
            print(f"[trainer] --eval-only --resume (the teacher at "
                  f"iteration 6): {json.dumps(ap)}", flush=True)
            probe.reset(None)
            release()

            # 4. --resume from 6 to 20 with TPU.PROFILE_DIR (iterations
            # 16-18 traced), the trainer's own WRITE_PERIOD, no eval. Rate
            # 0: the published rate takes these seeded weights to a NaN
            # loss within 20 iterations; the steps do the same work
            trace_dir = os.path.join(tmp, "trace")
            tm.WRITE_PERIOD = probe.saved[0]
            t0 = time.perf_counter()
            main("--resume", **{"SOLVER.MAX_ITER": 20,
                                "TPU.GRAD_ACCUM": accum,
                                "TEST.EVAL_PERIOD": 0,
                                "SOLVER.CHECKPOINT_PERIOD": 0,
                                "SOLVER.BASE_LR": 0.0,
                                "TPU.PROFILE_DIR": trace_dir})
            wall = time.perf_counter() - t0
            tm.WRITE_PERIOD = 1
            traced = trace_iterations(os.path.join(trace_dir, "trace.json"))
            if traced is None:
                print("[trainer] TPU.PROFILE_DIR trace at 24 + 24: device "
                      "busy share not measured (the trace holds no device "
                      "events)", flush=True)
            else:
                per_it, n_device = traced
                print(f"[trainer] TPU.PROFILE_DIR trace at 24 + 24 "
                      f"(--resume 6 -> 20 in {wall:.2f} s, iterations 16-18 "
                      f"traced, WRITE_PERIOD {probe.saved[0]}, "
                      f"{n_device} device events): " + "; ".join(
                          f"iteration {16 + i}: {ms:.2f} ms, device busy "
                          f"{busy:.2f} ms, idle share "
                          f"{max(0.0, 1 - busy / ms):.3f}, host in runtime "
                          f"calls >= 1 ms: " + (", ".join(
                              f"{k} {v:.2f} ms" for k, v in sorted(
                                  waits.items(), key=lambda kv: -kv[1]))
                              or "none")
                          for i, (ms, busy, waits) in enumerate(per_it))
                      + f"; card {card}", flush=True)
            probe.reset(None)
        release()
        if then is not None:
            then({"tmp": tmp, "names": names, "weights": weights})
            release()
        return launches, eval_launches, probe.recorded.launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ------------------------------------------- Fast R-CNN and the user tools
def synthetic_proposals(gen, boxes, valid, sizes, k):
    """[B, k, 4] float32 proposals per image, as a proposal file gives them
    after the loader's top-k: each valid gt box jittered 8 times (6 px),
    then random boxes of 16-512 px; clipped to the image, with their
    validity (non-empty after the clip)."""
    import torch

    b, g = valid.shape
    dev = boxes.device
    hw = sizes.to(torch.float32)
    wh = hw.flip(-1)[:, None]  # (w, h)
    xy = torch.rand((b, k, 2), generator=gen, device=dev) * wh * 0.9
    side = 16 + torch.rand((b, k, 2), generator=gen, device=dev) * 496
    props = torch.cat([xy, xy + side], -1)
    n_jit = min(8 * g, k) // g
    jit = (boxes[:, :, None] + torch.randn((b, g, n_jit, 4), generator=gen,
                                           device=dev) * 6.0
           ).reshape(b, g * n_jit, 4)
    use = valid[:, :, None].expand(b, g, n_jit).reshape(b, g * n_jit)
    props[:, :g * n_jit] = torch.where(use[..., None], jit,
                                       props[:, :g * n_jit])
    lim = torch.cat([wh, wh], -1)
    props = torch.minimum(props.clamp(min=0), lim)
    pvalid = ((props[..., 2] - props[..., 0] > 0.5)
              & (props[..., 3] - props[..., 1] > 0.5))
    return props.contiguous(), pvalid


def write_proposal_file(records, path, n, seed):
    """A detectron2 proposal pickle at ``path`` for ``records``: per image
    its gt boxes (objectness logit 4), each jittered 10 times by 2 px
    (logit 2 + noise) and random boxes (logit N(-1, 0.5)) up to ``n``
    proposals, as ``tests/test_proposals.py`` makes them."""
    import pickle

    import numpy as np

    rng = np.random.default_rng(seed)
    ids, boxes, logits = [], [], []
    for r in records:
        gt = np.array([a["bbox"] for a in r["annotations"]],
                      np.float32).reshape(-1, 4)
        gt[:, 2:] += gt[:, :2]
        jit = (np.repeat(gt, 10, 0)
               + rng.normal(0, 2.0, (10 * len(gt), 4))).astype(np.float32)
        m = n - len(gt) - len(jit)
        w, h = r["width"], r["height"]
        neg = np.stack([rng.uniform(0, w * 0.6, m),
                        rng.uniform(0, h * 0.6, m),
                        rng.uniform(w * 0.4, w, m),
                        rng.uniform(h * 0.4, h, m)], 1).astype(np.float32)
        ids.append(r["image_id"])
        boxes.append(np.concatenate([gt, jit, neg]))
        logits.append(np.concatenate([
            np.full(len(gt), 4.0, np.float32),
            2.0 + rng.normal(0, 0.1, len(jit)).astype(np.float32),
            rng.normal(-1, 0.5, m).astype(np.float32)]))
    with open(path, "wb") as f:
        pickle.dump({"ids": ids, "boxes": boxes, "objectness_logits": logits,
                     "bbox_mode": 0}, f)


def fast_rcnn_serving_phase(card, kernels):
    """Fast R-CNN inference (MODEL.LOAD_PROPOSALS) at full width: the
    R50-FPN of ``FAST_RCNN`` (8 classes, 1024x2048, bfloat16,
    ``seeded_weights``) through ``forward_inference(..., precomputed=)``
    on requests of 8 images with PRECOMPUTED_PROPOSAL_TOPK_TEST (1000)
    proposals each (``synthetic_proposals`` around 5-30 boxes per image):
    1 warm-up + 3 timed requests, outputs checked, K2's forward once per
    request and no other kernel, K2 held against its plain version at a
    request's own proposals, a traced request. Returns the timed requests'
    launch counts and K2's numbers."""
    import torch

    from aldi_tpu_torch.models import build_detector
    from aldi_tpu_torch.ops.roi_align import box_levels

    cfg = config_of(FAST_RCNN, FAST_RCNN_ON)
    name = model_name(cfg)
    det = build_detector(cfg)
    det.module.load_state_dict(seeded_weights(det, seed=0))
    k = cfg.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TEST
    gen = torch.Generator(device="cuda").manual_seed(5)
    requests = []
    for _ in range(1 + TIMED_REQUESTS):
        images, sizes = synthetic_request(gen, det.canvas)
        n_gt = torch.randint(5, 31, (BATCH,), generator=gen, device="cuda")
        gt, _, gt_valid = synthetic_gt(gen, BATCH, cfg.TPU.MAX_GT,
                                       (det.canvas[0] - 124,
                                        det.canvas[1] - 248), n_valid=n_gt)
        pboxes, pvalid = synthetic_proposals(gen, gt, gt_valid, sizes, k)
        requests.append((images, sizes, {"boxes": pboxes, "valid": pvalid}))

    def fn(images, sizes, pre):
        out = det.forward_inference(images, sizes, precomputed=pre)
        return dict(zip(("boxes", "scores", "classes", "valid"), out))

    fn(*requests[0])
    torch.cuda.synchronize()
    for kern in kernels:
        kern.launches = 0
    torch.cuda.reset_peak_memory_stats()
    latencies, n_det = [], 0
    for images, sizes, pre in requests[1:]:
        t0 = time.perf_counter()
        out = fn(images, sizes, pre)
        torch.cuda.synchronize()
        latencies.append((time.perf_counter() - t0) * 1e3)
        n_det += check_detections(out, sizes, det.num_classes,
                                  cfg.TEST.DETECTIONS_PER_IMAGE)
    launches = {kern.name: kern.launches for kern in kernels}
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = {kern.name: 0 for kern in kernels}
    want["roi_align_fwd"] = TIMED_REQUESTS
    if launches != want:
        fail(f"{name} serving: launches {launches}, expected {want}")
    if n_det == 0:
        fail(f"{name}: no valid detections in any request")
    med = median(latencies)
    print(f"[serving] {name} on precomputed proposals ({k} per image), "
          f"{TIMED_REQUESTS} requests of {BATCH} images: latency ms "
          f"{fmt(latencies)} (median {med:.2f}), "
          f"{BATCH * 1e3 / med:.2f} images/s at the median; {n_det} valid "
          f"detections; launches {launches}; peak device memory "
          f"{peak:.2f} GiB; card {card}", flush=True)
    images, sizes, pre = requests[-1]
    with torch.inference_mode():
        feats = det.backbone(det.preprocess(images))
    feats = [f.contiguous() for f in feats[:-1]]
    pboxes = pre["boxes"].float().contiguous()
    numbers = check_roi(f"{name} request, file proposals", feats, pboxes,
                        box_levels(pboxes, pre["valid"], det.roi_strides))
    del feats
    traced = device_busy(lambda: fn(images, sizes, pre))
    if traced is not None:
        busy, top, _, _, _ = traced
        print(f"[serving] {name}, traced request: device busy {busy:.2f} ms "
              f"of the {med:.2f} ms median request, idle share "
              f"{max(0.0, 1 - busy / med):.3f}; top kernels: "
              + "; ".join(f"{kn[:60]} {ms:.2f} ms x{n}" for kn, ms, n in top),
              flush=True)
    del det, requests, out
    torch.cuda.empty_cache()
    return launches, numbers


def fast_rcnn_trainer(card, kernels, data):
    """Fast R-CNN through ``train_net`` ``main`` (``FAST_RCNN`` with
    MODEL.LOAD_PROPOSALS) on the trainer phase's synthetic splits (``data``
    of ``trainer_phase``'s ``then``) with detectron2 proposal files of 2000
    proposals per image (``write_proposal_file``): SOLVER.IMS_PER_BATCH 8
    (cut from 48), 2 iterations from the reference ``.pth``, a checkpoint
    and an eval at 2. Checks: no RPN loss in ``metrics.json``, finite
    losses, a finite bbox/AP50, the eval's requests on the file's
    proposals (``precomputed`` in every ``forward_inference`` call), K2
    forward and backward in the steps, K2 forward in the eval, no K1.
    Returns the launch counts of the steps and of the eval."""
    import torch

    from aldi_tpu_torch.data.catalog import DatasetCatalog
    from aldi_tpu_torch.models.rcnn import RCNNDetector
    from aldi_tpu_torch.tools import train_net

    t0 = time.perf_counter()
    tmp, names = data["tmp"], data["names"]
    files = {}
    for split, seed in (("train", 7), ("val", 8)):
        files[split] = os.path.join(tmp, f"proposals_{split}.pkl")
        write_proposal_file(DatasetCatalog.get(names[split]), files[split],
                            2000, seed)
    out = os.path.join(tmp, "fast_rcnn")
    opts = {"MODEL.LOAD_PROPOSALS": True, "MODEL.WEIGHTS": data["weights"],
            "DATASETS.TRAIN": f"('{names['train']}',)",
            "DATASETS.TEST": f"('{names['val']}',)",
            "DATASETS.PROPOSAL_FILES_TRAIN": f"('{files['train']}',)",
            "DATASETS.PROPOSAL_FILES_TEST": f"('{files['val']}',)",
            "SOLVER.IMS_PER_BATCH": 8, "SOLVER.MAX_ITER": 2,
            "SOLVER.CHECKPOINT_PERIOD": 2, "TEST.EVAL_PERIOD": 2,
            "OUTPUT_DIR": out}
    args = train_net.default_argument_parser().parse_args(
        ["--config-file", FAST_RCNN]
        + [str(x) for kv in opts.items() for x in kv])
    calls = {"precomputed": 0, "rpn": 0}
    infer = RCNNDetector.forward_inference

    def counted(det, images, sizes, precomputed=None, **kwargs):
        calls["rpn" if precomputed is None else "precomputed"] += 1
        return infer(det, images, sizes, precomputed, **kwargs)

    RCNNDetector.forward_inference = counted
    try:
        with TrainerProbe(kernels) as probe:
            results = train_net.main(args)
            launches = probe.step_launches()
            eval_launches = dict(probe.eval_launches)
    finally:
        RCNNDetector.forward_inference = infer
    wall = time.perf_counter() - t0
    with open(os.path.join(out, "metrics.json")) as f:
        lines = [json.loads(line) for line in f]
    losses = [k for k in lines[-1] if k.startswith("loss")]
    if not losses or any("rpn" in k for k in losses):
        fail(f"Fast R-CNN trainer: losses {losses} (none of the RPN's "
             f"expected)")
    if not all(math.isfinite(m[k]) for m in lines for k in losses):
        fail("Fast R-CNN trainer: non-finite losses")
    ap = results.get(names["val"], {})
    if not math.isfinite(ap.get("bbox/AP50", float("nan"))):
        fail(f"Fast R-CNN trainer: no finite bbox/AP50: {results}")
    if calls["rpn"] or not calls["precomputed"]:
        fail(f"Fast R-CNN eval: forward_inference calls {calls}, all on the "
             f"file's proposals expected")
    if (launches["match_iou"] or launches["low_quality_mask"]
            or eval_launches["match_iou"] or not launches["roi_align_fwd"]
            or not launches["roi_align_bwd"]
            or not eval_launches["roi_align_fwd"]):
        fail(f"Fast R-CNN trainer: launches in the steps {launches}, in the "
             f"eval {eval_launches}")
    print(f"[trainer] Fast R-CNN through train_net main (MODEL.LOAD_PROPOSALS, "
          f"proposal files of 2000 per image, top "
          f"2000 / 1000 in training / eval; SOLVER.IMS_PER_BATCH 48 -> 8): "
          f"2 iterations and an eval of 16 images in {wall:.2f} s; images/s "
          f"per iteration {fmt([m['images_per_sec'] for m in lines])}; "
          f"losses of iteration 2 "
          + json.dumps({k: round(lines[-1][k], 5) for k in losses})
          + f"; eval {json.dumps({k: round(v, 4) for k, v in ap.items()})}, "
          f"{calls['precomputed']} requests on the file's proposals; "
          f"launches in the steps {launches}, in the eval {eval_launches}; "
          f"card {card}", flush=True)
    del results
    torch.cuda.empty_cache()
    return launches, eval_launches


def tools_phase(card, data):
    """The three user tools' ``main`` on the card (their default device) on
    the trainer phase's synthetic splits and reference ``.pth``
    (``data``): ``calibrate_threshold`` (the EMA teacher over the val
    split: a finite recommended threshold or the tool's none),
    ``debug_pipeline`` (SOLVER.IMS_PER_BATCH 8: the weak, strong and
    pseudo-labeled PNGs written) and ``visualize_featurespace`` (8 images
    of train and val, level p3: PCA coordinates finite, the plot or its
    .npy written)."""
    from aldi_tpu_torch.tools import (calibrate_threshold, debug_pipeline,
                                      visualize_featurespace)

    tmp, names, weights = data["tmp"], data["names"], data["weights"]
    datasets = ["DATASETS.TRAIN", f"('{names['train']}',)",
                "DATASETS.UNLABELED", f"('{names['unlabeled']}',)",
                "DATASETS.TEST", f"('{names['val']}',)"]
    t0 = time.perf_counter()
    report = calibrate_threshold.main(
        ["--config-file", FLAGSHIP, "--dataset", names["val"], "--out",
         os.path.join(tmp, "calibration.json"), "MODEL.WEIGHTS", weights,
         "OUTPUT_DIR", os.path.join(tmp, "calibrate"), *datasets])
    thr = report["recommended_threshold"]
    if thr is not None and not math.isfinite(thr):
        fail(f"calibrate_threshold: {report}")
    t1 = time.perf_counter()
    out = os.path.join(tmp, "debug")
    res = debug_pipeline.main(
        ["--config-file", FLAGSHIP, "--out", out, "MODEL.WEIGHTS", weights,
         "SOLVER.IMS_PER_BATCH", "8", *datasets])
    want = {f"{kind}_{i}.png" for kind in ("weak", "strong", "pseudo")
            for i in range(4)}
    if not want <= set(os.listdir(out)):
        fail(f"debug_pipeline wrote {sorted(os.listdir(out))}")
    t2 = time.perf_counter()
    plot = os.path.join(tmp, "featurespace.png")
    xy = visualize_featurespace.main(
        ["--config-file", FLAGSHIP, "--weights", weights, "--datasets",
         names["train"], names["val"], "--num-images", "8", "--level", "1",
         "--out", plot])
    import numpy as np

    if xy.shape != (16, 2) or not np.isfinite(xy).all() or not (
            os.path.exists(plot) or os.path.exists(plot + ".npy")):
        fail(f"visualize_featurespace: coordinates {xy.shape}, finite "
             f"{bool(np.isfinite(xy).all())}")
    t3 = time.perf_counter()
    print(f"[tools] calibrate_threshold (the EMA teacher over 16 images): "
          f"{t1 - t0:.2f} s, {report['detections']} detections, score "
          f"percentiles {report['score_percentiles']}, recommended "
          f"threshold {thr}; debug_pipeline (4 + 4 images): {t2 - t1:.2f} s, "
          f"{len(want)} PNGs, pseudo-labels per image "
          f"{res['metrics']['num_pseudo_labels']:.2f}; "
          f"visualize_featurespace (8 + 8 images, p3): {t3 - t2:.2f} s, "
          f"wrote {'the plot' if os.path.exists(plot) else 'the .npy'}; "
          f"card {card}", flush=True)


# ---------------------------------------------------------------- YOLOv5
# ---------------------------------------------------------------- data parallel
DP_WORLD = 2  # ranks of the world-2 checks, two processes on this one card
DP_TIMEOUT_S = 420  # a group that has not finished by then fails the run
# world 2 (float32, TF32 off, two processes) against world 1: the ranks'
# partial sums and the convolutions over 2 images instead of 4 sum in
# another order; the second step's sampled ROIs and matches move with
# those last bits. Sound readings, NVIDIA H100 80GB HBM3 at 700 W, in four
# runs: R50-FPN's worst summed loss 2.26e-4 relative at step 1 and
# 7.8e-4-1.41e-3 at step 2, its parameters 3.5e-5-4.2e-5 after 2 steps,
# while world 1's student moves by up to 1.14e-3 and 1.49e-3 per step;
# YOLOv5-m's losses 1.21e-4, parameters 1.19e-7, running statistics
# 6.34e-7 of their scale. ``DP_FAULTS`` are planted in the same run, and
# each must exceed its limit.
DP_LOSS_RTOL = 5e-3
DP_PARAM_ATOL = 1e-4
DP_STATS_RTOL = 1e-3  # YOLO's running statistics, of each tensor's scale
DP_MOVE_FACTOR = 10  # world 1's largest move per step >= this x DP_PARAM_ATOL
# fault planted at world 2 -> the limit that must catch it
DP_FAULTS = {"averaged gradients": "parameters",
             "rank-local denominators": "losses"}
DP_FLOAT32 = {"TPU.COMPUTE_DTYPE": "float32"}
DP_YOLO = {"DOMAIN_ADAPT.TEACHER.THRESHOLD": 0.0}  # as the YOLO phase


def dp_spawn(fn, args, world=DP_WORLD):
    """``fn(rank, world, *args)`` in ``world`` processes that share this
    card (``mesh.spawn``), joined in a gloo group (NCCL refuses two ranks
    on one device): their results in rank order. A rank that fails, or a
    group not done within ``DP_TIMEOUT_S``, fails the run; every process
    is stopped."""
    import tempfile

    from aldi_tpu_torch.parallel import mesh

    with tempfile.TemporaryDirectory(prefix="aldi_smoke_dp_") as tmp:
        try:
            return mesh.spawn(fn, world, f"file://{tmp}/store", *args,
                              device_type="cuda", backend="gloo",
                              timeout=DP_TIMEOUT_S)
        except (RuntimeError, TimeoutError) as e:
            fail(f"data parallel: {fn.__name__}: {e}")


class dp_fault:
    """A fault of ``DP_FAULTS`` planted in this rank's step while in the
    block, to show that the world-2 limits catch it: "averaged gradients"
    divides the summed gradients by W (what averaging, DDP's rule, would
    do to losses that already carry the global denominators), "rank-local
    denominators" gives every R-CNN loss its rank's own count."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        from aldi_tpu_torch.engine import distill, train_step
        from aldi_tpu_torch.models import roi_heads, rpn
        from aldi_tpu_torch.parallel import mesh

        def averaged(params):
            nbytes = mesh.all_reduce_grads(params)
            for p in params:
                if p.grad is not None:
                    p.grad.div_(mesh.world())
            return nbytes

        if self.name == "averaged gradients":
            self.patches = [(train_step, "all_reduce_grads", averaged)]
        else:
            self.patches = [(roi_heads, "global_count", lambda x: x),
                            (distill, "global_count", lambda x: x),
                            (rpn, "global_batch", lambda n: n)]
        self.saved = [(m, k, getattr(m, k)) for m, k, _ in self.patches]
        for m, k, f in self.patches:
            setattr(m, k, f)
        return self

    def __exit__(self, *exc):
        for m, k, f in self.saved:
            setattr(m, k, f)


def dp_steps(rank, world, config, overrides, n_steps, seed,
             keep_teacher=True):
    """``n_steps`` DAOD steps of ``config`` at full width on a rank's share
    (``shard_batch``, ``shard_draws``) of global batches of TRAIN_IMAGES +
    TRAIN_IMAGES images and their draws, made on the card from ``seed`` on
    every rank alike; ``seeded_weights``; TF32 off for cuDNN and matrix
    products, so that float32 differs between world sizes only by the
    order of its sums (TF32 convolution algorithms chosen by batch size
    round differently). Returns per step the rank's metrics, the steps' ms
    and the student's largest move (``moves``: of any parameter element),
    the kernels' launches in the ``n_steps`` steps, and the student's and
    (with ``keep_teacher``) the teacher's state dicts on the CPU."""
    import torch

    from aldi_tpu_torch.engine.train_step import (create_train_state,
                                                  draw_step, make_train_step)
    from aldi_tpu_torch.models import build_detector
    from aldi_tpu_torch.ops.match_kernel import low_quality_mask, match_iou
    from aldi_tpu_torch.ops.roi_align_kernel import (roi_align_bwd,
                                                     roi_align_fwd)
    from aldi_tpu_torch.parallel.mesh import shard_batch, shard_draws

    cfg = config_of(config, overrides)
    cfg.SOLVER.IMS_PER_BATCH = 2 * TRAIN_IMAGES
    det = build_detector(cfg)
    state = create_train_state(cfg, det, seeded_weights(det, seed=0))
    step = make_train_step(cfg, det)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    batches = [synthetic_train_batch(gen, det.canvas, cfg.TPU.MAX_GT,
                                     det.num_classes, TRAIN_IMAGES)
               for _ in range(n_steps)]
    if cfg.MODEL.LOAD_PROPOSALS:
        for b in batches:
            lab = b["labeled"]
            lab["pboxes"], lab["pvalid"] = synthetic_proposals(
                gen, lab["boxes"], lab["valid"], lab["sizes"],
                cfg.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TRAIN)
    draws = [draw_step(gen, det, TRAIN_IMAGES, TRAIN_IMAGES)
             for _ in range(n_steps)]
    kernels = (match_iou, low_quality_mask, roi_align_fwd, roi_align_bwd)
    for k in kernels:
        k.launches = 0
    metrics, times, moves = [], [], []
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        for b, d in zip(batches, draws):
            before = params_of(state.student)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, shard_batch(b, 1, rank, world),
                            shard_draws(d, 1, rank, world))
            metrics.append({k: float(v) for k, v in m.items()})
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            after = dict(state.student.named_parameters())
            moves.append(float(torch.stack([
                (after[k].detach() - v).abs().max()
                for k, v in before.items()]).max()))
            del before, after
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    out = {"metrics": metrics, "ms": times, "moves": moves,
           "launches": {k.name: k.launches for k in kernels},
           "student": {k: v.detach().cpu()
                       for k, v in state.student.state_dict().items()}}
    if keep_teacher:
        out["teacher"] = {k: v.detach().cpu()
                          for k, v in state.teacher.state_dict().items()}
    return out


def dp_steps_of_both(rank, world, n_steps):
    """The flagship's 2 steps and YOLOv5-m's 1 step, float32, as
    ``dp_steps``, then the flagship's steps again under each of
    ``DP_FAULTS`` (one process start for all)."""
    r50 = dp_steps(rank, world, FLAGSHIP, DP_FLOAT32, n_steps, 31)
    yolo = dp_steps(rank, world, YOLO_ALDI, {**DP_FLOAT32, **DP_YOLO}, 1, 32)
    faults = {}
    for name in DP_FAULTS:
        with dp_fault(name):
            faults[name] = dp_steps(rank, world, FLAGSHIP, DP_FLOAT32,
                                    n_steps, 31, keep_teacher=False)
    return r50, yolo, faults


def dp_errors(label, ranks, want):
    """The ranks' summed metrics against world 1's (``want``), each step's
    worst printed, and rank 0's student against world 1's: (the worst
    relative loss error, the parameters' and the running statistics'
    worst errors, the summed metrics)."""
    got = [{k: sum(r["metrics"][i][k] for r in ranks)
            for k in ranks[0]["metrics"][i]}
           for i in range(len(want["metrics"]))]
    errs = {(i + 1, k): abs(g[k] - w[k]) / max(abs(w[k]), 1e-3)
            for i, (g, w) in enumerate(zip(got, want["metrics"])) for k in w}
    loss_err = max(errs.values())
    for i in range(len(got)):
        worst = max((e, k) for (j, k), e in errs.items() if j == i + 1)[1]
        print(f"[dp] {label}: the worst summed loss of step {i + 1}, "
              f"{worst}: {got[i][worst]:.7g} against world 1's "
              f"{want['metrics'][i][worst]:.7g} (relative "
              f"{errs[(i + 1, worst)]:.3g})", flush=True)
    s, w = ranks[0]["student"], want["student"]
    stats = [k for k in w if k.endswith(("running_mean", "running_var"))]
    params = [k for k in w if k not in stats and w[k].is_floating_point()]
    param_err = max(float((s[k] - w[k]).abs().max()) for k in params)
    stats_err = max((float((s[k] - w[k]).abs().max())
                     / max(float(w[k].abs().max()), 1e-12)
                     for k in stats), default=0.0)
    return loss_err, param_err, stats_err, got


def dp_compare(label, ranks, want, per_step=None):
    """The ranks' summed metrics and rank 0's student and teacher against
    world 1's (``want``), the two ranks' states bitwise equal, and each
    rank's kernel launches per step (``per_step``) in its steps. Returns
    the worst errors and the summed metrics."""
    import torch

    loss_err, param_err, stats_err, got = dp_errors(label, ranks, want)
    for part in ("student", "teacher"):
        a, b = ranks[0][part], ranks[1][part]
        if not all(torch.equal(a[k], b[k]) for k in a):
            fail(f"data parallel {label}: the ranks' {part}s differ")
    steps = len(want["metrics"])
    for r, out in enumerate(ranks):
        for name, n in (per_step or {}).items():
            if out["launches"][name] != n * steps:
                fail(f"data parallel {label}: rank {r} launched {name} "
                     f"{out['launches'][name]} times in {steps} steps, "
                     f"{n} per step expected")
    return loss_err, param_err, stats_err, got


def dp_world1_group(card):
    """The flagship's DAOD step (4 + 4, bf16) without a group and with a
    world-1 NCCL group: bitwise equal losses and parameters, both timed,
    and the gradient all-reduce on that group timed with its bytes."""
    import socket

    import torch

    from aldi_tpu_torch.engine.train_step import (create_train_state,
                                                  draw_step, make_train_step)
    from aldi_tpu_torch.models import build_detector
    from aldi_tpu_torch.parallel import mesh

    cfg = config_of(FLAGSHIP)
    cfg.SOLVER.IMS_PER_BATCH = 2 * TRAIN_IMAGES
    det = build_detector(cfg)
    weights = seeded_weights(det, seed=0)
    gen = torch.Generator(device="cuda").manual_seed(30)
    n = 3  # a warm-up and 2 timed steps
    batches = [synthetic_train_batch(gen, det.canvas, cfg.TPU.MAX_GT,
                                     det.num_classes, TRAIN_IMAGES)
               for _ in range(n)]
    draws = [draw_step(gen, det, TRAIN_IMAGES, TRAIN_IMAGES)
             for _ in range(n)]

    def run():
        state = create_train_state(cfg, det, weights)
        step = make_train_step(cfg, det)
        metrics, times = [], []
        for b, d in zip(batches, draws):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, b, d)
            metrics.append({k: v.detach().clone() for k, v in m.items()})
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return state, metrics, params_of(state.student), times[1:]

    _, plain_m, plain_p, plain_ms = run()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mesh.init_process_group("cuda", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        state, group_m, group_p, group_ms = run()
        same = (all(torch.equal(a[k], b[k]) for a, b in zip(plain_m, group_m)
                    for k in a)
                and all(torch.equal(plain_p[k], group_p[k])
                        for k in plain_p))
        params = [p for g in state.optimizer.param_groups
                  for p in g["params"]]
        buckets = mesh.grad_buckets(params)
        nbytes = mesh.reduce_buckets(buckets)
        reduce_ms = cuda_ms(lambda: mesh.reduce_buckets(buckets), 10)
        backend = torch.distributed.get_backend()
    finally:
        torch.distributed.destroy_process_group()
    print(f"[dp] R50-FPN DAOD step (4 + 4, bf16) with a world-1 {backend} "
          f"group against no group: losses and parameters after {n} steps "
          f"bitwise equal: {same}; step ms without {fmt(plain_ms)}, with "
          f"{fmt(group_ms)}; the gradient all-reduce (skipped at world 1: "
          f"timed here on the group) {nbytes / 2**20:.2f} MiB in "
          f"{len(buckets)} buckets, {reduce_ms:.4f} ms per step; card "
          f"{card}", flush=True)
    if not same:
        fail("the step with a world-1 group differs from the step without")
    del state
    return {"plain_ms": plain_ms, "group_ms": group_ms,
            "reduce_ms": reduce_ms, "reduce_bytes": nbytes}


def dp_trainer(rank, world, tmp, names, paths, weights):
    """``ALDITrainer`` on this rank's share: the flagship for 2 iterations
    of 4 + 4 images (bf16) with a checkpoint and an eval of the val split
    at 2, on the card this process shares with the other rank."""
    from aldi_tpu_torch.data.catalog import (DatasetCatalog,
                                             register_coco_instances)
    from aldi_tpu_torch.engine.trainer import ALDITrainer

    for name, (json_path, image_dir) in zip(names, paths):
        if name not in DatasetCatalog:
            register_coco_instances(name, {}, json_path, image_dir)
    trainer = ALDITrainer(dp_trainer_cfg(tmp, names, weights),
                          device="cuda:0")
    trainer.resume_or_load(resume=False)
    return trainer.train()


def dp_oracle_val(tmp, names, paths, weights):
    """The val split's boxes rewritten as the reference weights' own
    detections above 0.5 (their ``ema`` entry, bf16, on the card): the
    trainer's eval of its EMA teacher, which 2 iterations at EMA.ALPHA
    0.9996 leave near those weights, then scores an AP far above 0, which
    a lost or doubled image of the gather would change."""
    import torch

    from aldi_tpu_torch.data.catalog import (DatasetCatalog,
                                             register_coco_instances)
    from aldi_tpu_torch.data.loader import TestLoader
    from aldi_tpu_torch.engine.checkpoint import load_reference_weights
    from aldi_tpu_torch.engine.train_step import create_train_state
    from aldi_tpu_torch.models import build_detector

    for name, (json_path, image_dir) in zip(names, paths):
        if name not in DatasetCatalog:
            register_coco_instances(name, {}, json_path, image_dir)
    cfg = dp_trainer_cfg(tmp, names, weights)
    det = build_detector(cfg)
    load_reference_weights(create_train_state(cfg, det), weights)
    json_path = paths[2][0]
    with open(json_path) as f:
        coco = json.load(f)
    coco["annotations"] = []
    for batch, metas in TestLoader(names[2], cfg, det.canvas):
        out = det.forward_inference(torch.from_numpy(batch["image"]).cuda(),
                                    torch.from_numpy(batch["sizes"]).cuda())
        boxes, scores, classes, valid = (t.cpu() for t in out)
        for i, meta in enumerate(metas):
            keep = valid[i] & (scores[i] > 0.5)
            for b, c in zip(boxes[i][keep], classes[i][keep]):
                x0, y0, x1, y1 = (b.float() / meta["scale"]).tolist()
                coco["annotations"].append({
                    "id": len(coco["annotations"]) + 1,
                    "image_id": meta["image_id"], "category_id": int(c) + 1,
                    "bbox": [x0, y0, x1 - x0, y1 - y0],
                    "area": (x1 - x0) * (y1 - y0), "iscrowd": 0})
    with open(json_path, "w") as f:
        json.dump(coco, f)
    del det
    torch.cuda.empty_cache()
    return len(coco["annotations"])


def dp_trainer_cfg(tmp, names, weights):
    return config_of(FLAGSHIP, {
        "MODEL.WEIGHTS": weights, "DATASETS.TRAIN": (names[0],),
        "DATASETS.UNLABELED": (names[1],), "DATASETS.TEST": (names[2],),
        "SOLVER.IMS_PER_BATCH": 2 * TRAIN_IMAGES, "SOLVER.MAX_ITER": 2,
        "SOLVER.CHECKPOINT_PERIOD": 2, "TEST.EVAL_PERIOD": 2,
        "OUTPUT_DIR": os.path.join(tmp, "out")})


def dp_peak(fn):
    """``fn()``'s result, its ms and the device memory it took at its peak
    above what was allocated before it (MiB)."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return out, ms, (torch.cuda.max_memory_allocated() - base) / 2**20


class DropoutDraws:
    """Counts DETR's dropout calls and the float32 values they draw (the
    whole chunk's rows under data parallelism) while in the block."""

    def __enter__(self):
        from aldi_tpu_torch.models import detr

        self.calls = self.values = 0
        self.cls, self.saved = detr._Dropout, detr._Dropout.__call__
        counts = self

        def call(drop, x, split=(0, 1)):
            if drop.gen is not None:
                counts.calls += 1
                counts.values += drop.world * split[1] * x.numel()
            return counts.saved(drop, x, split)

        self.cls.__call__ = call
        return self

    def __exit__(self, *exc):
        self.cls.__call__ = self.saved


def dp_draw_cost(card):
    """What every rank's draws of the whole global batch cost at world 2
    (``shard_draws``), against the same rank's images drawn alone (the
    cost of a per-rank draw, which would not give world 1's bits), on this
    card: R50-FPN's ``draw_step`` at the published SOLVER.IMS_PER_BATCH 48
    (24 + 24, a rank's 12 + 12), and Deformable DETR's DAOD step on rank
    0's 8 + 8 of the published 16 + 16 chunk, whose dropout masks are drawn
    for the chunk's 16 rows inside the step. Time and peak memory above
    the allocation before; prints them."""
    import torch

    from aldi_tpu_torch.engine.train_step import (create_train_state,
                                                  draw_step, make_train_step)
    from aldi_tpu_torch.models import build_detector
    from aldi_tpu_torch.parallel.mesh import shard_batch, shard_draws

    cfg = config_of(FLAGSHIP)
    det = build_detector(cfg)
    gen = torch.Generator(device="cuda").manual_seed(33)
    n = cfg.SOLVER.IMS_PER_BATCH // 2
    variants = {
        "world 2": lambda: shard_draws(draw_step(gen, det, n, n), 1, 0,
                                       DP_WORLD),
        "alone": lambda: draw_step(gen, det, n // DP_WORLD, n // DP_WORLD)}
    r50 = {k: [] for k in variants}
    for _ in range(3):
        for name, fn in variants.items():
            r50[name].append(dp_peak(fn)[1:])
    print(f"[dp] R50-FPN draw_step at the published global {n} + {n}, rank "
          f"0 of {DP_WORLD}: the global draws and the rank's share, ms "
          f"{fmt([t for t, _ in r50['world 2']])}, peak "
          f"{r50['world 2'][-1][1]:.1f} MiB; the rank's {n // DP_WORLD} + "
          f"{n // DP_WORLD} drawn alone, ms "
          f"{fmt([t for t, _ in r50['alone']])}, peak "
          f"{r50['alone'][-1][1]:.1f} MiB; card {card}", flush=True)
    del det

    c = DETR_PUBLISHED_CHUNK
    cfg = detr_config()
    cfg.SOLVER.IMS_PER_BATCH = 2 * c
    cfg.DOMAIN_ADAPT.TEACHER.THRESHOLD = 0.0  # as the DETR phase
    det = build_detector(cfg)
    state = create_train_state(cfg, det, seeded_weights(det, seed=0))
    step = make_train_step(cfg, det)
    gen = torch.Generator(device="cuda").manual_seed(34)
    batch = shard_batch(synthetic_train_batch(
        gen, det.canvas, cfg.TPU.MAX_GT, det.num_classes, c), 1, 0, DP_WORLD)
    variants = {
        "world 2": lambda: shard_draws(draw_step(gen, det, c, c), 1, 0,
                                       DP_WORLD),
        "alone": lambda: draw_step(gen, det, c // DP_WORLD, c // DP_WORLD)}
    detr = {k: [] for k in variants}
    state, _ = step(state, batch, variants["alone"]())  # warm-up
    for _ in range(2):
        for name, fn in variants.items():
            with DropoutDraws() as drawn:
                (state, _), ms, peak = dp_peak(
                    lambda: step(state, batch, fn()))
            detr[name].append((ms, peak, drawn.calls, drawn.values))
    w2, alone = detr["world 2"][-1], detr["alone"][-1]
    print(f"[dp] Deformable DETR DAOD step on rank 0's {c // DP_WORLD} + "
          f"{c // DP_WORLD} of the published {c} + {c} chunk (float32): with "
          f"the global draws (dropout masks of the chunk's rows), ms "
          f"{fmt([r[0] for r in detr['world 2']])}, peak {w2[1]:.1f} MiB, "
          f"{w2[2]} dropout calls drawing {w2[3] * 4 / 2**30:.2f} GiB of "
          f"float32; the rank's rows drawn alone, ms "
          f"{fmt([r[0] for r in detr['alone']])}, peak {alone[1]:.1f} MiB, "
          f"{alone[2]} calls drawing {alone[3] * 4 / 2**30:.2f} GiB; card "
          f"{card}", flush=True)
    del state, step, det, batch


def dp_phase(card):
    """Data-parallel training (``aldi_tpu_torch/parallel/mesh.py``; see the
    module docstring). Returns each world-2 rank's kernel launches in its
    R50-FPN steps and the numbers of the world-1 group check."""
    import shutil
    import tempfile

    import torch

    from aldi_tpu_torch.engine.trainer import ALDITrainer

    t_phase = time.perf_counter()
    numbers = dp_world1_group(card)
    torch.cuda.empty_cache()
    dp_draw_cost(card)
    torch.cuda.empty_cache()

    # b. world 2 on this card against world 1, float32
    per_step = {"match_iou": 3, "low_quality_mask": 3, "roi_align_fwd": 4,
                "roi_align_bwd": 2}
    n = 2
    t0 = time.perf_counter()
    ranks = dp_spawn(dp_steps_of_both, (n,))
    world2_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    r50_want = dp_steps(0, 1, FLAGSHIP, DP_FLOAT32, n, 31)
    yolo_want = dp_steps(0, 1, YOLO_ALDI, {**DP_FLOAT32, **DP_YOLO}, 1, 32)
    torch.cuda.empty_cache()
    loss_err, param_err, _, got = dp_compare(
        "R50-FPN", [r[0] for r in ranks], r50_want, per_step)
    shares = [r[0]["metrics"][0]["num_pseudo_labels"] for r in ranks]
    print(f"[dp] R50-FPN DAOD step, float32, world 2 (two gloo ranks on one "
          f"card, {TRAIN_IMAGES // DP_WORLD} + {TRAIN_IMAGES // DP_WORLD} "
          f"images each of a global {TRAIN_IMAGES} + {TRAIN_IMAGES}) against "
          f"world 1, {n} steps: summed losses worst relative error "
          f"{loss_err:.3g} (tol {DP_LOSS_RTOL}), parameters max abs err "
          f"{param_err:.3g} (tol {DP_PARAM_ATOL}); the ranks' parameters "
          f"bitwise equal; num_pseudo_labels shares {shares}; launches in "
          f"the {n} steps of each rank {[r[0]['launches'] for r in ranks]}; "
          f"rank 0's "
          f"step ms {fmt(ranks[0][0]['ms'])} (two processes on one card: a "
          f"correctness check, not a multi-GPU speed); world 1's "
          f"{fmt(r50_want['ms'])}; the two ranks took {world2_s:.1f} s with "
          f"their start; card {card}", flush=True)
    print("[dp] R50-FPN world-2 summed losses of the last step: " + json.dumps(
        {k: round(v, 5) for k, v in got[-1].items()}), flush=True)
    if loss_err > DP_LOSS_RTOL or param_err > DP_PARAM_ATOL:
        fail("data parallel: R50-FPN at world 2 differs from world 1")
    moves = r50_want["moves"]
    print(f"[dp] R50-FPN world 1, float32: the student's largest move per "
          f"step {', '.join(f'{m:.3g}' for m in moves)} (at least {DP_MOVE_FACTOR} x "
          f"DP_PARAM_ATOL = {DP_MOVE_FACTOR * DP_PARAM_ATOL:.3g} required); "
          f"card {card}", flush=True)
    if min(moves) < DP_MOVE_FACTOR * DP_PARAM_ATOL:
        fail("data parallel: the parameters move too little per step for "
             "DP_PARAM_ATOL to tell a wrong step from a right one")
    for name, limit in DP_FAULTS.items():
        f_loss, f_param, _, _ = dp_errors(
            f"R50-FPN, {name} planted", [r[2][name] for r in ranks],
            r50_want)
        print(f"[dp] R50-FPN at world 2 with {name} planted: summed losses "
              f"worst relative error {f_loss:.3g} (tol {DP_LOSS_RTOL}), "
              f"parameters max abs err {f_param:.3g} (tol {DP_PARAM_ATOL}); "
              f"the {limit} limit must catch it; card {card}", flush=True)
        caught = (f_loss > DP_LOSS_RTOL if limit == "losses"
                  else f_param > DP_PARAM_ATOL)
        if not caught:
            fail(f"data parallel: the {limit} limit does not catch {name}")
    loss_err, param_err, stats_err, _ = dp_compare(
        "YOLOv5-m", [r[1] for r in ranks], yolo_want)
    print(f"[dp] YOLOv5-m DAOD step, float32, world 2 against world 1: "
          f"summed losses worst relative error {loss_err:.3g} (tol "
          f"{DP_LOSS_RTOL}), parameters max abs err {param_err:.3g} (tol "
          f"{DP_PARAM_ATOL}), BatchNorm running statistics max err / scale "
          f"{stats_err:.3g} (tol {DP_STATS_RTOL}); the ranks' parameters and "
          f"running statistics bitwise equal; card {card}", flush=True)
    if (loss_err > DP_LOSS_RTOL or param_err > DP_PARAM_ATOL
            or stats_err > DP_STATS_RTOL):
        fail("data parallel: YOLOv5-m at world 2 differs from world 1")
    launches = [r[0]["launches"] for r in ranks]
    del ranks, r50_want, yolo_want

    # c. the trainer at world 2, then world 1's eval of its checkpoint
    tmp = tempfile.mkdtemp(prefix="aldi_smoke_dp_trainer_")
    try:
        names = ("smoke_dp_train", "smoke_dp_unlabeled", "smoke_dp_val")
        paths = [write_synthetic_coco(tmp, name, k, seed)
                 for name, k, seed in zip(names, (8, 8, 16), (4, 5, 6))]
        weights = os.path.join(tmp, "reference.pth")
        reference_pth(weights, 8)
        n_boxes = dp_oracle_val(tmp, names, paths, weights)
        t0 = time.perf_counter()
        results = dp_spawn(dp_trainer, (tmp, names, paths, weights))
        trainer_s = time.perf_counter() - t0
        out = os.path.join(tmp, "out")
        files = sorted(os.listdir(out))
        want_files = sorted(["last_checkpoint", "log.txt", "metrics.json",
                             "model_0000002.pth", "tensorboard",
                             "trainer_state.json",
                             f"{names[2]}_model_best.pth"])
        with open(os.path.join(out, "metrics.json")) as f:
            lines = f.read().splitlines()
        trainer = ALDITrainer(dp_trainer_cfg(tmp, names, weights))
        trainer.resume_or_load(resume=True)
        if trainer.state.step != 2:
            fail("data parallel: the world-2 checkpoint did not resume at 2")
        want = trainer.test()[names[2]]
        del trainer
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    got = [r[names[2]] for r in results]
    print(f"[dp] ALDITrainer at world 2 (two gloo ranks on one card, 2 + 2 "
          f"images each, 2 iterations, a checkpoint and an eval of 16 images "
          f"at 2, its {n_boxes} boxes the reference weights' own detections "
          f"above 0.5) in {trainer_s:.1f} s with the ranks' start: files "
          f"{files}, metrics.json lines {len(lines)}; bbox/AP50 of the ranks "
          f"{[g['bbox/AP50'] for g in got]}, world 1's on the saved weights "
          f"{want['bbox/AP50']}; bbox/AP {[g['bbox/AP'] for g in got]} vs "
          f"{want['bbox/AP']}; card {card}", flush=True)
    if files != want_files or len(lines) != 1:
        fail(f"data parallel: the world-2 trainer wrote {files} and "
             f"{len(lines)} metrics lines, not {want_files} and 1 (rank 0 "
             f"alone)")
    if not want["bbox/AP50"] > 10:
        fail(f"data parallel: the eval's bbox/AP50 {want['bbox/AP50']} is "
             "too low to hold the gather to")
    for g in got:
        for k in ("bbox/AP", "bbox/AP50", "bbox/AP75"):
            if g[k] != want[k]:
                fail(f"data parallel: world 2's {k} {g[k]} is not world 1's "
                     f"{want[k]}")
    print(f"[time] the data-parallel phase took "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches, numbers


# ---------------------------------------------------------------- the grid
GRID_WORLD = 2  # two gloo ranks on this one card, as the data-parallel phase
GRID_TIMEOUT_S = 600
GRID_IMAGES = 2  # per stream: 2 + 2 images, as world 1 takes them
# limits of the grid's steps against world 1's on the same batch: float32
# (the flagship at M = 2), the data-parallel phase's limits over 2 steps;
# bf16 (ViTDet-B at M = 2, ViTDet-L under FSDP), the metrics of the first
# step, where a split product or a convolution over 1 image instead of 2
# rounds its bf16 outputs otherwise (ViTDet-B at M = 2: 2.0e-2, NVIDIA
# H100 80GB HBM3, 700 W). The second step is printed, not held: from it on
# the teacher's bf16 scores move with those last bits across
# TEACHER.THRESHOLD (6.5 pseudo-labels against world 1's 5 in that run),
# and a wrong split (a bias added twice, another rank's heads) moves the
# first step's losses by far more
GRID_BF16_LOSS_RTOL = 5e-2
# a rank's bytes of the FSDP'd student, moments and teacher at most this
# share of world 1's (half, plus the small leaves that stay replicated)
GRID_FSDP_SHARE = 0.55


def grid_spawn(fn, args, world=GRID_WORLD):
    """``fn(rank, world, *args)`` in ``world`` gloo processes sharing this
    card (``dp_spawn``'s launch), or fail the run."""
    import tempfile

    from aldi_tpu_torch.parallel import mesh

    with tempfile.TemporaryDirectory(prefix="aldi_smoke_grid_") as tmp:
        try:
            return mesh.spawn(fn, world, f"file://{tmp}/store", *args,
                              device_type="cuda", backend="gloo",
                              timeout=GRID_TIMEOUT_S)
        except (RuntimeError, TimeoutError) as e:
            fail(f"grid: {fn.__name__}: {e}")


def state_bytes(state) -> dict:
    """GiB this rank's training state holds between steps: the student's
    parameters and gradients, the optimizer's moments, the teacher's
    parameters."""
    def gib(ts):
        return sum(t.numel() * t.element_size() for t in ts) / 2**30

    params = list(state.student.parameters())
    return {"params": gib(params),
            "grads": gib(p.grad for p in params if p.grad is not None),
            "moments": gib(t for s in state.optimizer.state.values()
                           for t in s.values()
                           if getattr(t, "ndim", 0) > 0),
            "teacher": gib(state.teacher.parameters())}


def grid_steps(rank, world, model, config, overrides, n_steps, seed,
               keep_state=False):
    """``n_steps`` DAOD steps of ``config`` at full width on the grid of
    ``model`` model ranks (``world`` 1: no group), each rank on its data
    index's share of global batches of GRID_IMAGES + GRID_IMAGES images and
    their draws, made on the card from ``seed`` alike on every rank;
    ``seeded_weights``; TF32 off. Returns per step the rank's metrics and
    ms, its peak GiB, the kernels' launches in the steps, the head groups
    G of the global blocks' attention launches, ``state_bytes`` after the
    last step and (``keep_state``) world 1's student and teacher gathered
    from the shards, on the CPU."""
    import torch

    from aldi_tpu_torch.engine.train_step import (create_train_state,
                                                  draw_step, make_train_step)
    from aldi_tpu_torch.models import build_detector, vit
    from aldi_tpu_torch.ops.flash_attn_kernel import (flash_attn_bwd,
                                                      flash_attn_fwd)
    from aldi_tpu_torch.ops.match_kernel import low_quality_mask, match_iou
    from aldi_tpu_torch.ops.roi_align_kernel import (roi_align_bwd,
                                                     roi_align_fwd)
    from aldi_tpu_torch.parallel import mesh

    if world > 1:
        mesh.make_grid(model)
    cfg = config_of(config, overrides)
    n = GRID_IMAGES
    cfg.SOLVER.IMS_PER_BATCH = 2 * n
    det = build_detector(cfg)
    state = create_train_state(cfg, det, seeded_weights(det, seed=0))
    step = make_train_step(cfg, det)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    batches = [synthetic_train_batch(gen, det.canvas, cfg.TPU.MAX_GT,
                                     det.num_classes, n)
               for _ in range(n_steps)]
    draws = [draw_step(gen, det, n, n) for _ in range(n_steps)]
    kernels = (match_iou, low_quality_mask, roi_align_fwd, roi_align_bwd,
               flash_attn_fwd, flash_attn_bwd)
    groups = set()
    attention = vit.flash_attention_relpos

    def recorded(q, *args, **kwargs):
        groups.add(q.shape[0])
        return attention(q, *args, **kwargs)

    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    vit.flash_attention_relpos = recorded
    metrics, times = [], []
    try:
        for k in kernels:
            k.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for b, d in zip(batches, draws):
            t0 = time.perf_counter()
            state, m = step(state, mesh.shard_batch(b), mesh.shard_draws(d))
            metrics.append({k: float(v) for k, v in m.items()})
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        launches = {k.name: k.launches for k in kernels}
    finally:
        vit.flash_attention_relpos = attention
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    out = {"metrics": metrics, "ms": times, "launches": launches,
           "groups": sorted(groups), "bytes": state_bytes(state),
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "split": {axis: sum(getattr(mesh.shard_of(p), "axis", None)
                               == axis
                               for p in state.student.parameters())
                     for axis in ("model", "data")}}
    if keep_state:
        for part in ("student", "teacher"):
            out[part] = {k: v.cpu() for k, v in mesh.full_state_dict(
                getattr(state, part)).items()}
    return out


def grid_all(rank, world):
    """The three grid runs of ``grid_phase`` in one process start each: the
    flagship's 2 float32 steps and ViTDet-B's bf16 step at M = 2, then
    ViTDet-L's bf16 step under FSDP at D = 2 (a grid of its own)."""
    r50 = grid_steps(rank, world, 2, FLAGSHIP, DP_FLOAT32, 2, 41,
                     keep_state=True)
    vitb = grid_steps(rank, world, 2, VIT_ALDI, None, 2, 42)
    vitl = grid_steps(rank, world, 1, VITL_ALDI, {"TPU.FSDP": True}, 2, 43)
    return r50, vitb, vitl


def grid_losses(label, ranks, want, model, steps=None):
    """The data ranks' summed metrics (one rank of each model group)
    against world 1's, per step: the worst relative error of the first
    ``steps`` (all by default); each step's printed."""
    outs = ranks[::model]
    worst = 0.0
    for i, w in enumerate(want["metrics"]):
        got = {k: sum(o["metrics"][i][k] for o in outs) for k in w}
        errs = {k: abs(got[k] - w[k]) / max(abs(w[k]), 1e-3) for k in w}
        k = max(errs, key=errs.get)
        print(f"[grid] {label}: the worst summed loss of step {i + 1}, {k}: "
              f"{got[k]:.7g} against world 1's {w[k]:.7g} (relative "
              f"{errs[k]:.3g})", flush=True)
        if steps is None or i < steps:
            worst = max(worst, errs[k])
    return worst


def grid_phase(card):
    """Tensor parallelism and FSDP (``aldi_tpu_torch/parallel/``) on two
    gloo ranks sharing this card, against world 1 on the same batch: (i)
    the flagship's DAOD step at M = 2, float32, 2 steps, the data-parallel
    phase's limits;
    (ii) ViTDet-B at M = 2, bf16: each rank's global blocks launch K3a/K3b
    on 2 images x 6 heads (G = 12), held against their plain versions at
    that G; (iii) ViTDet-L with TPU.FSDP at D = 2, bf16: each rank's bytes
    of student, moments and teacher between steps about half of world 1's.
    Returns the ranks' kernel launches per run and K3a/K3b's numbers at
    G = 12."""
    import torch

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    ranks = grid_spawn(grid_all, ())
    grid_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    r50 = [r[0] for r in ranks]
    vitb = [r[1] for r in ranks]
    vitl = [r[2] for r in ranks]
    r50_want = grid_steps(0, 1, 1, FLAGSHIP, DP_FLOAT32, 2, 41,
                          keep_state=True)
    torch.cuda.empty_cache()
    vitb_want = grid_steps(0, 1, 1, VIT_ALDI, None, 2, 42)
    torch.cuda.empty_cache()
    vitl_want = grid_steps(0, 1, 1, VITL_ALDI, {"TPU.FSDP": True}, 2, 43)
    torch.cuda.empty_cache()

    # (i) the flagship at M = 2, float32
    per_step = {"match_iou": 3, "low_quality_mask": 3, "roi_align_fwd": 4,
                "roi_align_bwd": 2}
    loss_err = grid_losses("R50-FPN, M = 2", r50, r50_want, 2)
    s, w = r50[0]["student"], r50_want["student"]
    param_err = max(float((s[k] - w[k]).abs().max()) for k in w
                    if w[k].is_floating_point())
    t = r50[0]["teacher"]
    teacher_err = max(float((t[k] - r50_want["teacher"][k]).abs().max())
                      for k in w if w[k].is_floating_point())
    for part in ("student", "teacher"):
        if not all(torch.equal(r50[0][part][k], r50[1][part][k])
                   for k in w):
            fail(f"grid: the model ranks gather different {part}s")
    for r, out in enumerate(r50):
        for name, count in per_step.items():
            if out["launches"][name] != 2 * count:
                fail(f"grid: R50-FPN rank {r} launched {name} "
                     f"{out['launches'][name]} times in 2 steps, {count} "
                     "per step expected")
    print(f"[grid] R50-FPN DAOD step at M = 2 (two gloo ranks on one card, "
          f"each the whole {GRID_IMAGES} + {GRID_IMAGES} images; the box "
          f"head's fc1/fc2 split, {r50[0]['split']['model']} parameters) "
          f"against world 1, float32, 2 steps: summed losses worst relative "
          f"error {loss_err:.3g} (tol {DP_LOSS_RTOL}), student max abs err "
          f"{param_err:.3g}, teacher {teacher_err:.3g} (tol "
          f"{DP_PARAM_ATOL}); launches of each rank "
          f"{[r['launches'] for r in r50]}; step ms rank 0 "
          f"{fmt(r50[0]['ms'])}, world 1 {fmt(r50_want['ms'])}; peak GiB per "
          f"rank {fmt([r['peak_gib'] for r in r50])}, world 1 "
          f"{r50_want['peak_gib']:.2f}; card {card}", flush=True)
    if loss_err > DP_LOSS_RTOL or max(param_err, teacher_err) > DP_PARAM_ATOL:
        fail("grid: R50-FPN at M = 2 differs from world 1")

    # (ii) ViTDet-B at M = 2, bf16: K3a/K3b at G = 12
    loss_err = grid_losses("ViTDet-B, M = 2", vitb, vitb_want, 2, steps=1)
    want_g = GRID_IMAGES * VIT_HEADS // 2
    for r, out in enumerate(vitb):
        if out["groups"] != [want_g]:
            fail(f"grid: ViTDet-B rank {r} launched attention at G = "
                 f"{out['groups']}, not {want_g}")
        if (out["launches"]["flash_attn_fwd"] != 2 * 20
                or out["launches"]["flash_attn_bwd"] != 2 * 8):
            fail(f"grid: ViTDet-B rank {r} launched K3a/K3b "
                 f"{out['launches']}, 20/8 per step expected")
    attn = check_attn(f"ViTDet-B at M = 2 ({GRID_IMAGES} images x "
                      f"{VIT_HEADS // 2} heads)", torch.bfloat16, *VIT_GRID,
                      want_g, seed=29, kernel_iters=5, plain_iters=1,
                      library=True)
    print(f"[grid] ViTDet-B DAOD step at M = 2, bf16, {GRID_IMAGES} + "
          f"{GRID_IMAGES}: step 1's summed metrics worst relative error "
          f"{loss_err:.3g} "
          f"(tol {GRID_BF16_LOSS_RTOL}); {vitb[0]['split']['model']} "
          f"parameters split per rank; K3a/K3b at G = {vitb[0]['groups']} "
          f"(world 1: {vitb_want['groups']}), launches of each rank "
          f"{[r['launches'] for r in vitb]}; step ms per rank "
          f"{[fmt(r['ms']) for r in vitb]}, world 1 {fmt(vitb_want['ms'])}; "
          f"peak GiB per rank {fmt([r['peak_gib'] for r in vitb])}, world 1 "
          f"{vitb_want['peak_gib']:.2f}; card {card}", flush=True)
    if loss_err > GRID_BF16_LOSS_RTOL:
        fail("grid: ViTDet-B at M = 2 differs from world 1")

    # (iii) ViTDet-L under FSDP at D = 2, bf16
    loss_err = grid_losses("ViTDet-L, FSDP D = 2", vitl, vitl_want, 1,
                           steps=1)
    shares = {k: [r["bytes"][k] / vitl_want["bytes"][k] for r in vitl]
              for k in ("params", "grads", "moments", "teacher")}
    for r, out in enumerate(vitl):
        if out["groups"] != [GRID_IMAGES // 2 * VITL_HEADS]:
            fail(f"grid: ViTDet-L rank {r} launched attention at G = "
                 f"{out['groups']}, not {GRID_IMAGES // 2 * VITL_HEADS}")
    print(f"[grid] ViTDet-L DAOD step with TPU.FSDP at D = 2, bf16, "
          f"{GRID_IMAGES // 2} + {GRID_IMAGES // 2} per rank of a global "
          f"{GRID_IMAGES} + {GRID_IMAGES}: step 1's summed metrics worst "
          f"relative error {loss_err:.3g} (tol {GRID_BF16_LOSS_RTOL}); "
          f"{vitl[0]['split']['data']} parameters sharded; K3a/K3b at G = "
          f"{vitl[0]['groups']} (world 1: {vitl_want['groups']}); GiB between "
          f"steps "
          f"per rank " + "; ".join(
              f"{k} {fmt([r['bytes'][k] for r in vitl], 3)} (world 1 "
              f"{vitl_want['bytes'][k]:.3f}, share "
              f"{fmt(shares[k], 3)})" for k in shares)
          + f"; peak GiB per rank {fmt([r['peak_gib'] for r in vitl])}, "
          f"world 1 {vitl_want['peak_gib']:.2f}; step ms per rank "
          f"{[fmt(r['ms']) for r in vitl]}, world 1 {fmt(vitl_want['ms'])}; "
          f"card {card}", flush=True)
    if loss_err > GRID_BF16_LOSS_RTOL:
        fail("grid: ViTDet-L under FSDP differs from world 1")
    for k in ("params", "moments", "teacher"):
        if max(shares[k]) > GRID_FSDP_SHARE:
            fail(f"grid: a rank holds {max(shares[k]):.3f} of world 1's "
                 f"{k} under FSDP at D = 2")
    print(f"[time] the grid phase took {time.perf_counter() - t_phase:.1f} s "
          f"(the ranks {grid_s:.1f} s with their start)", flush=True)
    launches = {f"{label}, rank {r}": out["launches"]
                for label, runs in (("R50-FPN M=2 training (2 steps)", r50),
                                    ("ViTDet-B M=2 training (2 steps)", vitb),
                                    ("ViTDet-L FSDP training (2 steps)",
                                     vitl))
                for r, out in enumerate(runs)}
    return launches, attn


def yolo_config(overrides=None):
    """The ALDI-Yolo recipe (YOLOv5-m, 8 classes, bfloat16) with
    ``overrides``."""
    return config_of(YOLO_ALDI, overrides)


def no_launches(name, kernels):
    """The six kernels' launch counts since they were last set to 0, which
    a YOLO path must leave at 0 (its convolutions run on cuDNN, its NMS is
    plain PyTorch)."""
    launches = {k.name: k.launches for k in kernels}
    if any(launches.values()):
        fail(f"the {name} path launched a kernel of the R-CNN paths: "
             f"{launches}")
    return launches


def staged_yolo_request(det, images, sizes):
    """One YOLO request with a synchronize after each stage: ms per
    stage."""
    import torch

    from aldi_tpu_torch.models.yolo import decode_predictions

    stages = {}
    t = time.perf_counter()

    def mark(name):
        nonlocal t
        torch.cuda.synchronize()
        now = time.perf_counter()
        stages[name] = (now - t) * 1e3
        t = now

    with torch.inference_mode():
        x = det.preprocess(images).permute(0, 3, 1, 2)
        mark("preprocess")
        preds, _ = det.module.eval()(x)
        mark("network (79 conv + BatchNorm + SiLU, eval mode)")
        decode_predictions(preds, det.num_classes, det.conf_thresh)
        mark("decode (sigmoid, boxes, best class)")
        det._inference_from_preds(preds, sizes)
        mark("decode + top 2000 + class-aware NMS + top-k")
    return stages


def yolo_serving_phase(card, kernels):
    """YOLOv5-m of ``configs/cityscapes/ALDI-Yolo-Cityscapes.yaml`` through
    ``build_detector`` and ``make_serving_fn`` with ``seeded_weights``: one
    warm-up and 3 timed requests of 8 images of 1024x2048, checked; a
    request by stage and a traced one (device busy and idle share, top
    kernels, layout conversions, which must be none). Returns the six
    kernels' launches in the timed requests (all 0)."""
    import torch

    from aldi_tpu_torch.engine.export import make_serving_fn
    from aldi_tpu_torch.models import build_detector
    from aldi_tpu_torch.models.yolo import ANCHORS, STRIDES

    cfg = yolo_config()
    name = model_name(cfg)
    t0 = time.perf_counter()
    det = build_detector(cfg)
    fn = make_serving_fn(det, seeded_weights(det, seed=0))
    torch.cuda.synchronize()
    n_cand = sum(len(a) * math.ceil(det.canvas[0] / s)
                 * math.ceil(det.canvas[1] / s)
                 for a, s in zip(ANCHORS, STRIDES))
    print(f"[serving] {name}, {det.num_classes} classes, canvas {det.canvas}, "
          f"{str(det.dtype).split('.')[-1]}, "
          f"{sum(p.numel() for p in det.module.parameters())} parameters; "
          f"{n_cand} candidates per image; built and seeded in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(1)
    requests = [synthetic_request(gen, det.canvas)
                for _ in range(1 + TIMED_REQUESTS)]
    t0 = time.perf_counter()
    fn(*requests[0])
    torch.cuda.synchronize()
    print(f"[serving] {name} warm-up request: "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms", flush=True)
    for k in kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    latencies, n_det = [], 0
    for images, sizes in requests[1:]:
        t0 = time.perf_counter()
        out = fn(images, sizes)
        torch.cuda.synchronize()
        latencies.append((time.perf_counter() - t0) * 1e3)
        n_det += check_detections(out, sizes, det.num_classes,
                                  cfg.TEST.DETECTIONS_PER_IMAGE,
                                  nonempty=False)
    launches = no_launches(f"{name} serving", kernels)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if n_det == 0:
        fail(f"{name}: no valid detections in any request")
    if det.module.training:
        fail(f"{name}: serving left the module in training mode")
    med = median(latencies)
    print(f"[serving] {name}, {TIMED_REQUESTS} requests of {BATCH} images: "
          f"latency ms {fmt(latencies)} (median {med:.2f}), "
          f"{BATCH * 1e3 / med:.2f} images/s at the median; {n_det} valid "
          f"detections; launches {launches}; peak device memory {peak:.2f} "
          f"GiB; card {card}", flush=True)
    images, sizes = requests[-1]
    stages = staged_yolo_request(det, images, sizes)
    print(f"[serving] {name}, one request by stage (ms, synchronized): "
          + "; ".join(f"{k} {v:.2f}" for k, v in stages.items()), flush=True)
    traced = device_busy(lambda: fn(images, sizes))
    if traced is None:
        print(f"[serving] {name} device busy share: not measured (the "
              "profiler saw no device events)")
    else:
        busy, top, per_kernel, converters, _ = traced
        print(f"[serving] {name}, traced request: device busy {busy:.2f} ms "
              f"of the {med:.2f} ms median request, idle share "
              f"{max(0.0, 1 - busy / med):.3f}; top kernels: "
              + "; ".join(f"{k[:60]} {ms:.2f} ms x{n}" for k, ms, n in top),
              flush=True)
        print(f"[serving] {name}, traced request: "
              + layout_conversions(per_kernel, converters), flush=True)
        if any(kind in k for k in per_kernel for kind in CONVERSIONS):
            fail(f"{name}: the serving path converts layouts")
    del det, fn, requests, out
    torch.cuda.empty_cache()
    return launches


def bn_stats(module):
    """Copies of a module's BatchNorm running statistics."""
    return {k: v.detach().clone() for k, v in module.named_buffers()}


def ema_of(teacher, student, alpha):
    """The worst |t' - (alpha t + (1 - alpha) s)| over the statistics,
    relative to each tensor's scale, of the teacher ``t'`` after a step
    (``teacher``: its statistics before and after; ``student``: the
    student's before)."""
    before, after = teacher
    return max(float((after[k] - (before[k] * alpha + student[k] * (1 - alpha))
                      ).abs().max()) / max(float(after[k].abs().max()), 1e-12)
               for k in after)


def yolo_training_phase(card, kernels, overrides=None, n=TRAIN_IMAGES,
                        timed=TIMED_STEPS, label=None):
    """The ALDI-Yolo DAOD step of YOLOv5-m (with ``overrides``) at full
    width and depth through ``create_train_state``, ``draw_step`` and
    ``make_train_step``: SOLVER.IMS_PER_BATCH cut from 48 to ``2 n`` (n
    labeled + n unlabeled images of 1024x2048), seeded weights, synthetic
    images and 5-30 gt boxes per labeled image. One warm-up step and
    ``timed`` timed steps; checks at every timed step: finite losses, the
    student's running statistics moved, the teacher's equal ``alpha t + (1
    - alpha) s`` of the statistics before the step (the EMA runs before the
    streams), the trainable parameters moved. Then a step by stage and a
    traced step. Returns (launches of the six kernels in the timed steps,
    all 0; the median step ms; the peak GiB). With ``timed`` 0 only the
    warm-up step runs, and an out-of-memory error returns None."""
    import torch

    from aldi_tpu_torch.engine.train_step import (create_train_state,
                                                  draw_step, make_train_step,
                                                  stream_flags)
    from aldi_tpu_torch.models import build_detector

    cfg = yolo_config(overrides)
    name = label or model_name(cfg)
    print(f"[train] {name} reductions: SOLVER.IMS_PER_BATCH "
          f"{cfg.SOLVER.IMS_PER_BATCH} -> {2 * n} ({n} labeled + {n} "
          f"unlabeled images per step); DOMAIN_ADAPT.TEACHER.THRESHOLD "
          f"{cfg.DOMAIN_ADAPT.TEACHER.THRESHOLD} -> 0 (the seeded weights' "
          f"detections score below it: at 0 each unlabeled image's "
          f"{cfg.TEST.DETECTIONS_PER_IMAGE} detections are its "
          f"pseudo-labels, so the distill stream's classification and "
          f"regression terms run); widths, depth and canvas as published",
          flush=True)
    cfg.SOLVER.IMS_PER_BATCH = 2 * n
    cfg.DOMAIN_ADAPT.TEACHER.THRESHOLD = 0.0
    t0 = time.perf_counter()
    det = build_detector(cfg)
    state = create_train_state(cfg, det, seeded_weights(det, seed=0))
    step = make_train_step(cfg, det)
    gen = torch.Generator(device="cuda").manual_seed(2)
    n_steps = 1 + timed + (2 if timed else 0)  # warm-up, timed, staged, traced
    batches = [synthetic_train_batch(gen, det.canvas, cfg.TPU.MAX_GT,
                                     det.num_classes, n)
               for _ in range(n_steps)]
    draws = [draw_step(gen, det, n, n) for _ in range(n_steps)]
    torch.cuda.synchronize()
    print(f"[train] {name}, {det.num_classes} classes, canvas {det.canvas}, "
          f"{str(det.dtype).split('.')[-1]}, SGD (Nesterov "
          f"{cfg.SOLVER.NESTEROV}), BACKWARD_AT_END "
          f"{cfg.SOLVER.BACKWARD_AT_END}; state, batches and draws made in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    start = params_of(state.student)
    for k in kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        state, m = step(state, batches[0], draws[0])
        torch.cuda.synchronize()
    except torch.cuda.OutOfMemoryError as e:
        if timed:
            raise
        print(f"[train] {name}: does not fit on the card: "
              f"{str(e).splitlines()[0]}; card {card}", flush=True)
        del state, batches, draws, det
        torch.cuda.empty_cache()
        return None
    warm_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not timed:
        launches = no_launches(name, kernels)
        mm = {k: float(v) for k, v in m.items()}
        if not all(math.isfinite(v) for v in mm.values()):
            fail(f"{name}: non-finite losses: {mm}")
        total = torch.cuda.get_device_properties(0).total_memory / 2**30
        print(f"[train] {name}: one step (the first, cold) "
              f"{warm_ms:.1f} ms; it fits, peak device memory {peak:.2f} GiB "
              f"of {total:.2f} GiB, without TPU.GRAD_ACCUM; card {card}",
              flush=True)
        del state, batches, draws, det
        torch.cuda.empty_cache()
        return launches, warm_ms, peak
    print(f"[train] {name} warm-up step: {warm_ms:.1f} ms", flush=True)

    alpha = cfg.EMA.ALPHA
    for k in kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    times, metrics, stat_moves, ema_errs = [], [], [], []
    for i in range(1, 1 + timed):
        s_before, t_before = bn_stats(state.student), bn_stats(state.teacher)
        t0 = time.perf_counter()
        state, m = step(state, batches[i], draws[i])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
        s_after = bn_stats(state.student)
        stat_moves.append(sum(not torch.equal(s_after[k], v)
                              for k, v in s_before.items()))
        ema_errs.append(ema_of((t_before, bn_stats(state.teacher)),
                               s_before, alpha))
        del s_before, t_before, s_after
    launches = no_launches(f"{name} training", kernels)
    peak = torch.cuda.max_memory_allocated() / 2**30
    for i, mm in enumerate(metrics):
        bad = [k for k, v in mm.items() if not math.isfinite(v)]
        if bad:
            fail(f"{name}: non-finite losses at timed step {i}: {bad}")
        if not mm["num_pseudo_labels"] > 0:
            fail(f"{name}: no pseudo-labels at timed step {i}")
    n_stats = len(bn_stats(state.student))
    if min(stat_moves) < n_stats:
        fail(f"{name}: only {min(stat_moves)} of {n_stats} running "
             "statistics of the student moved in a step")
    if max(ema_errs) > 1e-6:
        fail(f"{name}: the teacher's statistics are not alpha t + (1 - "
             f"alpha) s of the step before: worst relative error "
             f"{max(ema_errs):.3g}")
    if stream_flags(cfg).align:
        want = {f"loss_da_img_{s}" for s in ("source_strong", "target_weak")}
        if not want <= set(metrics[-1]):
            fail(f"{name}: alignment losses missing: "
                 f"{sorted(want - set(metrics[-1]))}")
    moved = sum(not torch.equal(p.detach(), start[k])
                for k, p in state.student.named_parameters())
    n_trainable = sum(p.requires_grad for p in state.student.parameters())
    if moved < n_trainable:
        fail(f"{name}: only {moved} of {n_trainable} trainable parameters "
             "moved")
    med = median(times)
    print(f"[train] {name}, {timed} steps: ms {fmt(times)} (median "
          f"{med:.2f}), {2 * n * 1e3 / med:.2f} images/s at the median; "
          f"launches {launches}; peak device memory {peak:.2f} GiB; "
          f"num_pseudo_labels {[mm['num_pseudo_labels'] for mm in metrics]};"
          f" per step all {n_stats} running statistics of the student moved "
          f"and the teacher's are the EMA (alpha {alpha}) of the step before "
          f"(worst relative error {max(ema_errs):.3g}, tol 1e-6); {moved} of "
          f"{n_trainable} trainable parameters moved; card {card}",
          flush=True)
    print(f"[train] {name}, losses of the last timed step: " + json.dumps(
        {k: round(v, 5) for k, v in metrics[-1].items()}), flush=True)

    stages = {}
    t = [time.perf_counter()]

    def mark(stage):
        torch.cuda.synchronize()
        now = time.perf_counter()
        stages[stage] = (now - t[0]) * 1e3
        t[0] = now

    torch.cuda.synchronize()
    t[0] = time.perf_counter()
    state, _ = step(state, batches[-2], draws[-2], mark=mark)
    print(f"[train] {name}, one step by stage (ms, synchronized): "
          + "; ".join(f"{k} {v:.2f}" for k, v in stages.items()), flush=True)
    traced = device_busy(lambda: step(state, batches[-1], draws[-1]))
    if traced is None:
        print(f"[train] {name} device busy share: not measured (the profiler "
              "saw no device events)")
    else:
        busy, top, per_kernel, converters, _ = traced
        print(f"[train] {name}, traced step: device busy {busy:.2f} ms of the "
              f"{med:.2f} ms median step, idle share "
              f"{max(0.0, 1 - busy / med):.3f}; top kernels: "
              + "; ".join(f"{k[:60]} {ms:.2f} ms x{n} " for k, ms, n in top),
              flush=True)
        print(f"[train] {name}, traced step: "
              + layout_conversions(per_kernel, converters), flush=True)
    del state, batches, draws, det
    torch.cuda.empty_cache()
    return launches, med, peak


def tiny_yolo_train_reference_check():
    """One ALDI-Yolo DAOD step of a tiny float32 YOLO (yolov5n, 3 classes,
    canvas 128, 2 + 2 images, MAX_GT 8) on the card against the same step
    on the CPU: the same seeded weights, batch and draws (made on the CPU
    and moved), TF32 off. The card's teacher pass is held against the
    CPU's (pseudo-labels' valid flags and classes equal, boxes within 1e-3
    px, predictions within 1e-4 of their scale), and the card's step goes
    on from the CPU's: a pseudo-label box one ulp apart could fall on
    another cell. Losses within 1e-4 relative, parameters and running
    statistics within 1e-5, the teacher's statistics too."""
    import numpy as np
    import torch

    from aldi_tpu_torch.engine.train_step import (create_train_state,
                                                  draw_step, make_train_step)
    from aldi_tpu_torch.models import build_detector

    cfg = yolo_config({"MODEL.YAML": "yolov5://yolov5n.yaml",
                       "MODEL.YOLO.NUM_CLASSES": 3, "TPU.CANVAS": (128, 128),
                       "TPU.MAX_GT": 8, "TPU.COMPUTE_DTYPE": "float32",
                       "TEST.DETECTIONS_PER_IMAGE": 10,
                       "SOLVER.WARMUP_ITERS": 0, "EMA.ALPHA": 0.9,
                       "DOMAIN_ADAPT.TEACHER.THRESHOLD": 0.1})
    rng = np.random.default_rng(0)
    boxes = np.zeros((2, 8, 4), np.float32)
    boxes[:, :3, :2] = rng.uniform(0, 80, (2, 3, 2))
    boxes[:, :3, 2:] = boxes[:, :3, :2] + rng.uniform(12, 48, (2, 3, 2))
    batch = {"labeled": {
        "image": rng.uniform(0, 255, (2, 128, 128, 3)).astype(np.float32),
        "sizes": np.array([[128, 128], [112, 120]], np.int32),
        "boxes": boxes, "classes": rng.integers(0, 3, (2, 8)).astype(
            np.int32), "valid": np.arange(8)[None].repeat(2, 0) < 3},
        "unlabeled": {
        "image": rng.uniform(0, 255, (2, 128, 128, 3)).astype(np.float32),
        "sizes": np.array([[128, 128], [120, 100]], np.int32)}}
    batch = {s: {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}
             for s, d in batch.items()}
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx_err = []
    try:
        cpu, card = build_detector(cfg, device="cpu"), build_detector(cfg)
        weights = seeded_weights(cpu, seed=1)
        draws = draw_step(torch.Generator().manual_seed(3), cpu, 2, 2)
        saved = {}
        cpu_ctx, card_ctx = cpu.forward_teacher_ctx, card.forward_teacher_ctx

        def record(*args, **kwargs):
            saved["cpu"] = cpu_ctx(*args, **kwargs)
            return saved["cpu"]

        def from_cpu(*args, **kwargs):
            (ctx, pseudo, _), want = card_ctx(*args, **kwargs), moved(
                saved["cpu"], card.device)
            w_ctx, w_pseudo, _ = want
            m = w_pseudo.valid
            if not (torch.equal(pseudo.valid, m) and m.any() and torch.equal(
                    pseudo.classes[m], w_pseudo.classes[m])):
                fail("tiny YOLO teacher: pseudo-labels differ between card "
                     "and CPU")
            ctx_err.append(float((pseudo.boxes[m] - w_pseudo.boxes[m]).abs()
                                 .max()))
            ctx_err.append(max(
                float((a - b).abs().max()) / float(b.abs().max())
                for a, b in zip(ctx["head_outputs"], w_ctx["head_outputs"])))
            return want

        cpu.forward_teacher_ctx, card.forward_teacher_ctx = record, from_cpu
        results = []
        for det in (cpu, card):
            state = create_train_state(cfg, det, weights)
            state, m = make_train_step(cfg, det)(
                state, moved(batch, det.device), moved(draws, det.device))
            results.append(({k: float(v) for k, v in m.items()},
                            {k: v.detach().cpu() for k, v in
                             state.student.state_dict().items()},
                            {k: v.detach().cpu() for k, v in
                             state.teacher.state_dict().items()}))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    (want_m, want_s, want_t), (got_m, got_s, got_t) = results
    loss_err = max(abs(got_m[k] - v) / max(abs(v), 1e-3)
                   for k, v in want_m.items())
    s_err = max(float((got_s[k] - v).abs().max()) for k, v in want_s.items())
    t_err = max(float((got_t[k] - v).abs().max()) for k, v in want_t.items())
    losses = json.dumps({k: round(v, 5) for k, v in want_m.items()})
    print(f"[reference] tiny float32 YOLOv5-n DAOD step (SGD, Nesterov), "
          f"card vs CPU: losses {losses}; "
          f"teacher pass: pseudo-labels equal, boxes max abs err "
          f"{ctx_err[0]:.3g} (tol 1e-3), predictions max err / scale "
          f"{ctx_err[1]:.3g} (tol 1e-4); worst relative loss error "
          f"{loss_err:.3g} (tol 1e-4); student parameters and running "
          f"statistics max abs err {s_err:.3g}, teacher's {t_err:.3g} (tol "
          f"1e-5)", flush=True)
    if (ctx_err[0] > 1e-3 or ctx_err[1] > 1e-4 or loss_err > 1e-4
            or s_err > 1e-5 or t_err > 1e-5):
        fail("tiny YOLO DAOD step: card and CPU disagree")


def tied_lapjv_problems(gen, p, n, m):
    """P assignment problems of [n, m] on the card with deliberate ties:
    costs on a grid of quarters in -8..8, about a third of the rows a copy
    of the row before, a fifth of the columns clipped to 1e4 in every row;
    n_rows spread over 0..n, the first four problems full (n rows)."""
    import torch

    cost = torch.randint(-32, 33, (p, n, m), generator=gen,
                         device="cuda").float() / 4
    dup = torch.rand((p, n), generator=gen, device="cuda") < 0.3
    for r in range(1, n):
        cost[:, r] = torch.where(dup[:, r, None], cost[:, r - 1], cost[:, r])
    clipped = torch.rand((p, 1, m), generator=gen, device="cuda") < 0.2
    cost = torch.where(clipped, torch.full((), 1e4, device="cuda"), cost)
    n_rows = torch.randint(0, n + 1, (p,), generator=gen, device="cuda")
    n_rows[:min(4, p)] = n
    return cost.contiguous(), n_rows.to(torch.int32)


def signed_zero_lapjv_problems(gen, p, n, m):
    """P problems of [n, m] of exact ties and zeros of both signs: every
    row is one row of -0.0, +0.0, 1 and 2 per problem, with a twentieth of
    its entries replaced by -1, -0.0 or +0.0, so that the searches run
    through assigned columns on ties and signed zeros reach the reduced
    costs and the duals; n_rows as ``tied_lapjv_problems``."""
    import torch

    base = torch.tensor([-0.0, 0.0, 1.0, 2.0], device="cuda")[torch.randint(
        0, 4, (p, 1, m), generator=gen, device="cuda")]
    own = torch.tensor([-1.0, -0.0, 0.0], device="cuda")[torch.randint(
        0, 3, (p, n, m), generator=gen, device="cuda")]
    pick = torch.rand((p, n, m), generator=gen, device="cuda") < 0.05
    cost = torch.where(pick, own, base.expand(p, n, m))
    n_rows = torch.randint(0, n + 1, (p,), generator=gen, device="cuda")
    n_rows[:min(4, p)] = n
    return cost.contiguous(), n_rows.to(torch.int32)


def near_duplicate_lapjv_problems(gen, p, n, m):
    """P problems of [n, m] whose rows are one row of U(0, 1) per problem
    plus U(0, 0.05) noise each: the rows want the same columns, as a
    teacher's 100 overlapping pseudo-labels do, so the searches run long
    (about 4,800 settles a problem at [100, 300], like the DETR step's
    launch on 100 pseudo-labels); every row solved."""
    import torch

    base = torch.rand((p, 1, m), generator=gen, device="cuda")
    noise = torch.rand((p, n, m), generator=gen, device="cuda")
    cost = base + 0.05 * noise
    return cost.contiguous(), torch.full((p,), n, dtype=torch.int32,
                                         device="cuda")


# K4's shape cases beside the DETR step's own launches: label -> (problems,
# n, m, costs, n_rows); costs "tied" (tied_lapjv_problems), "zeros"
# (signed_zero_lapjv_problems) or "near" (near_duplicate_lapjv_problems),
# n_rows "mixed" (theirs) or "none" (all 0)
LAPJV_CASES = {
    "near-duplicate rows, long searches": (24, 100, 300, "near", "mixed"),
    "m = 77, not a multiple of 32": (24, 50, 77, "tied", "mixed"),
    "m = 512, the warp kernel's widest": (8, 100, 512, "tied", "mixed"),
    "n = m = 128": (8, 128, 128, "tied", "mixed"),
    "n = m = 77": (8, 77, 77, "tied", "mixed"),
    "costs in global memory, 160 x 480": (4, 160, 480, "tied", "mixed"),
    "n_rows all 0": (8, 100, 300, "tied", "none"),
    "-0, +0 and exact ties": (24, 100, 300, "zeros", "mixed"),
    "-0, +0 and exact ties, n = m = 100": (8, 100, 100, "zeros", "mixed"),
    "m = 600, the block kernel": (4, 50, 600, "tied", "mixed"),
}


def lapjv_case(gen, problems, n, m, costs, n_rows):
    """One of LAPJV_CASES' problem sets on the card: (cost, n_rows)."""
    make = {"tied": tied_lapjv_problems,
            "zeros": signed_zero_lapjv_problems,
            "near": near_duplicate_lapjv_problems}[costs]
    cost, rows = make(gen, problems, n, m)
    if n_rows == "none":
        rows.zero_()
    return cost, rows


def lapjv_bound(cost, settles):
    """Least time (ms) the card could take for K4 on ``cost`` [P, n, m],
    and what sets it: bytes (the costs and n_rows read once, col4row and
    the settles written once) against operations (per settle of this run,
    the reduced cost of each column, 3 adds, and its comparisons, 2, in
    float32)."""
    p, n, m = cost.shape
    n_bytes = cost.numel() * 4 + p * 4 + p * n * 4 + p * 4
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = int(settles.sum()) * m * 5 / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def check_lapjv(label, cost, n_rows, kernel_iters=20, plain_iters=1):
    """K4 (its wrapper) against ``lapjv_plain`` on these problems: col4row
    and the settles exactly equal; each problem's assignment a permutation
    whose cost (summed in float64) equals
    ``scipy.optimize.linear_sum_assignment``'s to float32 rounding (1e-6
    of the summed magnitude, plus 1e-3). Times: the kernel's wrapper, the
    kernel alone (its C entry point on preallocated outputs, as
    ``launch_ms``), the plain version on the card (``plain_iters`` 0: not
    timed), and scipy on the host with the copy of the costs included (the
    yardstick; no PyTorch call solves an assignment, so ``library_ms``
    stays null). ns per settle: the kernel alone over the most settles of
    any problem, since the problems run side by side and each one's
    settles in sequence. Returns the kernels line's numbers."""
    import numpy as np
    import torch
    from scipy.optimize import linear_sum_assignment

    from aldi_tpu_torch.ops.lapjv import lapjv_plain
    from aldi_tpu_torch.ops.lapjv_kernel import lapjv

    got, settles = lapjv(cost, n_rows)
    want, want_settles = lapjv_plain(cost, n_rows)
    torch.cuda.synchronize()
    unequal = int((got != want).sum())
    if unequal or not torch.equal(settles, want_settles):
        fail(f"lapjv ({label}): K4 differs from lapjv_plain in {unequal} "
             f"entries of col4row; settles equal: "
             f"{torch.equal(settles, want_settles)}")

    def scipy_solve():
        c = cost.cpu().numpy()
        nr = n_rows.cpu().tolist()
        return [linear_sum_assignment(c[i, :k]) if k else None
                for i, k in enumerate(nr)]

    t0 = time.perf_counter()
    ref = scipy_solve()
    scipy_ms = (time.perf_counter() - t0) * 1e3
    c64 = cost.double().cpu().numpy()
    col = got.cpu().numpy()
    worst = 0.0
    for i, r in enumerate(ref):
        if r is None:
            if (col[i] != -1).any():
                fail(f"lapjv ({label}): problem {i} has no rows to solve "
                     f"but assigns some")
            continue
        k = len(r[0])
        cols = col[i, :k]
        if (cols < 0).any() or len(set(cols.tolist())) != k:
            fail(f"lapjv ({label}): problem {i} is not a permutation")
        mine = c64[i, np.arange(k), cols].sum()
        best = c64[i, r[0], r[1]].sum()
        tol = 1e-6 * np.abs(c64[i, r[0], r[1]]).sum() + 1e-3
        if abs(mine - best) > tol:
            fail(f"lapjv ({label}): problem {i} costs {mine}, scipy's "
                 f"{best} (tol {tol:.3g})")
        worst = max(worst, abs(mine - best))
    ms = cuda_ms(lambda: lapjv(cost, n_rows), kernel_iters)
    p, n, m = cost.shape
    out, out_settles = torch.empty_like(got), torch.empty_like(settles)
    nbytes = lapjv.scratch_bytes(p, n, m)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=cost.device)
    kernel_ms = launch_ms(lapjv, (
        cost.data_ptr(), n_rows.data_ptr(), p, n, m, out.data_ptr(),
        out_settles.data_ptr(), scratch.data_ptr() if nbytes else None,
        torch.cuda.current_stream().cuda_stream), kernel_iters)
    plain_ms = (cuda_ms(lambda: lapjv_plain(cost, n_rows), plain_iters,
                        warmup=0) if plain_iters else None)
    bound_ms, bound_by = lapjv_bound(cost, settles)
    st = settles.float()
    most = int(st.max()) if p else 0
    ns_per_settle = kernel_ms * 1e6 / most if most else None
    kernel = lapjv.kernel_for(n, m)
    print(f"[kernel] lapjv (K4), {label}: {p} problems of [{n}, {m}], rows "
          f"solved {int(n_rows.sum())} (max {int(n_rows.max())}); {kernel}; "
          f"col4row and settles exactly equal to lapjv_plain; cost equal to "
          f"scipy's (worst |difference| {worst:.3g}); settles per problem "
          f"mean {float(st.mean()):.1f}, max {most}; wrapper {ms:.4f} ms, "
          f"kernel alone {kernel_ms:.4f} ms"
          + (f" ({ns_per_settle:.1f} ns per settle of the longest problem)"
             if ns_per_settle else "")
          + (f", plain {plain_ms:.2f} ms" if plain_ms is not None else "")
          + f", scipy on the host with the copy {scipy_ms:.2f} ms, bound "
          f"{bound_ms:.5f} ms ({bound_by}), {bound_ms / ms:.5f} of the "
          f"bound", flush=True)
    return dict(max_abs_err=float(unequal), ms=ms, kernel_ms=kernel_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                scipy_ms=scipy_ms, settles_mean=float(st.mean()),
                settles_max=most, ns_per_settle=ns_per_settle,
                kernel=kernel, problems=[p, n, m])


def check_lapjv_cases(seed=57):
    """K4 on each of LAPJV_CASES, exactly equal to ``lapjv_plain`` and
    cost-equal to scipy (the plain version untimed). Returns {label:
    numbers}."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return {label: check_lapjv(label, *lapjv_case(gen, *case),
                               kernel_iters=5, plain_iters=0)
            for label, case in LAPJV_CASES.items()}


def detr_config(overrides=None):
    """The ALDI-Best-DETR recipe (R50, 4 levels, 6 + 6 layers, d_model 256,
    8 heads, 4 points, 300 queries, 8 classes, 800x1344, float32) without
    its weight file (not in the repository), with ``overrides``."""
    return config_of(DETR_ALDI, {"MODEL.WEIGHTS": "", **(overrides or {})})


def detr_tokens(det):
    """The encoder's tokens per image on the detector's canvas."""
    h, w = det.canvas
    hws = [(math.ceil(h / s), math.ceil(w / s)) for s in (8, 16, 32)]
    hws.append(((hws[-1][0] + 1) // 2, (hws[-1][1] + 1) // 2))
    return sum(a * b for a, b in hws)


def msda_share(per_kernel, busy):
    """(ms, share of the busy time) of the multi-scale deformable
    attention's sampling kernels (``grid_sampler_2d`` forward and backward)
    in a trace."""
    ms = sum(v for k, (v, _) in per_kernel.items() if "grid_sampler" in k)
    return ms, ms / busy if busy else 0.0


def staged_detr_request(det, images, sizes):
    """One DETR request with a synchronize after each stage: ms per stage.
    The module's stages are cumulative runs (``stage="backbone"``, then
    ``"encoder"``, then the whole): each stage's time is the difference;
    the post-processing runs on the whole run's outputs."""
    import torch

    runs = {}
    with torch.inference_mode():
        for stage in ("backbone", "encoder", "full"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = det._fwd(None, images, sizes, False, stage=stage)
            torch.cuda.synchronize()
            runs[stage] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        det.detections(out, sizes)
        torch.cuda.synchronize()
        post = (time.perf_counter() - t0) * 1e3
    return {"R50 + input projections + flatten": runs["backbone"],
            "encoder (6 layers, MSDA)": runs["encoder"] - runs["backbone"],
            "decoder + heads (6 layers)": runs["full"] - runs["encoder"],
            "sigmoid + top-k + boxes": post}


def detr_serving_phase(card, kernels):
    """Deformable DETR of ``configs/cityscapes/ALDI-Best-DETR-Cityscapes
    .yaml`` through ``build_detector`` and ``make_serving_fn`` with
    ``seeded_weights``: one warm-up and 3 timed requests of 8 images of
    800x1344 in float32, checked; a request by stage and a traced one
    (device busy and idle share, top kernels, MSDA's share). Returns the
    seven kernels' launches in the timed requests (all 0: K4 is
    training-only)."""
    import torch

    from aldi_tpu_torch.engine.export import make_serving_fn
    from aldi_tpu_torch.models import build_detector

    cfg = detr_config()
    name = model_name(cfg)
    t0 = time.perf_counter()
    det = build_detector(cfg)
    fn = make_serving_fn(det, seeded_weights(det, seed=0))
    torch.cuda.synchronize()
    print(f"[serving] {name}, {det.num_classes} classes, canvas {det.canvas}, "
          f"{str(det.dtype).split('.')[-1]}, "
          f"{sum(p.numel() for p in det.module.parameters())} parameters; "
          f"{detr_tokens(det)} encoder tokens per image; built and seeded in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(1)
    requests = [synthetic_request(gen, det.canvas)
                for _ in range(1 + TIMED_REQUESTS)]
    t0 = time.perf_counter()
    fn(*requests[0])
    torch.cuda.synchronize()
    print(f"[serving] {name} warm-up request: "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms", flush=True)
    for k in kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    latencies, n_det = [], 0
    for images, sizes in requests[1:]:
        t0 = time.perf_counter()
        out = fn(images, sizes)
        torch.cuda.synchronize()
        latencies.append((time.perf_counter() - t0) * 1e3)
        n_det += check_detections(out, sizes, det.num_classes,
                                  cfg.TEST.DETECTIONS_PER_IMAGE,
                                  nonempty=False)
    launches = no_launches(f"{name} serving", kernels)
    peak = torch.cuda.max_memory_allocated() / 2**30
    med = median(latencies)
    print(f"[serving] {name}, {TIMED_REQUESTS} requests of {BATCH} images: "
          f"latency ms {fmt(latencies)} (median {med:.2f}), "
          f"{BATCH * 1e3 / med:.2f} images/s at the median; {n_det} valid "
          f"detections; launches {launches}; peak device memory {peak:.2f} "
          f"GiB; card {card}", flush=True)
    images, sizes = requests[-1]
    stages = staged_detr_request(det, images, sizes)
    print(f"[serving] {name}, one request by stage (ms, synchronized): "
          + "; ".join(f"{k} {v:.2f}" for k, v in stages.items()), flush=True)
    traced = device_busy(lambda: fn(images, sizes))
    if traced is None:
        print(f"[serving] {name} device busy share: not measured (the "
              "profiler saw no device events)")
    else:
        busy, top, per_kernel, _, _ = traced
        ms, share = msda_share(per_kernel, busy)
        print(f"[serving] {name}, traced request: device busy {busy:.2f} ms "
              f"of the {med:.2f} ms median request, idle share "
              f"{max(0.0, 1 - busy / med):.3f}; MSDA's grid_sampler_2d "
              f"{ms:.2f} ms, {share:.3f} of busy; top kernels: "
              + "; ".join(f"{k[:60]} {v:.2f} ms x{n}" for k, v, n in top),
              flush=True)
    del det, fn, requests, out
    torch.cuda.empty_cache()
    return launches


class LapjvLaunches:
    """While active, records every K4 launch: copies of its costs and
    n_rows."""

    def __init__(self):
        self.launches = []

    def __enter__(self):
        from aldi_tpu_torch.ops.lapjv_kernel import Lapjv

        self.saved = Lapjv.__call__
        call, rec = self.saved, self.launches

        def record(kernel, cost, n_rows):
            rec.append((cost.clone(), n_rows.clone()))
            return call(kernel, cost, n_rows)

        Lapjv.__call__ = record
        return self

    def __exit__(self, *exc):
        from aldi_tpu_torch.ops.lapjv_kernel import Lapjv

        Lapjv.__call__ = self.saved


def teacher_blend_err(t_before, t_after, s_before, alpha):
    """The worst |t' - (alpha t + (1 - alpha) s)| over the teacher's
    parameters other than ``query_embed``, relative to each tensor's scale,
    and whether the teacher's ``query_embed`` is the student's from before
    the step (EMA.START_ITER passed: the EMA runs before the streams)."""
    blended = [k for k in t_after if "query_embed" not in k]
    err = ema_of(({k: t_before[k] for k in blended},
                  {k: t_after[k] for k in blended}), s_before, alpha)
    copied = all(bool((t_after[k] == s_before[k]).all())
                 for k in t_after if "query_embed" in k)
    return err, copied


def detr_training_phase(card, kernels, overrides=None, n=TRAIN_IMAGES,
                        timed=TIMED_STEPS, label=None):
    """The ALDI-Best-DETR DAOD step (with ``overrides``) at full width and
    depth through ``create_train_state``, ``draw_step`` and
    ``make_train_step``: SOLVER.IMS_PER_BATCH cut from 48 to ``2 n`` (n
    labeled + n unlabeled images of 800x1344), float32, seeded weights,
    synthetic images and 5-30 gt boxes per labeled image, TEACHER.THRESHOLD
    0. One warm-up step, whose K4 launches are recorded, and ``timed``
    timed steps; checks at every timed step: finite losses, the distill
    stream's ``loss_ce_distill`` present and non-zero (DETR's losses pass
    ungated), 100 pseudo-labels per image, the teacher's ``query_embed``
    the student's from before the step and its other parameters ``alpha t
    + (1 - alpha) s``; after them every trainable parameter moved and the
    frozen stem and res2 did not, and K4 launched twice per step (the
    labeled_strong and the distill streams' criteria) and no other kernel.
    Then a step by stage and a traced step (MSDA's share of the busy time).
    Returns (launches in the timed steps, the median step ms, the peak GiB,
    the warm-up step's K4 launches). With ``timed`` 0 only the warm-up step
    runs, and an out-of-memory error returns None."""
    import torch

    from aldi_tpu_torch.engine.train_step import (create_train_state,
                                                  draw_step, make_train_step)
    from aldi_tpu_torch.models import build_detector

    cfg = detr_config(overrides)
    name = label or model_name(cfg)
    print(f"[train] {name} reductions: SOLVER.IMS_PER_BATCH "
          f"{cfg.SOLVER.IMS_PER_BATCH} -> {2 * n} ({n} labeled + {n} "
          f"unlabeled images per step); DOMAIN_ADAPT.TEACHER.THRESHOLD "
          f"{cfg.DOMAIN_ADAPT.TEACHER.THRESHOLD} -> 0 (the seeded weights' "
          f"scores are below it: at 0 each unlabeled image's "
          f"{cfg.TEST.DETECTIONS_PER_IMAGE} detections are its "
          f"pseudo-labels, K4's worst case of {cfg.TPU.MAX_GT} rows); "
          f"TPU.GRAD_ACCUM {cfg.TPU.GRAD_ACCUM}; widths, depth and canvas as "
          f"published", flush=True)
    cfg.SOLVER.IMS_PER_BATCH = 2 * n
    cfg.DOMAIN_ADAPT.TEACHER.THRESHOLD = 0.0
    t0 = time.perf_counter()
    det = build_detector(cfg)
    state = create_train_state(cfg, det, seeded_weights(det, seed=0))
    step = make_train_step(cfg, det)
    gen = torch.Generator(device="cuda").manual_seed(2)
    n_steps = 1 + timed + (2 if timed else 0)  # warm-up, timed, staged, traced
    batches = [synthetic_train_batch(gen, det.canvas, cfg.TPU.MAX_GT,
                                     det.num_classes, n)
               for _ in range(n_steps)]
    draws = [draw_step(gen, det, n, n) for _ in range(n_steps)]
    torch.cuda.synchronize()
    print(f"[train] {name}, {det.num_classes} classes, canvas {det.canvas}, "
          f"{str(det.dtype).split('.')[-1]}, AdamW (R50 and sampling "
          f"offsets / reference points x0.1), dropout "
          f"{cfg.MODEL.DEFORMABLE_DETR.TRANSFORMER.DROPOUT}; state, batches "
          f"and draws made in {time.perf_counter() - t0:.2f} s", flush=True)
    start = params_of(state.student)
    for k in kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        with LapjvLaunches() as recorded:
            state, m = step(state, batches[0], draws[0])
            torch.cuda.synchronize()
    except torch.cuda.OutOfMemoryError as e:
        if timed:
            raise
        print(f"[train] {name}: does not fit on the card: "
              f"{str(e).splitlines()[0]}; card {card}", flush=True)
        del state, batches, draws, det, start
        torch.cuda.empty_cache()
        return None
    warm_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    mm = {k: float(v) for k, v in m.items()}
    if not all(math.isfinite(v) for v in mm.values()):
        fail(f"{name}: non-finite losses: {mm}")
    if not timed:
        total = torch.cuda.get_device_properties(0).total_memory / 2**30
        print(f"[train] {name}: one step (the first, cold) {warm_ms:.1f} ms; "
              f"it fits, peak device memory {peak:.2f} GiB of {total:.2f} "
              f"GiB; launches {no_launches(name, kernels[:-1])} and K4 "
              f"{kernels[-1].launches}; card {card}", flush=True)
        del state, batches, draws, det, start, recorded
        torch.cuda.empty_cache()
        return {}, warm_ms, peak, []
    print(f"[train] {name} warm-up step: {warm_ms:.1f} ms, "
          f"{len(recorded.launches)} K4 launches", flush=True)

    alpha = cfg.EMA.ALPHA
    for k in kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    times, metrics, ema_errs = [], [], []
    for i in range(1, 1 + timed):
        s_before, t_before = params_of(state.student), params_of(
            state.teacher)
        t0 = time.perf_counter()
        state, m = step(state, batches[i], draws[i])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
        err, copied = teacher_blend_err(t_before, params_of(state.teacher),
                                        s_before, alpha)
        if not copied:
            fail(f"{name}: the teacher's query_embed is not the student's "
                 f"from before timed step {i}")
        ema_errs.append(err)
        del s_before, t_before
    launches = {k.name: k.launches for k in kernels}
    want = {k.name: 0 for k in kernels}
    want["lapjv"] = 2 * timed
    if launches != want:
        fail(f"{name}: {timed} steps launched {launches}, expected {want}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    for i, mm in enumerate(metrics):
        bad = [k for k, v in mm.items() if not math.isfinite(v)]
        if bad:
            fail(f"{name}: non-finite losses at timed step {i}: {bad}")
        if not mm.get("loss_ce_distill", 0.0) > 0:
            fail(f"{name}: loss_ce_distill is {mm.get('loss_ce_distill')} "
                 f"at timed step {i}: the distill stream is gated")
        if mm["num_pseudo_labels"] != cfg.TEST.DETECTIONS_PER_IMAGE:
            fail(f"{name}: {mm['num_pseudo_labels']} pseudo-labels per "
                 f"image at timed step {i}")
    if max(ema_errs) > 1e-6:
        fail(f"{name}: the teacher is not alpha t + (1 - alpha) s of the "
             f"step before: worst relative error {max(ema_errs):.3g}")
    trainable = {k for k, p in state.student.named_parameters()
                 if p.requires_grad}
    after = params_of(state.student)
    moved = {k for k, v in after.items() if not torch.equal(v, start[k])}
    if moved != trainable:
        fail(f"{name}: trainable parameters that did not move "
             f"{sorted(trainable - moved)[:5]}, frozen ones that did "
             f"{sorted(moved - trainable)[:5]}")
    med = median(times)
    print(f"[train] {name}, {timed} steps: ms {fmt(times)} (median "
          f"{med:.2f}), {2 * n * 1e3 / med:.2f} images/s at the median; "
          f"launches {launches}; peak device memory {peak:.2f} GiB; "
          f"num_pseudo_labels {[mm['num_pseudo_labels'] for mm in metrics]};"
          f" per step the teacher's query_embed is the student's before the "
          f"step and its other parameters the EMA (alpha {alpha}, worst "
          f"relative error {max(ema_errs):.3g}, tol 1e-6); all "
          f"{len(trainable)} trainable parameters moved, the "
          f"{len(after) - len(trainable)} frozen ones (stem, res2) did not; "
          f"card {card}", flush=True)
    print(f"[train] {name}, losses of the last timed step: " + json.dumps(
        {k: round(v, 5) for k, v in metrics[-1].items()}), flush=True)

    stages = {}
    t = [time.perf_counter()]

    def mark(stage):
        torch.cuda.synchronize()
        now = time.perf_counter()
        stages[stage] = (now - t[0]) * 1e3
        t[0] = now

    torch.cuda.synchronize()
    t[0] = time.perf_counter()
    state, _ = step(state, batches[-2], draws[-2], mark=mark)
    print(f"[train] {name}, one step by stage (ms, synchronized): "
          + "; ".join(f"{k} {v:.2f}" for k, v in stages.items()), flush=True)
    traced = device_busy(lambda: step(state, batches[-1], draws[-1]))
    if traced is None:
        print(f"[train] {name} device busy share: not measured (the profiler "
              "saw no device events)")
    else:
        busy, top, per_kernel, _, _ = traced
        ms, share = msda_share(per_kernel, busy)
        k4 = sum(v for k, (v, _) in per_kernel.items() if "lapjv" in k)
        print(f"[train] {name}, traced step: device busy {busy:.2f} ms of the "
              f"{med:.2f} ms median step, idle share "
              f"{max(0.0, 1 - busy / med):.3f}; MSDA's grid_sampler_2d "
              f"forward and backward {ms:.2f} ms, {share:.3f} of busy; K4 "
              f"{k4:.3f} ms; top kernels: "
              + "; ".join(f"{k[:60]} {v:.2f} ms x{c}" for k, v, c in top),
              flush=True)
    records = recorded.launches
    del state, batches, draws, det, start, after
    torch.cuda.empty_cache()
    return launches, med, peak, records


def detr_published_chunk(card, kernels):
    """One step at the published SOLVER.IMS_PER_GPU (16 + 16): its peak, or
    that it does not fit and the smallest TPU.GRAD_ACCUM that does."""
    for accum in (1, 2, 4, 8):
        r = detr_training_phase(
            card, kernels, {"TPU.GRAD_ACCUM": accum}, n=DETR_PUBLISHED_CHUNK,
            timed=0, label=f"Deformable DETR at the published "
            f"SOLVER.IMS_PER_GPU, TPU.GRAD_ACCUM {accum}")
        if r is not None:
            return accum, r[1], r[2]
    fail("Deformable DETR: 16 + 16 does not fit at TPU.GRAD_ACCUM 8")


def tiny_detr_config(overrides=None):
    """The ALDI-Best-DETR recipe cut to its tiny float32 form: 2 + 2
    layers, d_model 64, FFN 128, 4 heads, 20 queries, 3 classes, canvas
    128, MAX_GT 8, 10 detections, no warmup and no dropout (the CPU's and
    the card's generators draw different masks), EMA.ALPHA 0.9,
    TEACHER.THRESHOLD 0."""
    t = "MODEL.DEFORMABLE_DETR.TRANSFORMER."
    return detr_config({
        "MODEL.DEFORMABLE_DETR.NUM_CLASSES": 3, t + "ENC_LAYERS": 2,
        t + "DEC_LAYERS": 2, t + "NUM_QUERIES": 20, t + "HIDDEN_DIM": 64,
        t + "DIM_FEEDFORWARD": 128, t + "NHEADS": 4, t + "DROPOUT": 0.0,
        "TPU.CANVAS": (128, 128), "TPU.MAX_GT": 8,
        "TEST.DETECTIONS_PER_IMAGE": 10, "SOLVER.WARMUP_ITERS": 0,
        "EMA.ALPHA": 0.9, "DOMAIN_ADAPT.TEACHER.THRESHOLD": 0.0,
        **(overrides or {})})


def tiny_detr_reference_check(kernel, overrides=None):
    """A tiny float32 Deformable DETR (``tiny_detr_config`` with
    ``overrides``) on the card against the same detector on the CPU, TF32
    off, the same seeded weights: a request's detections (classes equal,
    boxes within 1e-3 px, scores 1e-4), then one ALDI-Best-DETR step on
    the same batch and draws (made on the CPU and moved). The card's
    teacher pass is held against the CPU's (pseudo-labels' valid flags and
    classes equal, boxes within 1e-3 px) and the card's step goes on from
    the CPU's pseudo-labels: a box one ulp apart could change a Hungarian
    assignment. Losses within 1e-4 relative; parameters, the student's
    and the teacher's, within 2 * SOLVER.BASE_LR (AdamW's first step moves
    an entry by about lr * sign(g), and an entry whose gradient sits at
    float32 noise can go either way) with at most 0.1% of the entries
    beyond 1e-6. K4 launches on the card step (``kernel``: 2 per step, 4
    with two-stage), never on the CPU."""
    import numpy as np
    import torch

    from aldi_tpu_torch.engine.export import make_serving_fn
    from aldi_tpu_torch.engine.train_step import (create_train_state,
                                                  draw_step, make_train_step)
    from aldi_tpu_torch.models import build_detector

    cfg = tiny_detr_config(overrides)
    name = f"tiny float32 {model_name(cfg)}"
    rng = np.random.default_rng(0)
    boxes = np.zeros((2, 8, 4), np.float32)
    boxes[:, :4, :2] = rng.uniform(0, 80, (2, 4, 2))
    boxes[:, :4, 2:] = boxes[:, :4, :2] + rng.uniform(12, 48, (2, 4, 2))
    batch = {"labeled": {
        "image": rng.uniform(0, 255, (2, 128, 128, 3)).astype(np.float32),
        "sizes": np.array([[128, 128], [112, 120]], np.int32),
        "boxes": boxes, "classes": rng.integers(0, 3, (2, 8)).astype(
            np.int32), "valid": np.arange(8)[None].repeat(2, 0) < 4},
        "unlabeled": {
        "image": rng.uniform(0, 255, (2, 128, 128, 3)).astype(np.float32),
        "sizes": np.array([[128, 128], [120, 100]], np.int32)}}
    batch = {s: {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}
             for s, d in batch.items()}
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    errs = {}
    try:
        cpu, card = build_detector(cfg, device="cpu"), build_detector(cfg)
        weights = seeded_weights(cpu, seed=1)
        images, sizes = batch["unlabeled"]["image"], batch["unlabeled"][
            "sizes"]
        want = make_serving_fn(cpu, weights)(images, sizes)
        got = {k: v.cpu() for k, v in make_serving_fn(card, weights)(
            images, sizes).items()}
        if not (torch.equal(got["valid"], want["valid"])
                and torch.equal(got["classes"], want["classes"])):
            fail(f"{name}: detections differ between card and CPU")
        errs["boxes"] = float((got["boxes"] - want["boxes"]).abs().max())
        errs["scores"] = float((got["scores"] - want["scores"]).abs().max())

        draws = draw_step(torch.Generator().manual_seed(3), cpu, 2, 2)
        saved = {}
        cpu_ctx, card_ctx = cpu.forward_teacher_ctx, card.forward_teacher_ctx

        def record(*args, **kwargs):
            saved["cpu"] = cpu_ctx(*args, **kwargs)
            return saved["cpu"]

        def from_cpu(*args, **kwargs):
            (_, pseudo, _), want_ctx = card_ctx(*args, **kwargs), moved(
                saved["cpu"], card.device)
            w_pseudo = want_ctx[1]
            m = w_pseudo.valid
            if not (torch.equal(pseudo.valid, m) and m.any() and torch.equal(
                    pseudo.classes[m], w_pseudo.classes[m])):
                fail(f"{name}: pseudo-labels differ between card and CPU")
            errs["pseudo boxes"] = float(
                (pseudo.boxes[m] - w_pseudo.boxes[m]).abs().max())
            return want_ctx

        cpu.forward_teacher_ctx, card.forward_teacher_ctx = record, from_cpu
        results = []
        for det in (cpu, card):
            kernel.launches = 0
            state = create_train_state(cfg, det, weights)
            state, m = make_train_step(cfg, det)(
                state, moved(batch, det.device), moved(draws, det.device))
            results.append(({k: float(v) for k, v in m.items()},
                            params_of(state.student), params_of(state.teacher),
                            kernel.launches))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    (want_m, want_s, want_t, cpu_k4), (got_m, got_s, got_t, card_k4) = results
    per_step = 4 if cfg.MODEL.DEFORMABLE_DETR.TWO_STAGE else 2
    if cpu_k4 != 0 or card_k4 != per_step:
        fail(f"{name}: K4 launched {cpu_k4} times on the CPU step and "
             f"{card_k4} on the card's, expected 0 and {per_step}")
    loss_err = max(abs(got_m[k] - v) / max(abs(v), 1e-3)
                   for k, v in want_m.items())
    lr = cfg.SOLVER.BASE_LR
    worst, share = {}, {}
    for who, g, w in (("student", got_s, want_s), ("teacher", got_t, want_t)):
        diff = [(g[k].cpu() - v).abs() for k, v in w.items()]
        worst[who] = max(float(d.max()) for d in diff)
        share[who] = sum(int((d > 1e-6).sum()) for d in diff) / sum(
            d.numel() for d in diff)
    losses = json.dumps({k: round(v, 5) for k, v in want_m.items()})
    print(f"[reference] {name}, card vs CPU: detections boxes max abs err "
          f"{errs['boxes']:.3g} (tol 1e-3), scores {errs['scores']:.3g} "
          f"(tol 1e-4); DAOD step losses {losses}; teacher pass "
          f"pseudo-labels equal, boxes max abs err {errs['pseudo boxes']:.3g}"
          f" (tol 1e-3); worst relative loss error {loss_err:.3g} (tol "
          f"1e-4); parameters max abs err {worst} (tol {2 * lr:.3g}), share "
          f"of entries beyond 1e-6 {share} (tol 1e-3); K4 {card_k4} launches "
          f"on the card step", flush=True)
    if (errs["boxes"] > 1e-3 or errs["scores"] > 1e-4
            or errs["pseudo boxes"] > 1e-3 or loss_err > 1e-4
            or max(worst.values()) > 2 * lr or max(share.values()) > 1e-3):
        fail(f"{name}: card and CPU disagree")


def fmt(xs, digits=2):
    return ", ".join(f"{x:.{digits}f}" for x in xs)


def median(xs):
    return sorted(xs)[len(xs) // 2]

CONVNEXT_SIZES = {(96, 9): "T", (96, 27): "S", (128, 27): "B",
                  (192, 27): "L", (256, 27): "XL"}


def model_name(cfg):
    """"R50-FPN", "ConvNeXt-L", "ViTDet-B" or "YOLOv5-m" for the log
    lines, "Fast R-CNN " before it under MODEL.LOAD_PROPOSALS, " dense RPN"
    after it with the dense RPN loss and " align" when a discriminator is
    on."""
    name = cfg.MODEL.BACKBONE.NAME
    if cfg.MODEL.META_ARCHITECTURE == "DeformableDETR":
        dd = cfg.MODEL.DEFORMABLE_DETR
        return "Deformable DETR" + (" box refine" if dd.WITH_BOX_REFINE
                                    else "") + (" two-stage" if dd.TWO_STAGE
                                                else "")
    if cfg.MODEL.META_ARCHITECTURE == "Yolo":
        variant = cfg.MODEL.YAML.split("//")[-1].replace(".yaml", "")
        out = "YOLOv5-" + variant[len("yolov5"):]
    elif name.startswith("build_vitdet"):
        out = f"ViTDet-{name.split('_')[2].upper()}"
    elif name == "build_convnext_fpn_backbone":
        c = cfg.MODEL.CONVNEXT
        out = "ConvNeXt-" + CONVNEXT_SIZES.get(
            (c.DIMS[0], c.DEPTHS[2]), "tiny")
    else:
        out = f"R{cfg.MODEL.RESNETS.DEPTH}-FPN"
    if cfg.MODEL.LOAD_PROPOSALS:
        out = "Fast R-CNN " + out
    if cfg.TPU.RPN_LOSS_IMPL != "sampled":
        out += " dense RPN"
    a = cfg.DOMAIN_ADAPT.ALIGN
    return out + (" align" if a.IMG_DA_ENABLED or a.INS_DA_ENABLED else "")


def main():
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    if not os.path.isdir(os.path.join(ROOT, "aldi_tpu_torch")) or not all(
            os.path.exists(c) for c in (FLAGSHIP, VIT_ALDI, CONVNEXT_ALDI)):
        fail("run from a checkout of the repository: aldi_tpu_torch/ or a "
             "config is missing")
    sys.path.insert(0, ROOT)
    from aldi_tpu_torch.config import get_cfg
    from aldi_tpu_torch.models import build_detector
    from aldi_tpu_torch.ops import _build
    from aldi_tpu_torch.ops.flash_attn_kernel import (flash_attn_bwd,
                                                      flash_attn_fwd)
    from aldi_tpu_torch.ops.lapjv_kernel import lapjv
    from aldi_tpu_torch.ops.match_kernel import low_quality_mask, match_iou
    from aldi_tpu_torch.ops.roi_align_kernel import roi_align_bwd, roi_align_fwd

    flagship_kernels = [match_iou, low_quality_mask, roi_align_fwd,
                        roi_align_bwd]
    vit_kernels = flagship_kernels + [flash_attn_fwd, flash_attn_bwd]
    all_kernels = vit_kernels + [lapjv]  # K4 last
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    card = card[0] if card else "unknown"
    print(f"[card] {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)

    # -- 1. build every kernel from the checkout's sources
    t0 = time.perf_counter()
    libraries = sorted({k.library for k in all_kernels})
    logs = _build.build(libraries)
    print(f"[build] {len(logs)} of {len(libraries)} kernel libraries "
          f"({', '.join(libraries)}) compiled in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    # -- 1b. the host decoder on the card's host: the loaders' branch and
    # why; the core without codecs built, held bitwise against its plain
    # version and timed per image; the loaders timed on their branch
    decoder_phase(card)

    # -- 2. kernel phase at the main paths' shapes
    for dtype, seed in ((torch.float32, 11), (torch.bfloat16, 12)):
        feats, boxes, levels = synthetic_roi_inputs(dtype, seed)
        check_roi("flagship shapes, synthetic boxes", feats, boxes, levels)
        del feats, boxes, levels
    torch.cuda.empty_cache()
    cfg = get_cfg()
    cfg.merge_from_file(FLAGSHIP)
    anchors = build_detector(cfg).anchors_cat
    gen = torch.Generator(device="cuda").manual_seed(13)
    gt, _, gt_valid = synthetic_gt(gen, TRAIN_IMAGES, cfg.TPU.MAX_GT,
                                   (1024, 2048))
    numbers = check_match("kernel phase, synthetic gt", anchors, gt, gt_valid)
    check_match("worst case, every gt box covers the canvas", anchors,
                *covering_gt(gen, TRAIN_IMAGES, cfg.TPU.MAX_GT, (1024, 2048)),
                plain_iters=1)
    del anchors, gt, gt_valid
    for dtype, seed in ((torch.float32, 14), (torch.bfloat16, 15)):
        numbers["roi_align_bwd"] = check_roi_bwd(
            "training-step shapes, synthetic boxes",
            *roi_bwd_inputs(dtype, seed))
    # K3a/K3b: a tiny and a ragged grid, then one image's 12 heads of
    # ViTDet-B's global blocks at 1024x2048 (grid 64x128, N = 8192)
    for dtype in (torch.float32, torch.bfloat16):
        check_attn("tiny", dtype, 8, 8, 4, seed=21)
        check_attn("ragged", dtype, 50, 84, 2, seed=22)
    check_attn("ViTDet-B flagship shapes", torch.float32, *VIT_GRID,
               VIT_HEADS, seed=23, kernel_iters=2, plain_iters=1)
    numbers.update(check_attn("ViTDet-B flagship shapes", torch.bfloat16,
                              *VIT_GRID, VIT_HEADS, seed=24, kernel_iters=10,
                              plain_iters=1, library=True))
    # one launch of the training step: 4 images' heads (G = 48)
    check_attn("ViTDet-B step launch", torch.bfloat16, *VIT_GRID,
               4 * VIT_HEADS, seed=25, kernel_iters=5, plain_iters=1,
               library=True)
    # ViTDet-L's global blocks: one image's 16 heads (a request's launch)
    # and 4 images' (G = 64, a training step's launch), SDPA beside each
    t_vitl = time.perf_counter()
    vitl_attn = {
        "G=16 (one image, a request's launch)": check_attn(
            "ViTDet-L flagship shapes", torch.bfloat16, *VIT_GRID,
            VITL_HEADS, seed=27, kernel_iters=10, plain_iters=1,
            library=True),
        "G=64 (4 images, a step's launch)": check_attn(
            "ViTDet-L step launch", torch.bfloat16, *VIT_GRID,
            4 * VITL_HEADS, seed=28, kernel_iters=5, plain_iters=1,
            library=True)}
    print(f"[time] the ViTDet-L attention checks took "
          f"{time.perf_counter() - t_vitl:.1f} s", flush=True)
    # K4: the published 16 + 16 chunk's 96 problems (6 layers x 16 images)
    # of 100 gt rows x 300 queries, with deliberate ties
    k4_synthetic = check_lapjv(
        "synthetic with ties", *tied_lapjv_problems(
            torch.Generator(device="cuda").manual_seed(26), 96, 100, 300))
    # and its shape cases: m not a multiple of 32, n = m, costs too large
    # for shared memory, no rows, signed zeros, the block kernel (m > 512)
    k4_cases = check_lapjv_cases()
    torch.cuda.empty_cache()

    # -- 3. serving phase: each detector through its entry points (K2 on
    # ConvNeXt-L's real proposals too, its numbers kept out of the line)
    serving_launches = {
        "R50-FPN": serving_phase(card, FLAGSHIP, [roi_align_fwd], numbers),
        "ViTDet-B": serving_phase(card, VIT_ALDI,
                                  [roi_align_fwd, flash_attn_fwd]),
        "ConvNeXt-L": serving_phase(card, CONVNEXT_ALDI, [roi_align_fwd],
                                    {})}
    t_new = time.perf_counter()
    serving_launches["ViTDet-L"] = serving_phase(
        card, VITL_ALDI, [roi_align_fwd, flash_attn_fwd])
    print(f"[time] the ViTDet-L serving phase took "
          f"{time.perf_counter() - t_new:.1f} s", flush=True)
    t_new = time.perf_counter()
    fast_rcnn_serving, fast_rcnn_roi = fast_rcnn_serving_phase(
        card, flagship_kernels)
    print(f"[time] the Fast R-CNN serving phase took "
          f"{time.perf_counter() - t_new:.1f} s", flush=True)
    tiny_reference_check()
    with tiny_vit():
        tiny_reference_check(VIT_ALDI)
    tiny_reference_check(CONVNEXT_ALDI)

    # -- 4. artifact phase: each detector exported, saved, loaded, served
    artifact_launches = {
        "R50-FPN": artifact_phase(card, FLAGSHIP, [roi_align_fwd],
                                  {"roi_align_fwd": 1}),
        "ViTDet-B": artifact_phase(card, VIT_ALDI,
                                   [roi_align_fwd, flash_attn_fwd],
                                   {"roi_align_fwd": 1, "flash_attn_fwd": 4})}
    tiny_artifact_check()

    # -- 5. training phase: each DAOD step through its entry points. Per
    # step: K1a/K1b 3 (the teacher's distill anchors, the strong and the
    # distill streams' RPN losses); K2 forward 4 (the teacher's proposals,
    # the strong and distill streams' ROIs, the teacher's head on the
    # distill ROIs) and backward 2; with alignment, the target_weak
    # stream's box head adds one of each
    per_step = {"match_iou": 3, "low_quality_mask": 3, "roi_align_fwd": 4,
                "roi_align_bwd": 2}
    launches, step_kernels, _ = training_phase(card, flagship_kernels,
                                               per_step=per_step)
    torch.cuda.empty_cache()
    tiny_train_reference_check()
    vit_launches, vit_step_kernels, _ = training_phase(
        card, vit_kernels, VIT_ALDI, per_step={
            **per_step, "flash_attn_fwd": 20, "flash_attn_bwd": 8})
    torch.cuda.empty_cache()
    with tiny_vit():
        tiny_train_reference_check(VIT_ALDI)
    convnext_launches, convnext_step_kernels, _ = training_phase(
        card, flagship_kernels, CONVNEXT_ALDI, per_step=per_step)
    torch.cuda.empty_cache()
    tiny_train_reference_check(CONVNEXT_ALDI)
    align_launches, align_step_kernels, _ = training_phase(
        card, flagship_kernels, FLAGSHIP, ALIGN, per_step={
            **per_step, "roi_align_fwd": 5, "roi_align_bwd": 3})
    torch.cuda.empty_cache()
    tiny_train_reference_check(FLAGSHIP, ALIGN)
    # the dense RPN loss (TPU.RPN_LOSS_IMPL "dense"): the same launches
    t_new = time.perf_counter()
    dense_launches, dense_step_kernels, _ = training_phase(
        card, flagship_kernels, FLAGSHIP, DENSE_RPN, per_step=per_step)
    torch.cuda.empty_cache()
    tiny_train_reference_check(FLAGSHIP, DENSE_RPN)
    print(f"[time] the dense RPN phase took "
          f"{time.perf_counter() - t_new:.1f} s", flush=True)
    # Fast R-CNN (MODEL.LOAD_PROPOSALS): the labeled_strong stream's ROIs
    # on the proposals, K2 forward and backward once per step, no K1
    t_new = time.perf_counter()
    fast_rcnn_launches, fast_rcnn_step_kernels, _ = training_phase(
        card, [roi_align_fwd, roi_align_bwd], FAST_RCNN, FAST_RCNN_ON,
        per_step={"roi_align_fwd": 1, "roi_align_bwd": 1},
        absent=[match_iou, low_quality_mask])
    fast_rcnn_launches.update(match_iou=0, low_quality_mask=0)
    torch.cuda.empty_cache()
    print(f"[time] the Fast R-CNN training phase took "
          f"{time.perf_counter() - t_new:.1f} s", flush=True)
    # ViTDet-L: the same launches as ViTDet-B (4 global blocks), K3a/K3b
    # at G = 64 per step launch
    t_new = time.perf_counter()
    vitl_launches, vitl_step_kernels, _ = training_phase(
        card, vit_kernels, VITL_ALDI, per_step={
            **per_step, "flash_attn_fwd": 20, "flash_attn_bwd": 8})
    torch.cuda.empty_cache()
    print(f"[time] the ViTDet-L training phase took "
          f"{time.perf_counter() - t_new:.1f} s", flush=True)

    # -- 6. trainer phase: the training CLI at the published batch; then,
    # on its splits and reference weights, Fast R-CNN through the CLI and
    # the three user tools
    extra = {}

    def on_trainer_data(data):
        t_new = time.perf_counter()
        extra["fast_rcnn"] = fast_rcnn_trainer(card, flagship_kernels, data)
        print(f"[time] the Fast R-CNN trainer phase took "
              f"{time.perf_counter() - t_new:.1f} s", flush=True)
        t_new = time.perf_counter()
        tools_phase(card, data)
        print(f"[time] the tools phase took "
              f"{time.perf_counter() - t_new:.1f} s", flush=True)

    trainer_launches, eval_launches, recorded = trainer_phase(
        card, flagship_kernels, then=on_trainer_data)
    # K1 and K2 held against their plain versions at the trainer's first
    # step's own launches (24 + 24 images)
    trainer_kernels = time_step_launches("R50-FPN trainer", recorded)
    del recorded
    torch.cuda.empty_cache()

    # -- 7. data parallel: a world-1 NCCL group (bitwise the step without
    # one), world 2 on this card (two gloo ranks) against world 1, and the
    # trainer at world 2
    dp_launches, _ = dp_phase(card)

    # -- 7b. the data x model grid: tensor parallelism at M = 2 (the
    # flagship, ViTDet-B with K3a/K3b at G = 12) and FSDP at D = 2
    # (ViTDet-L), two gloo ranks on this card against world 1
    grid_launches, grid_attn = grid_phase(card)

    # -- 8. YOLOv5-m: serving, the DAOD step (and with image-level
    # alignment, and once at the published chunk of 12 + 12), the artifact
    # and the tiny card-vs-CPU step. None of the six kernels is on its
    # paths: each path must launch none
    yolo_launches = {"YOLOv5-m serving": yolo_serving_phase(card,
                                                           all_kernels)}
    yolo_launches["YOLOv5-m training"] = yolo_training_phase(
        card, all_kernels)[0]
    yolo_launches["YOLOv5-m align training"] = yolo_training_phase(
        card, all_kernels, YOLO_ALIGN)[0]
    yolo_training_phase(card, all_kernels, n=YOLO_PUBLISHED_CHUNK, timed=0,
                        label="YOLOv5-m at the published SOLVER.IMS_PER_GPU")
    yolo_launches["YOLOv5-m artifact"] = artifact_phase(
        card, YOLO_ALDI, all_kernels, {})
    tiny_yolo_train_reference_check()

    # -- 9. Deformable DETR: serving, the DAOD step (and once at the
    # published chunk of 16 + 16), K4 at the warm-up step's own launches,
    # the artifact and the tiny card-vs-CPU detectors and steps. K4 is the
    # only kernel of its paths: twice per step, never per request
    t_detr = time.perf_counter()
    detr_launches = {"Deformable DETR serving": detr_serving_phase(
        card, all_kernels)}
    detr_train, _, _, k4_records = detr_training_phase(card, all_kernels)
    detr_launches["Deformable DETR training"] = detr_train
    accum, chunk_ms, chunk_peak = detr_published_chunk(card, all_kernels)
    print(f"[train] Deformable DETR at the published 16 + 16: "
          f"TPU.GRAD_ACCUM {accum}, one cold step {chunk_ms:.1f} ms, peak "
          f"{chunk_peak:.2f} GiB; card {card}", flush=True)
    k4_steps = [check_lapjv(f"Deformable DETR step launch {i + 1}", cost,
                            n_rows, kernel_iters=10)
                for i, (cost, n_rows) in enumerate(k4_records)]
    del k4_records
    detr_launches["Deformable DETR artifact"] = artifact_phase(
        card, DETR_ALDI, all_kernels, {})
    tiny_detr_reference_check(lapjv)
    tiny_detr_reference_check(lapjv, DETR_TWO_STAGE)
    print(f"[time] the Deformable DETR phase took "
          f"{time.perf_counter() - t_detr:.1f} s", flush=True)

    # -- 10. result lines. ``launches``: K1/K2 from the flagship's timed
    # training steps, K3a/K3b from ViTDet-B's; ``launches_by_path`` has
    # every path's count (K2's forward and K3a also serve). The other
    # numbers: the kernel phase's, at the paths' shapes (K2's forward on a
    # flagship request's proposals; K3a/K3b on one image's heads in bf16)
    launches.update({k: vit_launches[k] for k in ("flash_attn_fwd",
                                                  "flash_attn_bwd")})
    by_path = {"R50-FPN training": {k.name: launches[k.name]
                                    for k in flagship_kernels},
               "ViTDet-B training": vit_launches,
               "ConvNeXt-L training": convnext_launches,
               "R50-FPN align training": align_launches,
               "R50-FPN trainer": trainer_launches,
               "R50-FPN eval": {"roi_align_fwd":
                                eval_launches["roi_align_fwd"]},
               **{f"R50-FPN world 2 training, rank {r} (2 steps)": c
                  for r, c in enumerate(dp_launches)},
               "R50-FPN dense RPN training": dense_launches,
               "Fast R-CNN training": fast_rcnn_launches,
               "Fast R-CNN serving": fast_rcnn_serving,
               "Fast R-CNN trainer": extra["fast_rcnn"][0],
               "Fast R-CNN trainer eval": extra["fast_rcnn"][1],
               "ViTDet-L training": vitl_launches,
               **grid_launches,
        **{f"{m} serving": v for m, v in serving_launches.items()},
        **{f"{m} artifact": v for m, v in artifact_launches.items()},
        **yolo_launches, **detr_launches}
    print(f"[time] the whole run took {time.perf_counter() - t_start:.1f} "
          "s", flush=True)
    print(f"[card] {card}")
    entries = []
    for k in vit_kernels:
        entry = {"name": k.name, "route": "cuda", "source": k.source,
                 "replaces": k.replaces, "launches": launches[k.name],
                 "library_ms": None, **numbers[k.name]}
        entry["launches_by_path"] = {path: c[k.name]
                                     for path, c in by_path.items()
                                     if k.name in c}
        kind = {"roi_align_fwd": "forward", "roi_align_bwd": "backward",
                "match_iou": "match", "low_quality_mask": "match"}.get(k.name)
        if kind:  # K2 and K1 at each training step's own launches
            keys = ("ms", "bound_ms", "plain_ms", "max_abs_err")
            entry["step_launches"] = {
                path: [
                    {"boxes": r["boxes"], **{key: r[key] for key in keys}}
                    if kind != "match" else
                    {"site": r["site"], "valid_gt": r["valid_gt"],
                     **{key: r[k.name][key]
                        for key in keys + ("kernel_ms", "dense_bound_ms")}}
                    for r in rs if r["kind"] == kind]
                for path, rs in (("R50-FPN training", step_kernels),
                                 ("ViTDet-B training", vit_step_kernels),
                                 ("ConvNeXt-L training",
                                  convnext_step_kernels),
                                 ("R50-FPN align training",
                                  align_step_kernels),
                                 ("R50-FPN trainer", trainer_kernels),
                                 ("R50-FPN dense RPN training",
                                  dense_step_kernels),
                                 ("Fast R-CNN training",
                                  fast_rcnn_step_kernels),
                                 ("ViTDet-L training", vitl_step_kernels))}
        if k.name == "roi_align_fwd":
            entry["fast_rcnn_request"] = fast_rcnn_roi
        if k.name in ("flash_attn_fwd", "flash_attn_bwd"):
            entry["vitdet_l"] = {g: n[k.name] for g, n in vitl_attn.items()}
            entry["vitdet_b_m2"] = {"G": GRID_IMAGES * VIT_HEADS // 2,
                                    **grid_attn[k.name]}
        entries.append(entry)
    # K4: launches from the DETR training steps; the numbers of the warm-up
    # step's first launch (the labeled_strong stream's 24 problems)
    keys = ("ms", "kernel_ms", "plain_ms", "scipy_ms", "bound_ms",
            "max_abs_err", "settles_mean", "settles_max", "ns_per_settle",
            "kernel", "problems")
    entries.append({
        "name": lapjv.name, "route": "cuda", "source": lapjv.source,
        "replaces": lapjv.replaces, "launches": detr_train["lapjv"],
        "library_ms": None, **k4_steps[0],
        "launches_by_path": {path: c["lapjv"] for path, c in by_path.items()
                             if "lapjv" in c},
        "step_launches": {"Deformable DETR training": [
            {key: r[key] for key in keys} for r in k4_steps]},
        "synthetic_tied": {key: k4_synthetic[key] for key in keys},
        "cases": {label: {key: r[key] for key in keys}
                  for label, r in k4_cases.items()}})
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    try:
        main()
    except SystemExit:
        raise
    except Exception:  # any phase that raised fails the run
        traceback.print_exc()
        fail("a phase raised")
