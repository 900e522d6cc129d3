"""The port's random draws, derived from a JAX key by the JAX package's own
splits, so a port function and its JAX counterpart sample the same sets.

Each function mirrors the key splits of one JAX consumer and returns the
draws, as torch tensors, in the layout the port's function takes:
``aldi_tpu/ops/matcher.py:116-141`` (``subsample_indices``) and ``:154-199``
(``subsample_labels``), ``:211`` (``sample_fixed_indices``),
``aldi_tpu/models/rpn.py:179-201`` (``label_anchors_sampled``) and
``:64-116`` (``label_anchors``, the dense loss's),
``aldi_tpu/models/roi_heads.py:98-123`` (``sample_proposals``),
``aldi_tpu/models/rcnn.py:410`` (``forward_train``),
``aldi_tpu/data/strong_aug.py:43-157`` (``strong_augment``),
``aldi_tpu/engine/train_step.py:137-194,331`` (the step's keys),
``aldi_tpu/models/rcnn.py:662-691`` (``forward_domain_align``),
``aldi_tpu/models/vit.py:197-203`` and ``aldi_tpu/models/convnext.py:45-50``
(drop path). It uses JAX only and changes nothing in ``aldi_tpu``: the
drop-path masks, which flax derives from the module path, are captured
from a run of the JAX backbone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from aldi_tpu.data.strong_aug import ERASE_PASSES


def _t(x):
    return torch.from_numpy(np.array(x))


def _stack(dicts):
    return {k: torch.stack([d[k] for d in dicts]) for k in dicts[0]}


def _keys30(key, n):
    return _t((jax.random.bits(key, (n,), jnp.uint32) >> 2).astype(jnp.int32))


def subsample_indices_draws(key, n, num_samples, positive_fraction):
    """One image's draws of ``matcher.subsample_indices(key, labels [n])``."""
    kp, kn, kt = jax.random.split(key, 3)
    k_pos = min(max(int(num_samples * positive_fraction), 1), n)
    k_neg = min(num_samples, n)
    return {"pos_keys": _keys30(kp, n), "neg_keys": _keys30(kn, n),
            "tie": _t(jax.random.uniform(kt, (k_pos + k_neg,)))}


def subsample_labels_draws(key, n):
    """One image's draws of ``matcher.subsample_labels(key, labels [n])``."""
    kp, kn = jax.random.split(key)
    return {"pos_keys": _keys30(kp, n), "neg_keys": _keys30(kn, n)}


def label_anchors_draws(key, batch, n, batch_size_per_image,
                        positive_fraction):
    """``rpn.label_anchors_sampled(key, anchors [n], gt [batch])``."""
    k = min(batch_size_per_image, n)
    out = []
    for ks in jax.random.split(key, batch):
        k_sub, _ = jax.random.split(ks)
        out.append(subsample_indices_draws(jax.random.fold_in(k_sub, 0), n,
                                           k, positive_fraction))
    return _stack(out)


def label_anchors_dense_draws(key, batch, n):
    """``rpn.label_anchors(key, anchors [n], gt [batch])`` (the dense RPN
    loss): one key per image from ``split(key, batch)``, straight into
    ``subsample_labels``."""
    return _stack([subsample_labels_draws(k, n)
                   for k in jax.random.split(key, batch)])


def sample_proposals_draws(key, batch, n):
    """``roi_heads.sample_proposals(key, ...)`` over n candidates (with the
    appended gt)."""
    out = []
    for k in jax.random.split(key, batch):
        k_sub, k_idx = jax.random.split(k)
        d = subsample_labels_draws(k_sub, n)
        d["fill"] = _t(jax.random.uniform(k_idx, (n,)))
        out.append(d)
    return _stack(out)


def _recorded_bernoullis(jdet, variables, k_drop, batch, module):
    """Each mask that ``jax.random.bernoulli`` draws while ``module`` (the
    JAX detector's module, or a clone) runs its backbone un-jitted on zero
    images in training mode with the dropout key ``k_drop``, flattened, in
    call order."""
    from aldi_tpu.models.rcnn import RCNN

    recorded = []
    real = jax.random.bernoulli

    def bernoulli(key, p, shape):
        mask = real(key, p, shape)
        recorded.append(np.asarray(mask).reshape(-1))
        return mask

    x = jnp.zeros((batch, *jdet.canvas, 3), jdet.dtype)
    jax.random.bernoulli = bernoulli
    try:
        module.apply(variables, x, True, method=RCNN.backbone_fwd,
                     rngs={"dropout": k_drop})
    finally:
        jax.random.bernoulli = real
    return recorded


def convnext_drop_masks(jdet, variables, k_drop, batch):
    """The keep masks [sum(depths), batch] (bool) that the JAX detector's
    ConvNeXt draws in ``backbone(variables, x, train=True, rng=k_drop)``:
    one per block with a non-zero rate, in block order; blocks of rate 0
    keep everything."""
    c = jdet.cfg.MODEL.CONVNEXT
    total, rate = sum(c.DEPTHS), c.DROP_PATH_RATE
    it = iter(_recorded_bernoullis(jdet, variables, k_drop, batch,
                                   jdet.module))
    masks = np.ones((total, batch), bool)
    for i in range(total):
        if rate * i / max(total - 1, 1) > 0:
            masks[i] = next(it)
    assert next(it, None) is None
    return _t(masks)


def vit_drop_masks(jdet, variables, k_drop, batch):
    """The keep masks [2, depth, batch] (bool) that the JAX detector's ViT
    draws in ``backbone(variables, x, train=True, rng=k_drop)``: its
    backbone runs un-jitted and without remat (flax derives the same keys
    with it) on zero images, with ``jax.random.bernoulli`` recording each
    mask in call order (per block with a non-zero rate: attention, then
    MLP). Blocks of rate 0 keep everything."""
    from aldi_tpu.models import vit

    cfg = vit.VIT_CONFIGS[jdet.cfg.MODEL.BACKBONE.NAME.split("_")[2]]
    depth, rate = cfg["depth"], cfg["drop_path_rate"]
    recorded = _recorded_bernoullis(
        jdet, variables, k_drop, batch,
        jdet.module.clone(use_act_checkpoint=False))
    masks = np.ones((2, depth, batch), bool)
    it = iter(recorded)
    for i in range(depth):
        if rate * i / max(depth - 1, 1) > 0:
            masks[0, i], masks[1, i] = next(it), next(it)
    assert next(it, None) is None
    return _t(masks)


def forward_train_draws(rng, cfg, batch, n_anchors, drop_masks=None):
    """``RCNNDetector.forward_train(..., rng)``: the RPN and ROI samplers'
    draws, and with ``drop_masks`` (``functools.partial(vit_drop_masks,
    jdet, variables)`` or ``convnext_drop_masks``) the trunk's drop-path
    masks. The RPN's are those of TPU.RPN_LOSS_IMPL's loss; under
    MODEL.LOAD_PROPOSALS there are none, and the ROI sampler's candidates
    are the file's top PRECOMPUTED_PROPOSAL_TOPK_TRAIN and the gt."""
    k_rpn, k_roi, k_drop = jax.random.split(rng, 3)
    rpn = cfg.MODEL.RPN
    if cfg.MODEL.LOAD_PROPOSALS:
        n_cand = cfg.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TRAIN + cfg.TPU.MAX_GT
        out = {}
    else:
        n_cand = rpn.POST_NMS_TOPK_TRAIN + cfg.TPU.MAX_GT
        out = {"rpn": label_anchors_draws(
            k_rpn, batch, n_anchors, rpn.BATCH_SIZE_PER_IMAGE,
            rpn.POSITIVE_FRACTION) if cfg.TPU.RPN_LOSS_IMPL == "sampled"
            else label_anchors_dense_draws(k_rpn, batch, n_anchors)}
    out["roi"] = sample_proposals_draws(k_roi, batch, n_cand)
    if drop_masks is not None:
        out["drop"] = drop_masks(k_drop, batch)
    return out


def domain_align_draws(rng, cfg, batch, drop_masks=None):
    """``RCNNDetector.forward_domain_align(..., rng)``: with instance
    alignment the ROI sampler's draws over the train proposals and one
    empty gt slot, and with ``drop_masks`` the trunk's masks."""
    rng, k_drop = jax.random.split(rng)
    out = {}
    if cfg.DOMAIN_ADAPT.ALIGN.INS_DA_ENABLED:
        n = cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN + int(
            cfg.MODEL.ROI_HEADS.PROPOSAL_APPEND_GT)
        out["roi"] = sample_proposals_draws(rng, batch, n)
    if drop_masks is not None:
        out["drop"] = drop_masks(k_drop, batch)
    return out


def strong_aug_draws(key, batch, canvas, include_erasing=True, mic=False,
                     mic_block_size=32):
    """``strong_aug.strong_augment(key, images [batch, *canvas, 3], ...)``."""
    per = []
    for k in jax.random.split(key, batch):
        k1, k2, k3, k4 = jax.random.split(k, 4)
        kj = jax.random.split(k1, 6)
        d = {"do_jitter": jax.random.uniform(kj[0]) < 0.8,
             "do_gray": jax.random.uniform(kj[1]) < 0.2,
             "factors": jnp.stack([jax.random.uniform(
                 kj[i], minval=0.6, maxval=1.4) for i in (2, 3, 4)])}
        kb1, kb2 = jax.random.split(k2)
        d["do_blur"] = jax.random.uniform(kb1) < 0.5
        d["sigma"] = jax.random.uniform(kb2, minval=0.1, maxval=2.0)
        if include_erasing:
            ke = jax.random.split(k3, len(ERASE_PASSES) + 1)
            d["erase_noise"] = jax.random.uniform(ke[-1], (*canvas, 3)) * 255.0
            cols = {n: [] for n in ("do_erase", "erase_area", "erase_aspect",
                                    "erase_y", "erase_x")}
            for (sl, sh, r1, r2, prob), kk in zip(ERASE_PASSES, ke[:-1]):
                ks = jax.random.split(kk, 5)
                cols["do_erase"].append(jax.random.uniform(ks[0]) < prob)
                cols["erase_area"].append(
                    jax.random.uniform(ks[1], minval=sl, maxval=sh))
                cols["erase_aspect"].append(
                    jax.random.uniform(ks[2], minval=r1, maxval=r2))
                cols["erase_y"].append(jax.random.uniform(ks[3]))
                cols["erase_x"].append(jax.random.uniform(ks[4]))
            d.update({n: jnp.stack(v) for n, v in cols.items()})
        if mic:
            h, w = canvas
            grid = (max(1, round(h / mic_block_size)),
                    max(1, round(w / mic_block_size)))
            d["mic_u"] = jax.random.uniform(k4, grid)
        per.append({n: _t(v) for n, v in d.items()})
    return _stack(per)


def train_step_draws(rng, cfg, n_labeled, n_unlabeled, n_anchors,
                     drop_masks=None):
    """Every draw of ``make_train_step(...)(state, batch, rng)`` for the
    labeled_strong + distill composition of the flagship, and the
    target_weak stream's (``"align"``) when DOMAIN_ADAPT.ALIGN is on, keyed
    as the port's ``draw_step`` keys them (``drop_masks``: see
    ``forward_train_draws``). With ``TPU.GRAD_ACCUM = k > 1`` the student
    streams' entries are lists of k chunks' draws, from the keys
    ``split(fold_in(keys[7], i), 4)`` of chunk i
    (``aldi_tpu/engine/train_step.py:354-356``)."""
    keys = jax.random.split(rng, 10)
    aug = cfg.AUG
    rpn = cfg.MODEL.RPN
    canvas = tuple(cfg.TPU.CANVAS)
    accum = max(int(cfg.TPU.GRAD_ACCUM), 1)
    a = cfg.DOMAIN_ADAPT.ALIGN
    align = a.IMG_DA_ENABLED or a.INS_DA_ENABLED
    if accum == 1:
        students = {
            "strong": forward_train_draws(keys[4], cfg, n_labeled, n_anchors,
                                          drop_masks),
            "distill": forward_train_draws(keys[6], cfg, n_unlabeled,
                                           n_anchors, drop_masks)}
        if align:
            students["align"] = domain_align_draws(keys[5], cfg, n_unlabeled,
                                                   drop_masks)
    else:
        chunk_keys = [jax.random.split(jax.random.fold_in(keys[7], i), 4)
                      for i in range(accum)]
        students = {
            "strong": [forward_train_draws(k[1], cfg, n_labeled // accum,
                                           n_anchors, drop_masks)
                       for k in chunk_keys],
            "distill": [forward_train_draws(k[3], cfg, n_unlabeled // accum,
                                            n_anchors, drop_masks)
                        for k in chunk_keys]}
        if align:
            students["align"] = [domain_align_draws(
                k[2], cfg, n_unlabeled // accum, drop_masks)
                for k in chunk_keys]
    return {
        "teacher": label_anchors_draws(keys[0], n_unlabeled, n_anchors,
                                       rpn.BATCH_SIZE_PER_IMAGE,
                                       rpn.POSITIVE_FRACTION),
        "aug_labeled": strong_aug_draws(
            keys[1], n_labeled, canvas, aug.LABELED_INCLUDE_RANDOM_ERASING,
            aug.LABELED_MIC_AUG, aug.MIC_BLOCK_SIZE),
        "aug_unlabeled": strong_aug_draws(
            keys[2], n_unlabeled, canvas,
            aug.UNLABELED_INCLUDE_RANDOM_ERASING, aug.UNLABELED_MIC_AUG,
            aug.MIC_BLOCK_SIZE),
        **students,
    }
