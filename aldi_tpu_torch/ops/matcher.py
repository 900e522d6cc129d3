"""Anchor/proposal matching and balanced subsampling.

Port of ``aldi_tpu/ops/matcher.py``, batched over leading dims. The JAX
functions draw from ``jax.random`` keys, which PyTorch cannot reproduce, so
every sampler here takes its draws as tensors: 30-bit integer keys that
rank the candidates of a mask (smallest first), and uniforms in [0, 1)
that break the final ordering. ``*_draws`` make them from a
``torch.Generator``; the parity tests hand in the JAX package's own draws.

Selections keep ``lax.top_k``'s order on ties (the lower index first), so a
set of draws picks the same indices in both packages and on any device.
"""

from typing import Sequence, Tuple

import torch

from .nms import top_k

KEY_BITS = 30  # the JAX samplers rank by (32-bit random bits) >> 2
_BIG = 0x7FFFFFFF  # sentinel above every key: "not in the mask"


def match(iou: torch.Tensor, gt_valid: torch.Tensor,
          thresholds: Sequence[float], labels: Sequence[int],
          allow_low_quality: bool = False) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """Match N predictions to M (padded) ground-truth boxes.

    iou [..., N, M]; gt_valid [..., M]. Returns (matched_idx [..., N] int32,
    the first argmax over valid gt; match_labels [..., N] int8). An invalid
    gt column scores -1, so with no valid gt every label is ``labels[0]``.
    ``allow_low_quality`` also marks, for each valid gt, every prediction
    that reaches its best IoU (> 0) as 1.
    """
    iou = torch.where(gt_valid[..., None, :], iou,
                      torch.full((), -1.0, dtype=iou.dtype,
                                 device=iou.device))
    matched_vals = iou.amax(dim=-1)
    matched_idx = iou.argmax(dim=-1).to(torch.int32)
    out = torch.full(matched_vals.shape, labels[0], dtype=torch.int8,
                     device=iou.device)
    for lo, lab in zip(thresholds, labels[1:]):
        out = torch.where(matched_vals >= lo,
                          torch.full_like(out, lab), out)
    if allow_low_quality:
        best = iou.amax(dim=-2, keepdim=True)  # [..., 1, M]
        is_best = (iou == best) & gt_valid[..., None, :] & (best > 0)
        out = torch.where(is_best.any(dim=-1), torch.ones_like(out), out)
    return matched_idx, out


def topk_smallest_with_idx(vals: torch.Tensor, k: int):
    """(values, indices) of the k smallest integer keys along the last dim,
    in ascending order, the lower index first among equal values (as
    ``lax.top_k`` orders them): one ``torch.topk`` on (value, index) packed
    into int64. The JAX package's segmented two-stage top-k is a TPU speed
    device with the same result."""
    n = vals.shape[-1]
    k = min(k, n)
    pos = torch.arange(n, dtype=torch.int64, device=vals.device)
    packed = (vals.to(torch.int64) << 32) | pos
    top = torch.topk(packed, k, dim=-1, largest=False, sorted=True).values
    return (top >> 32).to(vals.dtype), top & 0xFFFFFFFF


def subsample_indices(labels: torch.Tensor, num_samples: int,
                      positive_fraction: float, bg_label: int,
                      draws: dict):
    """``subsample_labels`` + index extraction in one pass.

    labels [..., N] int (-1 ignore, ``bg_label`` negative, else positive);
    draws from ``subsample_indices_draws``: ``pos_keys``/``neg_keys``
    [..., N] rank the positives and negatives, ``tie`` [..., Kp + Kn]
    orders the candidates. Returns (indices [..., num_samples] int64,
    valid, is_pos), positives first.
    """
    n = labels.shape[-1]
    dev = labels.device
    pos_mask = (labels != -1) & (labels != bg_label)
    neg_mask = labels == bg_label
    # D2 semantics: the positive cap int(num * frac) may be 0; the top-k
    # width stays >= 1 and the count enforces the cap
    num_pos_cap = int(num_samples * positive_fraction)
    num_pos_max = max(num_pos_cap, 1)
    num_pos = pos_mask.sum(-1, keepdim=True).clamp(max=num_pos_cap)
    num_neg = torch.minimum(neg_mask.sum(-1, keepdim=True),
                            num_samples - num_pos)

    def pick(keys, mask, k_max, count):
        k_eff = min(k_max, n)
        masked = torch.where(mask, keys, torch.full_like(keys, _BIG))
        vals, idx = topk_smallest_with_idx(masked, k_eff)
        ok = (torch.arange(k_eff, device=dev) < count) & (vals < _BIG)
        return idx, ok

    ipos, vpos = pick(draws["pos_keys"], pos_mask, num_pos_max, num_pos)
    ineg, vneg = pick(draws["neg_keys"], neg_mask, num_samples, num_neg)
    cand_idx = torch.cat([ipos, ineg], -1)
    cand_pos = torch.cat([vpos, torch.zeros_like(vneg)], -1)
    cand_ok = torch.cat([vpos, vneg], -1)
    score = (cand_pos.to(torch.float32) * 4.0
             + cand_ok.to(torch.float32) * 2.0 + draws["tie"])
    k_fin = min(num_samples, cand_idx.shape[-1])
    svals, order = top_k(score, k_fin)
    out_idx = torch.gather(cand_idx, -1, order)
    out_ok, out_pos = svals >= 2.0, svals >= 4.0
    pad = num_samples - k_fin
    if pad:  # degenerate tiny inputs: an invalid tail
        out_idx = torch.nn.functional.pad(out_idx, (0, pad))
        out_ok = torch.nn.functional.pad(out_ok, (0, pad))
        out_pos = torch.nn.functional.pad(out_pos, (0, pad))
    return out_idx, out_ok, out_pos


def _sample_k_of_mask(keys, mask, k, k_max: int):
    """Keep the ``k`` (a [..., 1] count, <= k_max) True elements of ``mask``
    whose keys are smallest."""
    masked = torch.where(mask, keys, torch.full_like(keys, _BIG))
    k_max = max(min(k_max, mask.shape[-1]), 1)
    vals, idx = topk_smallest_with_idx(masked, k_max)
    select = (torch.arange(k_max, device=mask.device) < k) & (vals < _BIG)
    keep = torch.zeros_like(mask).scatter(-1, idx, select)
    return keep & (k > 0)


def subsample_labels(labels: torch.Tensor, num_samples: int,
                     positive_fraction: float, bg_label: int, draws: dict):
    """Keep at most ``num_samples`` elements, split positive/negative, as
    the substrate's ``subsample_labels``: min(#pos, num*frac) positives,
    the rest (capped by #neg) negatives, chosen by the smallest
    ``draws["pos_keys"]``/``draws["neg_keys"]``. Returns (sampled_pos,
    sampled_neg) masks [..., N]."""
    pos_mask = (labels != -1) & (labels != bg_label)
    neg_mask = labels == bg_label
    num_pos_max = int(num_samples * positive_fraction)
    num_pos = pos_mask.sum(-1, keepdim=True).clamp(max=num_pos_max)
    num_neg = torch.minimum(neg_mask.sum(-1, keepdim=True),
                            num_samples - num_pos)
    return (_sample_k_of_mask(draws["pos_keys"], pos_mask, num_pos,
                              num_pos_max),
            _sample_k_of_mask(draws["neg_keys"], neg_mask, num_neg,
                              num_samples))


def sample_fixed_indices(sampled_pos: torch.Tensor,
                         sampled_neg: torch.Tensor, k: int,
                         fill: torch.Tensor):
    """Pos/neg sample masks [..., N] -> exactly k indices, positives first,
    ordered within each group by the uniforms ``fill`` [..., N]. Returns
    (indices [..., k] int64, valid, is_pos); a short sample leaves an
    invalid tail."""
    score = (sampled_pos.to(torch.float32) * 4.0
             + sampled_neg.to(torch.float32) * 2.0 + fill)
    vals, idx = top_k(score, k)
    return idx, vals >= 2.0, vals >= 4.0


def _keys(gen, shape):
    return torch.randint(0, 1 << KEY_BITS, shape, generator=gen,
                         dtype=torch.int32, device=gen.device)


def subsample_indices_draws(gen: torch.Generator, lead: tuple, n: int,
                            num_samples: int, positive_fraction: float):
    """The draws ``subsample_indices`` takes for labels [*lead, n]."""
    k_pos = min(max(int(num_samples * positive_fraction), 1), n)
    k_neg = min(num_samples, n)
    return {"pos_keys": _keys(gen, (*lead, n)),
            "neg_keys": _keys(gen, (*lead, n)),
            "tie": torch.rand((*lead, k_pos + k_neg), generator=gen,
                              device=gen.device)}


def sample_proposals_draws(gen: torch.Generator, lead: tuple, n: int):
    """The draws ``subsample_labels`` + ``sample_fixed_indices`` take for
    [*lead, n] candidates."""
    return {"pos_keys": _keys(gen, (*lead, n)),
            "neg_keys": _keys(gen, (*lead, n)),
            "fill": torch.rand((*lead, n), generator=gen, device=gen.device)}
