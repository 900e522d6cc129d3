"""Feature Pyramid Network (lateral + top-down + extra max-pool level).

Port of ``aldi_tpu/models/fpn.py``: 1x1 lateral convs, nearest 2x top-down
upsampling with sum fusion, 3x3 output convs, and p6 = max_pool(1, stride 2)
of p5. Like detectron2's FPN backbone it wraps the bottom-up net, so its
names are ``backbone.bottom_up.*``, ``backbone.fpn_lateral{i}`` and
``backbone.fpn_output{i}``. Each conv's bias, and a lateral's top-down add,
run in the epilogue kernel where it takes them (``Conv2d.forward_fused``).
"""

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d


class FPN(nn.Module):
    def __init__(self, bottom_up, in_features=("res2", "res3", "res4", "res5"),
                 out_channels=256, compute_dtype=torch.float32):
        super().__init__()
        self.bottom_up = bottom_up
        self.in_features = list(in_features)
        for i, name in enumerate(self.in_features):
            cin = bottom_up.out_channels[name]
            self.add_module(f"fpn_lateral{i + 2}", Conv2d(
                cin, out_channels, 1, compute_dtype=compute_dtype))
            self.add_module(f"fpn_output{i + 2}", Conv2d(
                out_channels, out_channels, 3, padding=1,
                compute_dtype=compute_dtype))

    def keep_rates(self):
        """The bottom-up net's drop-path keep rates (None: it has no drop
        path)."""
        rates = getattr(self.bottom_up, "keep_rates", None)
        return rates() if rates else None

    def forward(self, x, drop=None):
        """x NCHW -> [p2, ..., p6] NCHW, finest first. ``drop``: the
        bottom-up net's drop-path keep masks, or None."""
        bottom_up = (self.bottom_up(x) if drop is None
                     else self.bottom_up(x, drop))
        feats = [bottom_up[f] for f in self.in_features]
        n = len(feats)
        merged = getattr(self, f"fpn_lateral{n + 1}").forward_fused(
            feats[-1])
        outs = [getattr(self, f"fpn_output{n + 1}").forward_fused(merged)]
        for i in range(n - 2, -1, -1):
            merged = getattr(self, f"fpn_lateral{i + 2}").forward_fused(
                feats[i], coarse=merged)
            outs.insert(0, getattr(self, f"fpn_output{i + 2}").forward_fused(
                merged))
        outs.append(F.max_pool2d(outs[-1], kernel_size=1, stride=2))
        return outs
