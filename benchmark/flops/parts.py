"""Operations of the R-CNN family's parts, counted from the configuration's
shapes: every convolution, linear layer and attention product, at 2
operations a multiply-add, whatever implements it. Nothing else counts
(normalizations, activations, ROIAlign, NMS). Each part returns
``(frozen, trained)``: its forward's operations in layers whose parameters
are frozen and in layers that are trained."""

import math

BLOCKS_PER_STAGE = {26: [1, 1, 1, 1], 50: [3, 4, 6, 3], 101: [3, 4, 23, 3]}


def conv(cin, cout, k, h_out, w_out, groups=1):
    return 2 * cin // groups * cout * k * k * h_out * w_out


def out_size(x, k, s, p):
    return (x + 2 * p - k) // s + 1


def resnet(depth, stride_in_1x1, freeze_at, h, w):
    """ResNet (stem + res2..res5) on an h x w input; the stem and the stages
    res2..res{freeze_at} are frozen."""
    h, w = out_size(h, 7, 2, 3), out_size(w, 7, 2, 3)
    stem = conv(3, 64, 7, h, w)
    h, w = out_size(h, 3, 2, 1), out_size(w, 3, 2, 1)
    frozen = stem if freeze_at >= 1 else 0
    trained = 0 if freeze_at >= 1 else stem
    cin, bott, cout = 64, 64, 256
    shapes = {}
    for i, n_blocks in enumerate(BLOCKS_PER_STAGE[depth]):
        ops = 0
        for b in range(n_blocks):
            stride = (1 if i == 0 else 2) if b == 0 else 1
            c_in = cin if b == 0 else cout
            s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
            h1, w1 = out_size(h, 1, s1, 0), out_size(w, 1, s1, 0)
            ops += conv(c_in, bott, 1, h1, w1)
            h2, w2 = out_size(h1, 3, s3, 1), out_size(w1, 3, s3, 1)
            ops += conv(bott, bott, 3, h2, w2) + conv(bott, cout, 1, h2, w2)
            if b == 0:
                ops += conv(c_in, cout, 1, out_size(h, 1, stride, 0),
                            out_size(w, 1, stride, 0))
            h, w = h2, w2
        shapes[f"res{i + 2}"] = (cout, h, w)
        if freeze_at >= i + 2:
            frozen += ops
        else:
            trained += ops
        cin, bott, cout = cout, bott * 2, cout * 2
    return frozen, trained, shapes


def fpn(shapes, out_channels=256):
    """Lateral 1x1 and output 3x3 convs of p2..p5 (p6 is a max-pool)."""
    ops = 0
    for name in ("res2", "res3", "res4", "res5"):
        c, h, w = shapes[name]
        ops += conv(c, out_channels, 1, h, w) + conv(out_channels,
                                                     out_channels, 3, h, w)
    return 0, ops


def level_sizes(canvas, strides=(4, 8, 16, 32, 64)):
    return [(math.ceil(canvas[0] / s), math.ceil(canvas[1] / s))
            for s in strides]


def rpn_head(canvas, n_convs, anchors=3, channels=256):
    """The shared RPN head over p2..p6: n_convs 3x3 convs, objectness and
    anchor deltas."""
    ops = 0
    for h, w in level_sizes(canvas):
        ops += n_convs * conv(channels, channels, 3, h, w)
        ops += conv(channels, anchors, 1, h, w) + conv(channels, 4 * anchors,
                                                       1, h, w)
    return 0, ops


def box_head(rois, num_classes, num_conv, num_fc, fc_dim=1024,
             channels=256, conv_dim=256, resolution=7):
    """The box head on ``rois`` pooled boxes and the box predictor."""
    ops, c = 0, channels
    for _ in range(num_conv):
        ops += conv(c, conv_dim, 3, resolution, resolution) * rois
        c = conv_dim
    dim = c * resolution * resolution
    for _ in range(num_fc):
        ops += 2 * dim * fc_dim * rois
        dim = fc_dim
    ops += 2 * dim * (num_classes + 1 + 4 * num_classes) * rois
    return 0, ops


def vit(grid, embed_dim, depth, num_heads, global_blocks, window=14,
        patch=16, mlp_ratio=4, pretrain_grid=14):
    """ViT trunk on the (h, w) patch grid: the patch embedding, the
    position embedding's bicubic resize (two products), per block qkv,
    proj and MLP linears and the attention products (q.k, P.v and the
    decomposed rel-pos bias q.R_h, q.R_w). A window block's linears and
    attention run on the grid padded to whole windows."""
    h, w = grid
    n = h * w
    hd = embed_dim // num_heads
    ops = conv(3, embed_dim, patch, h, w)
    if (h, w) != (pretrain_grid, pretrain_grid):
        p = pretrain_grid
        ops += 2 * embed_dim * (h * p * p + h * w * p)
    for i in range(depth):
        if i in global_blocks:
            tokens, groups, seq, gh, gw = n, 1, n, h, w
        else:
            hp, wp = -(-h // window) * window, -(-w // window) * window
            tokens = hp * wp
            groups, seq, gh, gw = tokens // (window * window), window * window, window, window
        ops += 2 * tokens * embed_dim * 3 * embed_dim  # qkv
        ops += 2 * tokens * embed_dim * embed_dim  # proj
        ops += groups * num_heads * (4 * seq * seq * hd
                                     + 2 * seq * (gh + gw) * hd)
        ops += 2 * 2 * n * embed_dim * mlp_ratio * embed_dim  # MLP
    return 0, ops


def simple_feature_pyramid(grid, dim, out_channels=256):
    """ViTDet's SFP: the 2x2 deconvolutions, then per scale a 1x1 and a 3x3
    conv to ``out_channels``."""
    h, w = grid
    ops = conv(dim, dim // 2, 2, h, w) + conv(dim // 2, dim // 4, 2, 2 * h,
                                               2 * w)
    ops += conv(dim, dim // 2, 2, h, w)
    for c, sh, sw in ((dim // 4, 4 * h, 4 * w), (dim // 2, 2 * h, 2 * w),
                      (dim, h, w), (dim, h // 2, w // 2)):
        ops += conv(c, out_channels, 1, sh, sw) + conv(
            out_channels, out_channels, 3, sh, sw)
    return 0, ops


def daod_step(forward, n_labeled, n_unlabeled, roi_train, roi_test,
              box_head_of):
    """One ALDI++ step (labeled_strong + distill, soft distillation): the
    teacher's forward on the unlabeled images at the test top-k, each
    student stream's forward at its sampled ROIs and backward (twice the
    forward of its trained layers), and the teacher's box head on the
    distill stream's sampled ROIs. ``forward(n, rois)`` gives (frozen,
    trained) of a forward of n images with ``rois`` boxes each."""
    teacher = sum(forward(n_unlabeled, roi_test))
    student = 0
    for n in (n_labeled, n_unlabeled):
        frozen, trained = forward(n, roi_train)
        student += frozen + 3 * trained
    return teacher + student + sum(box_head_of(n_unlabeled * roi_train))
