"""Deformable DETR: model, Hungarian criterion, DAOD interface.

Port of ``aldi_tpu/models/detr.py``: the torchvision-layout R50 with
FrozenBN (DC5 under ``DILATION``), four input projections with GroupNorm,
sine or learned position embeddings, the 6 + 6 deformable transformer
(``ops/ms_deform_attn.py``), shared or per-layer heads (``WITH_BOX_REFINE``),
the two-stage proposals (``TWO_STAGE``), focal classification and the
Hungarian criterion over every decoder layer at once, whose assignments
come from one ``ops/lapjv.py`` call (the kernel K4 on the card).

Module names follow the official Deformable-DETR layout that the JAX
package's converter maps to (``aldi_tpu/engine/checkpoint_convert.py:
216-330``): ``backbone.0.body.*`` (``backbone.1.{row,col}_embed`` for the
learned position embedding), ``input_proj.{i}.{0,1}``,
``transformer.level_embed``, ``transformer.encoder.layers.{i}.{self_attn,
norm1, linear1, linear2, norm2}``, ``transformer.decoder.layers.{i}.
{self_attn, norm2, cross_attn, norm1, linear1, linear2, norm3}`` (the
self-attention's projections packed as ``in_proj_weight``/``in_proj_bias``
and ``out_proj``), ``transformer.reference_points``, ``query_embed``,
``class_embed.{i}`` and ``bbox_embed.{i}.layers.{j}``. Shared heads are
held once, at index 0; under ``WITH_BOX_REFINE`` each decoder layer has its
own and the two-stage encoder head is index DEC_LAYERS.

Dropout (``TRANSFORMER.DROPOUT``, training only): each layer draws its
masks in a fixed order (encoder: attention, FFN hidden, FFN output;
decoder: self-attention, cross-attention, FFN hidden, FFN output) from a
``torch.Generator`` on the activations' device seeded from (the stream's
seed, the layer's index), made inside the layer's forward, so a step is a
function of its draws and an activation-checkpointed layer's recompute
makes the same masks. The masks are drawn as the layer runs, never all at
once. JAX's masks come from ``jax.random`` and are not reproduced.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..config import compute_dtype, resolve_canvas
from ..ops.boxes import (clip_boxes, cxcywh_to_xyxy, pairwise_giou,
                         xyxy_to_cxcywh)
from ..ops.lapjv import lapjv
from ..ops.losses import sigmoid_focal
from ..ops.ms_deform_attn import ms_deform_attn_core
from ..ops.nms import top_k
from .layers import DenseConv2d, DenseLinear, Linear, lecun_normal
from .resnet import TorchvisionResNet

NORM_EPS = 1e-5  # the JAX module's LayerNorm and GroupNorm epsilon


def inverse_sigmoid(x, eps=1e-5):
    x = x.clamp(eps, 1 - eps)
    return torch.log(x / (1 - x))


class LayerNorm32(nn.LayerNorm):
    """flax ``LayerNorm(epsilon=1e-5, dtype=float32)``, then the cast to
    the compute dtype."""

    def __init__(self, dim, compute_dtype=torch.float32):
        super().__init__(dim, eps=NORM_EPS)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(self.compute_dtype)

    def init_weights(self, gen):
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)


class GroupNorm32(nn.GroupNorm):
    """flax ``GroupNorm(32, epsilon=1e-5, dtype=float32)`` on NCHW."""

    def __init__(self, channels, compute_dtype=torch.float32):
        super().__init__(32, channels, eps=NORM_EPS)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        return F.group_norm(x.float(), self.num_groups, self.weight,
                            self.bias, self.eps).to(self.compute_dtype)

    def init_weights(self, gen):
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)


class _ZeroLinear(Linear):
    """A Dense with zero kernel and bias (``attention_weights``)."""

    def init_weights(self, gen):
        nn.init.zeros_(self.weight)
        nn.init.zeros_(self.bias)


class _OffsetLinear(_ZeroLinear):
    """``sampling_offsets``: zero kernel, and the directional grid bias of
    the reference op (``aldi_tpu/models/detr.py:71-77``): head h points
    along the angle 2 pi h / H, scaled to the unit square's border, at
    distances 1..P."""

    def __init__(self, d_model, n_heads, n_levels, n_points, compute_dtype):
        super().__init__(d_model, n_heads * n_levels * n_points * 2,
                         compute_dtype=compute_dtype)
        self.hlp = (n_heads, n_levels, n_points)

    def init_weights(self, gen):
        super().init_weights(gen)
        h, n_levels, p = self.hlp
        thetas = torch.arange(h, dtype=torch.float32) * (2.0 * math.pi / h)
        grid = torch.stack([thetas.cos(), thetas.sin()], -1)
        grid = grid / grid.abs().max(-1, keepdim=True).values
        grid = grid[:, None, None, :].repeat(1, n_levels, p, 1)
        scale = torch.arange(1, p + 1, dtype=torch.float32)[None, None, :,
                                                            None]
        with torch.no_grad():
            self.bias.copy_((grid * scale).reshape(-1))


class _ClassLinear(DenseLinear):
    """A class head: lecun-normal kernel, bias at the prior -log(99)."""

    def init_weights(self, gen):
        super().init_weights(gen)
        nn.init.constant_(self.bias, -math.log((1 - 0.01) / 0.01))


class _Table(nn.Module):
    """An embedding table ``weight`` [rows, dim]: N(0, 1) entries (flax
    ``normal(1.0)``), or uniform in [0, 1) with ``uniform``."""

    def __init__(self, rows, dim, uniform=False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(rows, dim))
        self.uniform = uniform

    def init_weights(self, gen):
        with torch.no_grad():
            draw = torch.rand if self.uniform else torch.randn
            self.weight.copy_(draw(self.weight.shape, generator=gen))


class _Dropout:
    """One layer's dropout at ``rate``: flax's ``where(mask, x / keep, 0)``
    with keep masks drawn in call order from a generator seeded from
    (``seed``, ``layer``); the identity when ``seed`` is None."""

    def __init__(self, rate, seed, layer, device):
        self.keep = 1.0 - rate
        self.gen = None
        if seed is not None and rate > 0:
            self.gen = torch.Generator(device=device)
            self.gen.manual_seed((int(seed) * 1_000_003 + layer) % (1 << 63))

    def __call__(self, x):
        if self.gen is None:
            return x
        mask = torch.rand(x.shape, generator=self.gen,
                          device=x.device) < self.keep
        return torch.where(mask, x / self.keep,
                           torch.zeros((), dtype=x.dtype, device=x.device))


class MSDeformAttn(nn.Module):
    def __init__(self, d_model=256, n_heads=8, n_levels=4, n_points=4,
                 dtype=torch.float32):
        super().__init__()
        self.n_heads, self.n_levels, self.n_points = n_heads, n_levels, \
            n_points
        self.sampling_offsets = _OffsetLinear(d_model, n_heads, n_levels,
                                              n_points, dtype)
        self.attention_weights = _ZeroLinear(
            d_model, n_heads * n_levels * n_points, compute_dtype=dtype)
        self.value_proj = DenseLinear(d_model, d_model, compute_dtype=dtype)
        self.output_proj = DenseLinear(d_model, d_model, compute_dtype=dtype)
        self.dtype = dtype

    def forward(self, query, reference_points, value_src, spatial_shapes,
                value_mask):
        """query [B, Lq, C]; reference_points [B, Lq, L, 2] (or 4, boxes)
        normalized; value_src [B, Lv, C]; value_mask [B, Lv] (True =
        valid)."""
        b, lq, _ = query.shape
        h, n_levels, p = self.n_heads, self.n_levels, self.n_points
        value = self.value_proj(value_src)
        value = torch.where(value_mask[..., None], value,
                            torch.zeros((), dtype=value.dtype,
                                        device=value.device))
        value = value.reshape(b, -1, h, value.shape[-1] // h)
        offsets = self.sampling_offsets(query).reshape(
            b, lq, h, n_levels, p, 2).float()
        attn = self.attention_weights(query).reshape(b, lq, h, n_levels * p)
        attn = torch.softmax(attn.float(), -1).reshape(b, lq, h, n_levels, p)
        if reference_points.shape[-1] == 4:
            # box references (cx, cy, w, h): offsets scale with the box
            ref = reference_points[:, :, None, :, None, :]
            loc = ref[..., :2] + offsets / p * ref[..., 2:] * 0.5
        else:
            normalizer = torch.tensor(
                [[ww, hh] for hh, ww in spatial_shapes], dtype=torch.float32,
                device=query.device)  # [L, 2] (x, y)
            loc = (reference_points[:, :, None, :, None, :]
                   + offsets / normalizer[None, None, None, :, None, :])
        out = ms_deform_attn_core(value, spatial_shapes, loc, attn)
        return self.output_proj(out.to(self.dtype))


class MultiheadAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention``: q/k/v projections with
    biases (packed as ``in_proj_weight`` [3C, C] and ``in_proj_bias``), the
    query scaled by 1/sqrt(head_dim), softmax, the output projection."""

    def __init__(self, d_model, n_heads, dtype=torch.float32):
        super().__init__()
        self.n_heads, self.dtype = n_heads, dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = DenseLinear(d_model, d_model, compute_dtype=dtype)

    def init_weights(self, gen):
        d = self.in_proj_weight.shape[1]
        for k in range(3):
            lecun_normal(self.in_proj_weight[k * d:(k + 1) * d], d, gen)
        nn.init.zeros_(self.in_proj_bias)

    def forward(self, q_in, k_in, v_in):
        dt = self.dtype
        b, lq, d = q_in.shape
        h = self.n_heads
        w, bias = self.in_proj_weight.to(dt), self.in_proj_bias.to(dt)
        q, k, v = (F.linear(x.to(dt), w[i * d:(i + 1) * d],
                            bias[i * d:(i + 1) * d]).reshape(b, -1, h, d // h)
                   for i, x in enumerate((q_in, k_in, v_in)))
        q = q / math.sqrt(d // h)
        attn = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), -1)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, lq, d)
        return self.out_proj(out)


class EncoderLayer(nn.Module):
    def __init__(self, index, d_model=256, d_ff=1024, n_heads=8, n_levels=4,
                 n_points=4, dropout=0.1, dtype=torch.float32):
        super().__init__()
        self.index, self.dropout = index, dropout
        self.self_attn = MSDeformAttn(d_model, n_heads, n_levels, n_points,
                                      dtype)
        self.norm1 = LayerNorm32(d_model, dtype)
        self.linear1 = DenseLinear(d_model, d_ff, compute_dtype=dtype)
        self.linear2 = DenseLinear(d_ff, d_model, compute_dtype=dtype)
        self.norm2 = LayerNorm32(d_model, dtype)

    def forward(self, src, pos, reference_points, spatial_shapes, mask,
                seed=None):
        drop = _Dropout(self.dropout, seed, self.index, src.device)
        attn = self.self_attn(src + pos, reference_points, src,
                              spatial_shapes, mask)
        src = self.norm1(src + drop(attn))
        y = self.linear2(drop(F.relu(self.linear1(src))))
        return self.norm2(src + drop(y))


class DecoderLayer(nn.Module):
    def __init__(self, index, d_model=256, d_ff=1024, n_heads=8, n_levels=4,
                 n_points=4, dropout=0.1, dtype=torch.float32):
        super().__init__()
        self.index, self.dropout = index, dropout
        self.cross_attn = MSDeformAttn(d_model, n_heads, n_levels, n_points,
                                       dtype)
        self.norm1 = LayerNorm32(d_model, dtype)
        self.self_attn = MultiheadAttention(d_model, n_heads, dtype)
        self.norm2 = LayerNorm32(d_model, dtype)
        self.linear1 = DenseLinear(d_model, d_ff, compute_dtype=dtype)
        self.linear2 = DenseLinear(d_ff, d_model, compute_dtype=dtype)
        self.norm3 = LayerNorm32(d_model, dtype)

    def forward(self, tgt, query_pos, reference_points, memory,
                spatial_shapes, mask, seed=None):
        drop = _Dropout(self.dropout, seed, self.index, tgt.device)
        q = tgt + query_pos
        tgt = self.norm2(tgt + drop(self.self_attn(q, q, tgt)))
        ca = self.cross_attn(tgt + query_pos, reference_points, memory,
                             spatial_shapes, mask)
        tgt = self.norm1(tgt + drop(ca))
        y = self.linear2(drop(F.relu(self.linear1(tgt))))
        return self.norm3(tgt + drop(y))


class MLP(nn.Module):
    """The box head: ``layers.{0,1}`` with ReLU, then ``layers.2``."""

    def __init__(self, hidden, out, n_layers=3, dtype=torch.float32):
        super().__init__()
        self.layers = nn.ModuleList(
            DenseLinear(hidden, hidden if i < n_layers - 1 else out,
                        compute_dtype=dtype) for i in range(n_layers))

    def forward(self, x):
        for layer in self.layers[:-1]:
            x = F.relu(layer(x))
        return self.layers[-1](x)


def _dim_t(half, temperature, device):
    d = torch.arange(half, dtype=torch.float32, device=device)
    return temperature ** (2 * torch.div(d, 2, rounding_mode="floor") / half)


def _sin_cos(pos):
    """Interleaved [sin of the even entries, cos of the odd ones]."""
    return torch.stack([pos[..., 0::2].sin(), pos[..., 1::2].cos()],
                       -1).flatten(-2)


def sine_position_embedding(mask, d_model=256, temperature=10000.0,
                            scale=2 * math.pi):
    """mask [B, H, W] True = valid -> [B, H, W, d_model] sine embeddings,
    normalized to the valid region."""
    m = mask.float()
    y_embed = m.cumsum(1)
    x_embed = m.cumsum(2)
    eps = 1e-6
    y_embed = y_embed / (y_embed[:, -1:, :] + eps) * scale
    x_embed = x_embed / (x_embed[:, :, -1:] + eps) * scale
    dim_t = _dim_t(d_model // 2, temperature, mask.device)
    pos_x = _sin_cos(x_embed[..., None] / dim_t)
    pos_y = _sin_cos(y_embed[..., None] / dim_t)
    return torch.cat([pos_y, pos_x], -1)


def proposal_pos_embed(coords_unact, d_model=256, temperature=10000.0,
                       scale=2 * math.pi):
    """[B, Q, 4] unactivated coords -> [B, Q, 2 * d_model] sine embeddings
    (the official ``get_proposal_pos_embed``: d_model / 2 per coord)."""
    dim_t = _dim_t(d_model // 2, temperature, coords_unact.device)
    p = torch.sigmoid(coords_unact.float()) * scale
    return _sin_cos(p[..., None] / dim_t).flatten(-2)


class _Body(nn.Module):
    """``backbone.0``: the R50 ``body``."""

    def __init__(self, body):
        super().__init__()
        self.body = body


class _LearnedPosition(nn.Module):
    """``backbone.1``: the official ``PositionEmbeddingLearned`` tables of
    50 rows and columns, d_model / 2 wide each."""

    def __init__(self, d_model):
        super().__init__()
        self.row_embed = _Table(50, d_model // 2, uniform=True)
        self.col_embed = _Table(50, d_model // 2, uniform=True)


class _Transformer(nn.Module):
    """``transformer``: the level embedding, the encoder and decoder layers
    and the query-side projections."""

    def __init__(self, n_levels, d_model, enc, dec, two_stage, dtype):
        super().__init__()
        self.level_embed = nn.Parameter(torch.empty(n_levels, d_model))
        self.encoder = nn.Module()
        self.encoder.layers = nn.ModuleList(enc)
        self.decoder = nn.Module()
        self.decoder.layers = nn.ModuleList(dec)
        if two_stage:
            self.enc_output = DenseLinear(d_model, d_model,
                                          compute_dtype=dtype)
            self.enc_output_norm = LayerNorm32(d_model, dtype)
            self.pos_trans = DenseLinear(2 * d_model, 2 * d_model,
                                         compute_dtype=dtype)
            self.pos_trans_norm = LayerNorm32(2 * d_model, dtype)
        else:
            self.reference_points = DenseLinear(d_model, 2)

    def init_weights(self, gen):
        with torch.no_grad():
            self.level_embed.copy_(torch.randn(self.level_embed.shape,
                                               generator=gen))


class DeformableDETR(nn.Module):
    """``forward(x, image_sizes, train, seed)`` on normalized NCHW images
    returns per-decoder-layer class logits [Ld, B, Q, K] and normalized
    cxcywh boxes [Ld, B, Q, 4] (``enc_logits``/``enc_boxes`` too under
    two-stage), float32."""

    def __init__(self, num_classes, num_queries=300, d_model=256, d_ff=1024,
                 n_heads=8, enc_layers=6, dec_layers=6, n_levels=4,
                 n_points=4, dropout=0.1, freeze_at=2, pos_scale=2 * math.pi,
                 dilation=False, pos_embedding="sine", with_box_refine=False,
                 two_stage=False, use_act_checkpoint=False,
                 dtype=torch.float32):
        super().__init__()
        if pos_embedding not in ("sine", "learned"):
            raise ValueError(
                f"POSITION_EMBEDDING must be 'sine' or 'learned', got "
                f"{pos_embedding!r}")
        self.num_queries, self.d_model = num_queries, d_model
        self.dec_layers, self.pos_scale = dec_layers, pos_scale
        self.dilation, self.pos_embedding = dilation, pos_embedding
        self.with_box_refine, self.two_stage = with_box_refine, two_stage
        self.use_act_checkpoint, self.dtype = use_act_checkpoint, dtype
        body = TorchvisionResNet(50, freeze_at, 2 if dilation else 1, dtype)
        self.backbone = nn.ModuleList([_Body(body)])
        if pos_embedding == "learned":
            self.backbone.append(_LearnedPosition(d_model))
        projs = [nn.Sequential(DenseConv2d(c, d_model, 1, compute_dtype=dtype),
                               GroupNorm32(d_model, dtype))
                 for c in (512, 1024, 2048)]
        projs.append(nn.Sequential(
            DenseConv2d(2048, d_model, 3, stride=2, padding=1,
                        compute_dtype=dtype), GroupNorm32(d_model, dtype)))
        self.input_proj = nn.ModuleList(projs)
        layer_args = (d_model, d_ff, n_heads, n_levels, n_points, dropout,
                      dtype)
        self.transformer = _Transformer(
            n_levels, d_model,
            [EncoderLayer(i, *layer_args) for i in range(enc_layers)],
            [DecoderLayer(enc_layers + i, *layer_args)
             for i in range(dec_layers)], two_stage, dtype)
        if not two_stage:
            self.query_embed = _Table(num_queries, 2 * d_model)
        n_heads_out = (dec_layers + int(two_stage)) if with_box_refine else 1
        self.class_embed = nn.ModuleList(
            _ClassLinear(d_model, num_classes, compute_dtype=dtype)
            for _ in range(n_heads_out))
        self.bbox_embed = nn.ModuleList(MLP(d_model, 4, 3, dtype)
                                        for _ in range(n_heads_out))

    def _heads(self, i):
        """(class head, box head) of decoder layer ``i`` (``dec_layers``:
        the two-stage encoder head)."""
        j = i if self.with_box_refine else 0
        return self.class_embed[j], self.bbox_embed[j]

    def _layer(self, layer, *args):
        if self.use_act_checkpoint and torch.is_grad_enabled():
            return checkpoint(layer, *args, use_reentrant=False)
        return layer(*args)

    def _levels(self, x, image_sizes):
        """Backbone + input projections + the flattened levels: (src, pos,
        mask [B, Lv], valid_ratios [B, L, 2], spatial_shapes)."""
        b = x.shape[0]
        feats = self.backbone[0].body(x)
        srcs = [proj(feats[k]) for proj, k in
                zip(self.input_proj, ("res3", "res4", "res5"))]
        srcs.append(self.input_proj[3](feats["res5"]))
        spatial_shapes = [tuple(s.shape[-2:]) for s in srcs]
        strides = [8, 16, 16, 32] if self.dilation else [8, 16, 32, 64]
        if self.pos_embedding == "learned":
            hh0, ww0 = spatial_shapes[0]
            if hh0 > 50 or ww0 > 50:
                raise ValueError(
                    f"POSITION_EMBEDDING='learned' supports level grids up "
                    f"to 50x50 (official 50-entry tables); stride-8 level "
                    f"is {hh0}x{ww0}: use a canvas <= 400px or 'sine'")
        level_embed = self.transformer.level_embed
        dev = x.device
        flat_src, flat_pos, flat_mask, valid_ratios = [], [], [], []
        for lvl, (s, (hh, ww), stride) in enumerate(
                zip(srcs, spatial_shapes, strides)):
            rows = torch.arange(hh, device=dev)[None, :, None]
            cols = torch.arange(ww, device=dev)[None, None, :]
            vh = torch.ceil(image_sizes[:, 0:1] / stride)[..., None]
            vw = torch.ceil(image_sizes[:, 1:2] / stride)[..., None]
            mask = (rows < vh) & (cols < vw)  # [B, H, W]
            if self.pos_embedding == "learned":
                pe = self.backbone[1]
                pos = torch.cat([
                    pe.col_embed.weight[:ww][None].expand(hh, -1, -1),
                    pe.row_embed.weight[:hh][:, None].expand(-1, ww, -1)],
                    -1)[None].expand(b, -1, -1, -1).to(self.dtype)
            else:
                pos = sine_position_embedding(
                    mask, self.d_model, scale=self.pos_scale).to(self.dtype)
            flat_src.append(s.flatten(2).transpose(1, 2))
            flat_pos.append(pos.reshape(b, hh * ww, self.d_model)
                            + level_embed[lvl].to(self.dtype))
            flat_mask.append(mask.reshape(b, hh * ww))
            valid_ratios.append(torch.cat([vw[..., 0] / ww, vh[..., 0] / hh],
                                          -1))  # [B, 2] (x, y)
        return (torch.cat(flat_src, 1), torch.cat(flat_pos, 1),
                torch.cat(flat_mask, 1),
                torch.stack(valid_ratios, 1).float(), spatial_shapes)

    def _encoder_reference(self, valid_ratios, spatial_shapes):
        """[B, Lv, L, 2]: each token's centre in its own level's valid
        extent, scaled into every level's (``get_reference_points``)."""
        dev = valid_ratios.device
        refs = []
        for lvl, (hh, ww) in enumerate(spatial_shapes):
            ry = (torch.arange(hh, dtype=torch.float32, device=dev) + 0.5) / hh
            rx = (torch.arange(ww, dtype=torch.float32, device=dev) + 0.5) / ww
            gy, gx = torch.meshgrid(ry, rx, indexing="ij")
            grid = torch.stack([gx, gy], -1).reshape(-1, 2)
            refs.append(grid[None] / valid_ratios[:, lvl][:, None, :])
        ref = torch.cat(refs, 1)
        return ref[:, :, None, :] * valid_ratios[:, None, :, :]

    def _two_stage_queries(self, memory, mask, valid_ratios, spatial_shapes,
                           out):
        """The first stage: every encoder token scored as a proposal; the
        top NUM_QUERIES by the first class become the object queries.
        Returns (query_pos, tgt, reference boxes)."""
        dev = memory.device
        props = []
        for lvl, (hh, ww) in enumerate(spatial_shapes):
            vw = valid_ratios[:, lvl, 0:1] * ww  # [B, 1]
            vh = valid_ratios[:, lvl, 1:2] * hh
            gy = torch.arange(hh, dtype=torch.float32, device=dev) + 0.5
            gx = torch.arange(ww, dtype=torch.float32, device=dev) + 0.5
            my, mx = torch.meshgrid(gy, gx, indexing="ij")
            cx = mx.reshape(-1)[None] / vw.clamp(min=1.0)  # [B, HW]
            cy = my.reshape(-1)[None] / vh.clamp(min=1.0)
            wh = torch.full_like(cx, 0.05 * (2.0 ** lvl))
            props.append(torch.stack([cx, cy, wh, wh], -1))
        proposals = torch.cat(props, 1)  # [B, Lv, 4]
        ok = ((proposals > 0.01) & (proposals < 0.99)).all(-1) & mask
        prop_unact = torch.where(ok[..., None], inverse_sigmoid(proposals),
                                 torch.full((), 1e6, device=dev))
        om = torch.where(ok[..., None], memory,
                         torch.zeros((), dtype=memory.dtype, device=dev))
        tr = self.transformer
        om = tr.enc_output_norm(tr.enc_output(om))
        cls_head, box_head = self._heads(self.dec_layers)
        # logits stay unmasked: the zeroed rows share one bias-driven score
        enc_logits = cls_head(om).float()  # [B, Lv, K]
        enc_coords_unact = box_head(om).float() + prop_unact
        out["enc_logits"] = enc_logits
        out["enc_boxes"] = torch.sigmoid(enc_coords_unact)
        _, idx = top_k(enc_logits[..., 0], self.num_queries)
        topk_unact = torch.gather(
            enc_coords_unact, 1, idx[..., None].expand(-1, -1, 4)).detach()
        pe = proposal_pos_embed(topk_unact, self.d_model,
                                scale=self.pos_scale)
        pt = tr.pos_trans_norm(tr.pos_trans(pe.to(self.dtype)))
        query_pos, tgt = pt.split(self.d_model, -1)
        return query_pos, tgt, torch.sigmoid(topk_unact)

    def forward(self, x, image_sizes, train=False, seed=None,
                stage="full"):
        """``seed`` (an int, training only): the dropout draws. ``stage``
        "backbone" returns after the input projections and the flatten,
        "encoder" after the encoder (for timing by stage)."""
        seed = seed if train else None
        b = x.shape[0]
        src, pos, mask, valid_ratios, spatial_shapes = self._levels(
            x, image_sizes)
        if stage == "backbone":
            return {"src": src}
        enc_ref = self._encoder_reference(valid_ratios, spatial_shapes)
        memory = src
        for layer in self.transformer.encoder.layers:
            memory = self._layer(layer, memory, pos, enc_ref, spatial_shapes,
                                 mask, seed)
        if stage == "encoder":
            return {"memory": memory}

        out = {}
        if self.two_stage:
            query_pos, tgt, ref = self._two_stage_queries(
                memory, mask, valid_ratios, spatial_shapes, out)
        else:
            qe = self.query_embed.weight.to(self.dtype)
            query_pos, tgt = qe.split(self.d_model, -1)
            query_pos = query_pos[None].expand(b, -1, -1)
            tgt = tgt[None].expand(b, -1, -1)
            ref = torch.sigmoid(self.transformer.reference_points(
                query_pos.float()))  # [B, Q, 2]
        logits, boxes = [], []
        for i, layer in enumerate(self.transformer.decoder.layers):
            if ref.shape[-1] == 4:
                dec_ref = ref[:, :, None, :] * torch.cat(
                    [valid_ratios, valid_ratios], -1)[:, None, :, :]
            else:
                dec_ref = ref[:, :, None, :] * valid_ratios[:, None, :, :]
            tgt = self._layer(layer, tgt, query_pos, dec_ref, memory,
                              spatial_shapes, mask, seed)
            cls_head, box_head = self._heads(i)
            logits.append(cls_head(tgt).float())
            delta = box_head(tgt).float()
            if ref.shape[-1] == 4:
                new_ref = torch.sigmoid(delta + inverse_sigmoid(ref))
            else:
                new_ref = torch.cat(
                    [torch.sigmoid(delta[..., :2] + inverse_sigmoid(ref)),
                     torch.sigmoid(delta[..., 2:])], -1)
            boxes.append(new_ref)
            if self.with_box_refine:
                ref = new_ref.detach()
        out["logits"] = torch.stack(logits)
        out["boxes"] = torch.stack(boxes)
        return out


# ----------------------------------------------------------------- criterion
@torch.no_grad()
def hungarian_match(logits, pred_boxes, gt_boxes, gt_classes, gt_valid,
                    cost_class=2.0, cost_bbox=5.0, cost_giou=2.0,
                    focal_alpha=0.25, gamma=2.0):
    """Per-image Hungarian assignment on padded cost matrices, all images
    in one ``lapjv`` call. logits [B, Q, K], pred_boxes [B, Q, 4] and
    gt_boxes [B, G, 4] normalized cxcywh, gt_classes and gt_valid [B, G].
    The problem of each image is the transposed cost (rows = gt) with the
    valid gts first (a stable sort) and only ``gt_valid.sum()`` rows
    solved. Returns (query_idx [B, G] int32, 0 for an invalid slot;
    pair_valid [B, G])."""
    lg = logits.detach().float()
    pb = pred_boxes.detach().float()
    q = lg.shape[1]
    prob = torch.sigmoid(lg)
    neg = (1 - focal_alpha) * prob ** gamma * (
        -torch.log((1 - prob).clamp(min=1e-8)))
    pos = focal_alpha * (1 - prob) ** gamma * (
        -torch.log(prob.clamp(min=1e-8)))
    c_cls = torch.gather(pos - neg, 2, gt_classes.long()[:, None, :].expand(
        -1, q, -1))  # [B, Q, G]
    c_l1 = (pb[:, :, None, :] - gt_boxes[:, None, :, :]).abs().sum(-1)
    c_giou = -pairwise_giou(cxcywh_to_xyxy(pb), cxcywh_to_xyxy(gt_boxes))
    cost = cost_class * c_cls + cost_bbox * c_l1 + cost_giou * c_giou
    # NaN must stay repulsive (0 would be a competitive mid-range cost)
    cost = torch.nan_to_num(cost, nan=1e4, posinf=1e4,
                            neginf=-1e4).clamp(-1e4, 1e4)
    order = torch.sort((~gt_valid).to(torch.int8), dim=1,
                       stable=True).indices  # valid gts first
    rows = torch.gather(cost.transpose(1, 2), 1,
                        order[..., None].expand(-1, -1, q))  # [B, G, Q]
    col4row = lapjv(rows.contiguous(), gt_valid.sum(1))
    q_sorted = col4row.clamp(min=0)  # -1 (an unsolved pad) -> 0
    q_for_gt = torch.gather(q_sorted, 1, torch.argsort(order, dim=1))
    return q_for_gt.to(torch.int32), gt_valid


def detr_losses_all_layers(logits, pred_boxes, gt_boxes_n, gt_classes,
                           gt_valid, num_classes, focal_alpha, num_boxes):
    """SetCriterion's labels and boxes losses for all decoder layers at
    once: logits [L, B, Q, K], pred_boxes [L, B, Q, 4], gt_* [B, ...].
    Returns (loss_ce [L], loss_bbox [L], loss_giou [L]). All L*B
    assignment problems go into one ``hungarian_match``."""
    n_layers, b, q, k = logits.shape
    g = gt_boxes_n.shape[1]

    def rep(x):
        return x[None].expand((n_layers,) + x.shape).reshape(
            (n_layers * b,) + x.shape[1:])

    q_idx, pair_valid = hungarian_match(
        logits.reshape(n_layers * b, q, k),
        pred_boxes.reshape(n_layers * b, q, 4), rep(gt_boxes_n),
        rep(gt_classes), rep(gt_valid), focal_alpha=focal_alpha)
    gt_classes_f, gt_boxes_f = rep(gt_classes), rep(gt_boxes_n)
    q_idx = q_idx.long()

    # classification: one-hot targets at the matched queries, focal over all
    onehot = (gt_classes_f[..., None] == torch.arange(
        k, device=logits.device)).float() * pair_valid[..., None]
    tcls = torch.zeros((n_layers * b, q, k), device=logits.device)
    tcls = tcls.scatter_add(1, q_idx[..., None].expand(-1, -1, k),
                            onehot).clamp(0.0, 1.0)
    fl = sigmoid_focal(logits.reshape(n_layers * b, q, k).float(), tcls,
                       focal_alpha, 2.0)
    nb = num_boxes.clamp(min=1.0)
    loss_ce = fl.reshape(n_layers, b, q, k).mean(2).sum((1, 2)) * q / nb

    # box losses on the matched pairs
    pb = torch.gather(pred_boxes.reshape(n_layers * b, q, 4), 1,
                      q_idx[..., None].expand(-1, -1, 4))  # [L*B, G, 4]
    vf = pair_valid.float().reshape(n_layers, b, g)
    l1 = (pb - gt_boxes_f).abs().sum(-1).reshape(n_layers, b, g)
    loss_bbox = (l1 * vf).sum((1, 2)) / nb
    giou = pairwise_giou(cxcywh_to_xyxy(pb.reshape(-1, 1, 4)),
                         cxcywh_to_xyxy(gt_boxes_f.reshape(-1, 1, 4)))
    loss_giou = ((1.0 - giou.reshape(n_layers, b, g)) * vf).sum((1, 2)) / nb
    return loss_ce, loss_bbox, loss_giou


def detr_losses_single_layer(logits, pred_boxes, gt_boxes_n, gt_classes,
                             gt_valid, num_classes, focal_alpha, num_boxes):
    """One decoder layer's losses (SetCriterion labels/boxes)."""
    ce, l1, giou = detr_losses_all_layers(
        logits[None], pred_boxes[None], gt_boxes_n, gt_classes, gt_valid,
        num_classes, focal_alpha, num_boxes)
    return ce[0], l1[0], giou[0]


class DETRDetector:
    """Static config + orchestration around the ``DeformableDETR`` module,
    which lives on ``device`` (``cuda`` unless the caller asks for another),
    its weights drawn from ``seed`` (``init_variables``). The contract is
    ``RCNNDetector``'s (``models/rcnn.py``). Distillation is the
    reference's HardDistiller: the student's standard losses on the
    pseudo-labels are the signal, ungated (``gate_hard``), with no soft
    terms; alignment is ``DETRAlignMixin``'s pass-through."""

    gate_hard = False

    def __init__(self, cfg, device=None, seed=0):
        dd = cfg.MODEL.DEFORMABLE_DETR
        if dd.BACKBONE != "resnet50":
            raise NotImplementedError(
                f"DEFORMABLE_DETR.BACKBONE={dd.BACKBONE!r}: only 'resnet50' "
                "is implemented, as in the JAX package (the reference's "
                "shipped configs use no other, configs/Base-DETR.yaml:9); "
                "ROADMAP.md notes it under 'Modules still to port'")
        if dd.NUM_FEATURE_LEVELS != 4:
            raise NotImplementedError(
                "DEFORMABLE_DETR.NUM_FEATURE_LEVELS != 4 is not implemented, "
                "as in the JAX package; ROADMAP.md notes it under 'Modules "
                "still to port'")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.dtype = compute_dtype(cfg)
        self.canvas = resolve_canvas(cfg)
        self.num_classes = dd.NUM_CLASSES
        t = dd.TRANSFORMER
        self.module = DeformableDETR(
            num_classes=self.num_classes, num_queries=t.NUM_QUERIES,
            d_model=t.HIDDEN_DIM, d_ff=t.DIM_FEEDFORWARD, n_heads=t.NHEADS,
            enc_layers=t.ENC_LAYERS, dec_layers=t.DEC_LAYERS,
            n_levels=dd.NUM_FEATURE_LEVELS, n_points=t.ENC_N_POINTS,
            dropout=t.DROPOUT, freeze_at=cfg.MODEL.BACKBONE.FREEZE_AT,
            pos_scale=dd.POSITION_EMBEDDING_SCALE, dilation=dd.DILATION,
            pos_embedding=dd.POSITION_EMBEDDING,
            with_box_refine=dd.WITH_BOX_REFINE, two_stage=dd.TWO_STAGE,
            use_act_checkpoint=dd.USE_ACT_CHECKPOINT, dtype=self.dtype)
        self.init_variables(seed)
        self.two_stage = dd.TWO_STAGE
        self.pixel_mean = torch.tensor(cfg.MODEL.PIXEL_MEAN,
                                       dtype=torch.float32, device=self.device)
        self.pixel_std = torch.tensor(cfg.MODEL.PIXEL_STD, dtype=torch.float32,
                                      device=self.device)
        loss = dd.LOSS
        self.coef = dict(ce=loss.CLS_LOSS_COEF, bbox=loss.BBOX_LOSS_COEF,
                         giou=loss.GIOU_LOSS_COEF)
        self.focal_alpha = loss.FOCAL_ALPHA
        self.aux_loss = loss.AUX_LOSS

    # ---------------------------------------------------------------- init
    def init_variables(self, seed: int = 0) -> dict:
        """Re-draw every weight from ``torch.Generator`` ``seed`` on the CPU
        with the JAX package's initializers (the zero kernels of
        ``sampling_offsets`` and ``attention_weights``, the class-bias prior
        -log(99), ``level_embed`` and ``query_embed`` ~ N(0, 1), FrozenBN at
        the identity). Returns the module's state dict."""
        gen = torch.Generator().manual_seed(seed)
        self.module.to("cpu")
        for m in self.module.modules():
            if hasattr(m, "init_weights"):
                m.init_weights(gen)
        self.module.to(self.device)
        return self.module.state_dict()

    def preprocess(self, images):
        """float [B, H, W, 3] in 0..255 -> normalized compute-dtype tensor
        (NHWC); the arithmetic runs in float32."""
        x = (images.to(torch.float32) - self.pixel_mean) / self.pixel_std
        return x.to(self.dtype)

    def _fwd(self, module, images, image_sizes, train, seed=None,
             stage="full"):
        module = module or self.module  # NHWC -> NCHW in channels_last
        return module(self.preprocess(images).permute(0, 3, 1, 2),
                      image_sizes, train=train, seed=seed, stage=stage)

    def _normalize_gt(self, gt, image_sizes):
        wh = torch.stack([image_sizes[:, 1], image_sizes[:, 0],
                          image_sizes[:, 1], image_sizes[:, 0]],
                         -1).float()[:, None, :]
        return xyxy_to_cxcywh(gt.boxes / wh.clamp(min=1.0))

    # ------------------------------------------------------------- training
    def forward_train(self, module, images, image_sizes, gt, draws=None,
                      do_align=False, domain_label=1.0):
        """Training forward of ``module`` on images [B, H, W, 3] with ground
        truth ``gt`` (``Instances`` padded to MAX_GT); ``draws``:
        ``{"dropout": seed}`` (no dropout without it). Returns (losses
        ``loss_{ce,bbox,giou}[_i]`` and under two-stage ``*_enc``, aux)."""
        seed = draws.get("dropout") if draws else None
        out = self._fwd(module, images, image_sizes, True, seed)
        gt_n = self._normalize_gt(gt, image_sizes)
        num_boxes = gt.valid.sum().float().clamp(min=1.0)
        n_layers = out["logits"].shape[0]
        lg = out["logits"] if self.aux_loss else out["logits"][-1:]
        bx = out["boxes"] if self.aux_loss else out["boxes"][-1:]
        ce, l1, giou = detr_losses_all_layers(
            lg, bx, gt_n, gt.classes, gt.valid, self.num_classes,
            self.focal_alpha, num_boxes)
        losses = {}
        for j in range(lg.shape[0]):
            i = j if self.aux_loss else n_layers - 1
            suffix = "" if i == n_layers - 1 else f"_{i}"
            losses[f"loss_ce{suffix}"] = self.coef["ce"] * ce[j]
            losses[f"loss_bbox{suffix}"] = self.coef["bbox"] * l1[j]
            losses[f"loss_giou{suffix}"] = self.coef["giou"] * giou[j]
        if self.two_stage:
            # first-stage proposals are class-agnostic: every gt class is 0
            ce, l1, giou = detr_losses_single_layer(
                out["enc_logits"], out["enc_boxes"], gt_n,
                torch.zeros_like(gt.classes), gt.valid, self.num_classes,
                self.focal_alpha, num_boxes)
            losses["loss_ce_enc"] = self.coef["ce"] * ce
            losses["loss_bbox_enc"] = self.coef["bbox"] * l1
            losses["loss_giou_enc"] = self.coef["giou"] * giou
        return losses, {}

    def forward_domain_align(self, module, images, image_sizes, draws=None,
                             domain_label=0.0):
        """The reference's ``DETRAlignMixin`` is a pass-through."""
        return {}

    # -------------------------------------------------------------- teacher
    @torch.no_grad()
    def forward_teacher_ctx(self, module, images, image_sizes, draws=None,
                            threshold: float = 0.0, max_gt: int = 100):
        """The teacher's pseudo-labels (its detections above
        ``threshold``). Returns (ctx, pseudo_gt, metrics)."""
        from ..engine.pseudolabel import detections_to_pseudo_labels

        dets = self.detect(images, image_sizes, module)
        pseudo = detections_to_pseudo_labels(*dets, threshold=threshold,
                                             max_gt=max_gt)
        metrics = {"num_pseudo_labels": pseudo.valid.sum().to(torch.float32)
                   / max(images.shape[0], 1)}
        return {}, pseudo, metrics

    def distill_losses(self, teacher, ctx, s_aux):
        """HardDistiller has no soft terms."""
        return {}

    # ----------------------------------------------------------- inference
    @torch.inference_mode()
    def forward_inference(self, images, image_sizes, module=None):
        """Detection inference on the canvas: images [B, H, W, 3] in
        0..255, image_sizes [B, 2] (h, w) on the detector's device;
        ``module``: the DeformableDETR to run (the EMA teacher, say), the
        detector's own by default. Returns (boxes [B, D, 4], scores
        [B, D], classes [B, D] int32, valid [B, D])."""
        return self.detect(images, image_sizes, module)

    def detect(self, images, image_sizes, module=None):
        """``forward_inference``'s body without its ``inference_mode``, for
        ``torch.export`` (``engine/export.py``): the last decoder layer's
        sigmoid scores, the top TEST.DETECTIONS_PER_IMAGE over Q*K (ties
        in index order), their boxes scaled to each image and clipped."""
        return self.detections(self._fwd(module, images, image_sizes, False),
                               image_sizes)

    def detections(self, out, image_sizes):
        """The module's outputs -> (boxes, scores, classes, valid), as
        ``detect`` returns them."""
        logits, boxes_n = out["logits"][-1], out["boxes"][-1]
        b, q, k = logits.shape
        scores, idx = top_k(torch.sigmoid(logits).reshape(b, q * k),
                            self.cfg.TEST.DETECTIONS_PER_IMAGE)
        q_idx = torch.div(idx, k, rounding_mode="floor")
        classes = (idx % k).to(torch.int32)
        sel = torch.gather(boxes_n, 1, q_idx[..., None].expand(-1, -1, 4))
        wh = torch.stack([image_sizes[:, 1], image_sizes[:, 0],
                          image_sizes[:, 1], image_sizes[:, 0]],
                         -1).float()[:, None, :]
        boxes = clip_boxes(cxcywh_to_xyxy(sel) * wh,
                           (image_sizes[:, 0, None], image_sizes[:, 1, None]))
        return boxes, scores, classes, torch.ones_like(scores,
                                                       dtype=torch.bool)
