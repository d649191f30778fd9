"""PointRend's heads: the coarse mask head, the point head, the point
sampling and the test-time subdivision.

Counterpart of ``dsl_tpu/models/roi_heads/point_rend.py``, NCHW:

- ``CoarseMaskHead``: ``num_convs`` 3x3 convs with relu, a d x d stride-d
  ``downsample_conv`` with relu, the features flattened (c, h, w) into
  ``num_fcs`` FCs with relu, and ``fc_logits``, read as (classes, h, w):
  mmdet's names (``convs.i.conv``, ``downsample_conv.conv``, ``fcs.i``,
  ``fc_logits``) and mmdet's orders. The JAX head flattens (h, w, c) and
  writes (h, w, classes): the weight bridge permutes ``fcs.0``'s input
  rows and ``fc_logits``' output rows. Returns (N, classes, s, s), s =
  ``roi_size // downsample_factor``;
- ``MaskPointHead``: per point, the fine features and the coarse logits
  concatenated, ``num_fcs`` FCs with relu (the coarse logits concatenated
  again after each where ``coarse_pred_each_layer``), and ``fc_logits``.
  The FCs hold mmdet's ``Conv1d`` weights (``fcs.i.conv``, ``fc_logits``,
  (out, in, 1)) and apply them as the JAX package's ``Dense`` layers, on
  (..., P, C) inputs;
- ``sample_points``: bilinear samples of (N, C, h, w) maps at (N, P, 2)
  normalized points (the JAX package's ``_sample_chw``: corners clipped to
  the map, weights to [0, 1]), through the RoIAlign gather
  (``ops/roi_align.gather_rows``), whose backward repeats bit for bit on
  the card;
- ``uncertain_points_train``: the ``importance_ratio`` most uncertain of
  the oversampled points (-|logit| of the label's coarse logit, ties to the
  lower index as ``jax.lax.top_k``), then the fill points. The JAX package
  draws both sets with threefry inside; here they are arguments (the
  train step's generator, ``two_stage.sampler_draws``);
- ``point_targets_from_crops``: each point's GT occupancy, sampled from
  its RoI's GT mask crop (zero outside the GT box);
- ``fine_grained_point_feats``: P2 sampled at RoI-relative points;
- ``point_rend_refine``: ``subdivision_steps`` times, a 2x bilinear
  upsample (``jax.image.resize``'s, ``ops/resize.py``), the
  ``num_points`` most uncertain cells of the label's class (ties to the
  lower index), the point head on them, and their logits written into the
  upsampled grid. The JAX package blends a (B, N, k, H*W) one-hot (0.49 GB
  at B=8); the top-k cells are distinct, so a scatter gives the same
  values;
- ``point_branch_loss``: the point head's BCE at the label's class against
  the crops' occupancy, over the positives' points.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dsl_tpu_torch.core.nms import _sort_desc
from dsl_tpu_torch.models.dense_heads.yolact_head import _bilinear_1ch
from dsl_tpu_torch.models.layers import he_normal_
from dsl_tpu_torch.ops.resize import resize_bilinear
from dsl_tpu_torch.ops.roi_align import gather_rows
from dsl_tpu_torch.registry import HEADS

TRAIN_POINTS = 196            # _point_branch_loss's num_points in JAX
OVERSAMPLE_RATIO = 3.0        # uncertain_points_train's defaults
IMPORTANCE_RATIO = 0.75


class _ConvModule(nn.Module):
    """mmcv ``ConvModule`` of a conv and relu (``.conv``)."""

    def __init__(self, conv: nn.Module):
        super().__init__()
        self.conv = conv

    def forward(self, x):
        return F.relu(self.conv(x))


@HEADS.register
class CoarseMaskHead(nn.Module):
    def __init__(self, num_classes: int = 80, in_channels: int = 256,
                 roi_size: int = 14, num_convs: int = 0,
                 conv_out_channels: int = 256, num_fcs: int = 2,
                 fc_out_channels: int = 1024, downsample_factor: int = 2):
        super().__init__()
        self.num_classes = num_classes
        self.in_channels = in_channels
        self.roi_size = roi_size
        self.output_size = roi_size // downsample_factor
        chans = [in_channels] + [conv_out_channels] * num_convs
        self.convs = nn.ModuleList(
            _ConvModule(nn.Conv2d(chans[i], chans[i + 1], 3, padding=1))
            for i in range(num_convs))
        d = downsample_factor
        self.downsample_conv = (
            _ConvModule(nn.Conv2d(chans[-1], conv_out_channels, d, stride=d))
            if d > 1 else None)
        last = conv_out_channels if d > 1 else chans[-1]
        fc_in = [last * self.output_size ** 2] + [fc_out_channels] * num_fcs
        self.fcs = nn.ModuleList(nn.Linear(fc_in[i], fc_in[i + 1])
                                 for i in range(num_fcs))
        self.fc_logits = nn.Linear(fc_in[-1],
                                   num_classes * self.output_size ** 2)

    def init_weights(self, generator: torch.Generator | None = None):
        """He-normal convs, Xavier-uniform FCs (mmdet's), normal 0.001
        logits (the JAX head's), zero biases."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                he_normal_(m.weight, generator)
                nn.init.zeros_(m.bias)
        for fc in self.fcs:
            nn.init.xavier_uniform_(fc.weight, generator=generator)
            nn.init.zeros_(fc.bias)
        nn.init.normal_(self.fc_logits.weight, 0.0, 0.001, generator=generator)
        nn.init.zeros_(self.fc_logits.bias)

    def forward(self, roi_feats: torch.Tensor) -> torch.Tensor:
        """roi_feats (N, C, roi, roi) -> coarse logits (N, classes, s, s)."""
        x = roi_feats
        for conv in self.convs:
            x = conv(x)
        if self.downsample_conv is not None:
            x = self.downsample_conv(x)
        x = x.reshape(x.shape[0], -1)
        for fc in self.fcs:
            x = F.relu(fc(x))
        s = self.output_size
        return self.fc_logits(x).reshape(x.shape[0], self.num_classes, s, s)


class _PointFC(nn.Module):
    """mmcv ``ConvModule`` of a ``Conv1d`` (``.conv``) and relu, applied
    per point as a linear layer."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv1d(in_channels, out_channels, 1)

    def forward(self, x):
        return F.relu(F.linear(x, self.conv.weight[:, :, 0], self.conv.bias))


@HEADS.register
class MaskPointHead(nn.Module):
    def __init__(self, num_classes: int = 80, num_fcs: int = 3,
                 in_channels: int = 256, fc_channels: int = 256,
                 coarse_pred_each_layer: bool = True):
        super().__init__()
        self.num_classes = num_classes
        self.in_channels = in_channels
        self.coarse_pred_each_layer = coarse_pred_each_layer
        fcs, cin = [], in_channels + num_classes
        for _ in range(num_fcs):
            fcs.append(_PointFC(cin, fc_channels))
            cin = fc_channels + (num_classes if coarse_pred_each_layer else 0)
        self.fcs = nn.ModuleList(fcs)
        self.fc_logits = nn.Conv1d(cin, num_classes, 1)

    def init_weights(self, generator: torch.Generator | None = None):
        """He-normal FCs, normal 0.001 logits (the JAX head's), zero
        biases."""
        for fc in self.fcs:
            he_normal_(fc.conv.weight, generator)
            nn.init.zeros_(fc.conv.bias)
        nn.init.normal_(self.fc_logits.weight, 0.0, 0.001, generator=generator)
        nn.init.zeros_(self.fc_logits.bias)

    def forward(self, fine: torch.Tensor, coarse: torch.Tensor) -> torch.Tensor:
        """fine (..., P, C_in), coarse (..., P, classes) -> logits (..., P,
        classes)."""
        x = torch.cat([fine, coarse], dim=-1)
        for fc in self.fcs:
            x = fc(x)
            if self.coarse_pred_each_layer:
                x = torch.cat([x, coarse], dim=-1)
        return F.linear(x, self.fc_logits.weight[:, :, 0], self.fc_logits.bias)


def sample_points(maps: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of maps (N, C, h, w) at points (N, P, 2) (x, y in
    [0, 1] of the map) -> (N, P, C): the JAX package's ``_sample_chw``."""
    n, c, h, w = maps.shape
    ys = pts[..., 1] * h - 0.5
    xs = pts[..., 0] * w - 0.5
    y0 = torch.floor(ys).clamp(0, h - 1)
    x0 = torch.floor(xs).clamp(0, w - 1)
    y1 = (y0 + 1).clamp(0, h - 1)
    x1 = (x0 + 1).clamp(0, w - 1)
    wy = (ys - y0).clamp(0.0, 1.0)
    wx = (xs - x0).clamp(0.0, 1.0)
    base = torch.arange(n, device=maps.device)[:, None] * (h * w)
    y0, x0, y1, x1 = (v.to(torch.int64) for v in (y0, x0, y1, x1))
    idx = torch.stack([base + y0 * w + x0, base + y0 * w + x1,
                       base + y1 * w + x0, base + y1 * w + x1])
    wts = torch.stack([(1 - wy) * (1 - wx), (1 - wy) * wx, wy * (1 - wx),
                       wy * wx])
    table = maps.permute(0, 2, 3, 1).reshape(-1, c)
    valid = torch.ones((n,), dtype=torch.bool, device=maps.device)
    return gather_rows(table, idx[..., None], wts[..., None], valid)[:, :, 0]


def uncertain_points_train(oversampled: torch.Tensor, fill: torch.Tensor | None,
                           coarse_logits: torch.Tensor, labels: torch.Tensor,
                           num_points: int = TRAIN_POINTS,
                           importance_ratio: float = IMPORTANCE_RATIO
                           ) -> torch.Tensor:
    """Importance sampling of RoI-relative points: of the uniform points
    ``oversampled`` (N, S, 2), the ``int(importance_ratio * num_points)``
    where the label's coarse logit (coarse_logits (N, C, h, w), labels
    (N,)) is nearest 0, then ``fill`` (N, num_points - those, 2). Returns
    (N, num_points, 2)."""
    nc, h, w = coarse_logits.shape[1:]
    cls = labels.reshape(-1).to(torch.int64).clamp(0, nc - 1)
    with torch.no_grad():
        sel = torch.gather(coarse_logits.detach(), 1,
                           cls[:, None, None, None].expand(-1, 1, h, w))
        uncertainty = -sample_points(sel, oversampled)[..., 0].abs()
        _, idx = _sort_desc(uncertainty, int(importance_ratio * num_points))
    imp = torch.gather(oversampled, 1, idx[..., None].expand(-1, -1, 2))
    return imp if fill is None or fill.shape[1] == 0 else torch.cat(
        [imp, fill], dim=1)


def point_targets_from_crops(crops: torch.Tensor, gt_boxes: torch.Tensor,
                             rois: torch.Tensor,
                             rel_points: torch.Tensor) -> torch.Tensor:
    """GT occupancy at RoI-relative points: crops (N, M, M) of each RoI's
    GT, gt_boxes (N, 4), rois (N, 4), rel_points (N, P, 2) in [0, 1] of the
    RoI -> (N, P), sampled from the crop, zero outside the GT box."""
    ax = rois[:, 0:1] + rel_points[..., 0] * (rois[:, 2:3] - rois[:, 0:1])
    ay = rois[:, 1:2] + rel_points[..., 1] * (rois[:, 3:4] - rois[:, 1:2])
    floor = gt_boxes.new_full((), 1e-3)
    gw = torch.maximum(gt_boxes[:, 2:3] - gt_boxes[:, 0:1], floor)
    gh = torch.maximum(gt_boxes[:, 3:4] - gt_boxes[:, 1:2], floor)
    nx = (ax - gt_boxes[:, 0:1]) / gw
    ny = (ay - gt_boxes[:, 1:2]) / gh
    inside = (nx >= 0) & (nx <= 1) & (ny >= 0) & (ny <= 1)
    m = crops.shape[-1]
    vals = _bilinear_1ch(crops.to(torch.float32), (ny * m - 0.5)[..., None],
                         (nx * m - 0.5)[..., None])[..., 0]
    return torch.where(inside, vals, vals.new_zeros(()))


def fine_grained_point_feats(p2: torch.Tensor, rois: torch.Tensor,
                             rel_points: torch.Tensor,
                             stride: int = 4) -> torch.Tensor:
    """P2 (B, C, H, W) sampled at RoI-relative points: rois (B, N, 4) in
    the input's frame, rel_points (B, N, P, 2) -> (B, N, P, C)."""
    b, _, h, w = p2.shape
    n, p = rel_points.shape[1:3]
    ax = rois[..., 0:1] + rel_points[..., 0] * (rois[..., 2:3] - rois[..., 0:1])
    ay = rois[..., 1:2] + rel_points[..., 1] * (rois[..., 3:4] - rois[..., 1:2])
    # divided by device tensors, as the CPU (and JAX) divide
    norm = torch.stack([ax / ax.new_full((), float(w * stride)),
                        ay / ay.new_full((), float(h * stride))], dim=-1)
    return sample_points(p2, norm.reshape(b, n * p, 2)).reshape(b, n, p, -1)


def point_rend_refine(coarse_logits: torch.Tensor, p2: torch.Tensor,
                      rois: torch.Tensor, labels: torch.Tensor, point_fn,
                      subdivision_steps: int = 2, num_points: int = 196,
                      stride: int = 4) -> torch.Tensor:
    """Test-time subdivision: coarse_logits (B, N, C, h, w), P2, the
    detections' rois (B, N, 4) in the input's frame and labels (B, N);
    ``point_fn(fine (B, N, k, C_in), coarse (B, N, k, C)) -> (B, N, k,
    C)`` is the point head. Returns (B, N, C, h * 2^s, w * 2^s)."""
    b, n, c = coarse_logits.shape[:3]
    cls = labels.to(torch.int64).clamp(0, c - 1)
    refined = coarse_logits
    for _ in range(subdivision_steps):
        bh, bw = refined.shape[3] * 2, refined.shape[4] * 2
        refined = resize_bilinear(refined, (bh, bw))
        sel = torch.gather(refined, 2, cls[:, :, None, None, None].expand(
            b, n, 1, bh, bw))
        unc = -sel.reshape(b, n, bh * bw).abs()
        k = min(num_points, bh * bw)
        _, idx = _sort_desc(unc, k)                          # (B, N, k)
        xs = (idx % bw).to(torch.float32)
        ys = (idx // bw).to(torch.float32)
        pts = torch.stack([(xs + 0.5) / bw, (ys + 0.5) / bh], dim=-1)
        fine = fine_grained_point_feats(p2, rois, pts, stride=stride)
        coarse_pts = sample_points(
            coarse_logits.reshape(b * n, *coarse_logits.shape[2:]),
            pts.reshape(b * n, k, 2)).reshape(b, n, k, c)
        point_logits = point_fn(fine, coarse_pts)            # (B, N, k, C)
        refined = refined.reshape(b, n, c, bh * bw).scatter(
            3, idx[:, :, None, :].expand(b, n, c, k),
            point_logits.transpose(2, 3)).reshape(b, n, c, bh, bw)
    return refined


def point_branch_loss(point_fn, p2: torch.Tensor, coarse_logits: torch.Tensor,
                      rel_points: torch.Tensor, rois: torch.Tensor,
                      labels: torch.Tensor, assigned: torch.Tensor,
                      is_pos: torch.Tensor, batch: dict,
                      stride: int = 4) -> torch.Tensor:
    """``loss_point``: the positive RoIs' (rois, labels, assigned, is_pos,
    each (B, P, ...)) coarse logits (B*P, C, s, s) sampled at their points
    rel_points (B*P, Pt, 2) beside P2's, the point head (``point_fn``), the
    BCE at the label's class against the GT crop's occupancy, summed over
    the positives' points and divided by their count."""
    b, p = rois.shape[:2]
    npt = rel_points.shape[1]
    nc = coarse_logits.shape[1]
    fine = fine_grained_point_feats(p2, rois, rel_points.reshape(b, p, npt, 2),
                                    stride=stride)
    coarse_pts = sample_points(coarse_logits, rel_points)   # (BP, Pt, C)
    point_logits = point_fn(fine.reshape(b * p, npt, -1), coarse_pts)
    gi = assigned.clamp_min(0).to(torch.int64)
    gt_boxes = torch.gather(batch["gt_bboxes"], 1,
                            gi[..., None].expand(b, p, 4)).reshape(-1, 4)
    crops = batch["gt_mask_crops"]
    m = crops.shape[-1]
    crops = torch.gather(crops, 1, gi[..., None, None].expand(b, p, m, m))
    targets = point_targets_from_crops(crops.reshape(-1, m, m), gt_boxes,
                                       rois.reshape(-1, 4), rel_points)
    cls = labels.reshape(-1).to(torch.int64).clamp(0, nc - 1)
    sel = torch.gather(point_logits, -1,
                       cls[:, None, None].expand(-1, npt, 1))[..., 0]
    bce = -targets * F.logsigmoid(sel) - (1 - targets) * F.logsigmoid(-sel)
    pos = is_pos.reshape(-1).to(torch.float32)
    return (bce * pos[:, None]).sum() / torch.clamp_min(pos.sum() * npt, 1.0)
