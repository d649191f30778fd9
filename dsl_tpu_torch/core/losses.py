"""Functional losses of the FCOS, RPN, RoI and RetinaNet heads, in torch.

Counterpart of the part of ``dsl_tpu/core/losses.py`` that the ported
heads use: ``weight_reduce_loss``, ``sigmoid_focal_loss``,
``binary_cross_entropy``, ``giou_loss``, ``iou_loss``,
``bounded_iou_loss``, ``cross_entropy``, ``smooth_l1_loss``, ``l1_loss``,
``balanced_l1_loss`` (Libra R-CNN's),
``varifocal_loss`` (VFNet's), and the Seesaw loss of the split (C + 2) RoI classifier (``seesaw_ce_loss``,
``seesaw_loss``, ``SeesawCounter``). They follow mmdet's contract: an optional
elementwise ``weight``, a ``reduction`` in {'none', 'mean', 'sum'}, and an
``avg_factor`` that replaces the denominator of 'mean'. Everything is dense
over fixed shapes, with masking by weight, so a point of weight 0 still
takes part (and its gradient must stay finite).

``max(x, c)`` is ``torch.maximum`` against a tensor, as ``jnp.maximum`` is,
so a tie splits the gradient as it does in JAX.
"""

from __future__ import annotations

import math

import torch

from dsl_tpu_torch.core.boxes import bbox_overlaps


def weight_reduce_loss(loss: torch.Tensor, weight: torch.Tensor | None = None,
                       reduction: str = "mean", avg_factor=None):
    if weight is not None:
        loss = loss * weight
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    if reduction == "mean":
        if avg_factor is None:
            return loss.mean()
        if isinstance(avg_factor, torch.Tensor):
            return loss.sum() / avg_factor.clamp_min(1e-12)
        return loss.sum() / max(float(avg_factor), 1e-12)
    raise ValueError(reduction)


def _bce_with_logits(logits: torch.Tensor, targets: torch.Tensor):
    """max(x, 0) - x*t + log1p(exp(-|x|)), the JAX package's stable form.
    |x| is written so that its gradient at 0 is 1, as ``jnp.abs``'s is
    (``Tensor.abs`` gives 0 there)."""
    abs_x = torch.where(logits >= 0, logits, -logits)
    return (torch.maximum(logits, logits.new_zeros(())) - logits * targets
            + torch.log1p(torch.exp(-abs_x)))


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor,
                       gamma: float = 2.0, alpha: float = 0.25,
                       weight: torch.Tensor | None = None,
                       reduction: str = "mean", avg_factor=None):
    """Sigmoid focal loss over (..., C) logits.

    ``targets``: integer class indices (...,) where ``C`` is background (its
    one-hot row is all zeros, as ``jax.nn.one_hot`` gives), or float
    (..., C) soft targets. ``weight`` broadcasts to (...,) or (..., C).
    """
    c = logits.shape[-1]
    if targets.is_floating_point():
        onehot = targets
    else:
        classes = torch.arange(c, device=logits.device)
        onehot = (targets[..., None] == classes).to(logits.dtype)
    p = torch.sigmoid(logits)
    ce = _bce_with_logits(logits, onehot)
    p_t = p * onehot + (1 - p) * (1 - onehot)
    alpha_t = alpha * onehot + (1 - alpha) * (1 - onehot)
    loss = alpha_t * torch.pow(1 - p_t, gamma) * ce
    if weight is not None and weight.dim() == loss.dim() - 1:
        weight = weight[..., None]
    return weight_reduce_loss(loss, weight, reduction, avg_factor)


def varifocal_loss(logits: torch.Tensor, targets: torch.Tensor,
                   alpha: float = 0.75, gamma: float = 2.0,
                   iou_weighted: bool = True,
                   weight: torch.Tensor | None = None,
                   reduction: str = "mean", avg_factor=None):
    """Varifocal loss over (..., C) logits: BCE against the IoU-aware
    targets (the IoU at a positive's class, 0 elsewhere), a positive
    weighted by its target (1 without ``iou_weighted``), a negative by
    ``alpha * |sigmoid - target| ** gamma`` with the sigmoid detached."""
    sigma = torch.sigmoid(logits)
    pos = (targets > 0).to(logits.dtype)
    neg_w = alpha * torch.pow(torch.abs(sigma.detach() - targets), gamma) \
        * (1 - pos)
    focal_w = (targets * pos if iou_weighted else pos) + neg_w
    loss = _bce_with_logits(logits, targets) * focal_w
    if weight is not None and weight.dim() == loss.dim() - 1:
        weight = weight[..., None]
    return weight_reduce_loss(loss, weight, reduction, avg_factor)


def binary_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                         weight: torch.Tensor | None = None,
                         reduction: str = "mean", avg_factor=None):
    """BCE with logits (the centerness loss)."""
    return weight_reduce_loss(_bce_with_logits(logits, targets), weight,
                              reduction, avg_factor)


def _iou_for_loss(pred: torch.Tensor, target: torch.Tensor, mode: str,
                  eps: float = 1e-6) -> torch.Tensor:
    """Aligned IoU / GIoU of (..., 4) decoded boxes."""
    return bbox_overlaps(pred, target, mode=mode, is_aligned=True, eps=eps)


def iou_loss(pred: torch.Tensor, target: torch.Tensor,
             weight: torch.Tensor | None = None, eps: float = 1e-6,
             reduction: str = "mean", avg_factor=None):
    """-log(IoU), the IoU clipped to [eps, 1] as ``jnp.clip`` does (max,
    then min)."""
    ious = _iou_for_loss(pred, target, "iou", eps)
    ious = torch.minimum(torch.maximum(ious, ious.new_full((), eps)),
                         ious.new_ones(()))
    return weight_reduce_loss(-torch.log(ious), weight, reduction, avg_factor)


def giou_loss(pred: torch.Tensor, target: torch.Tensor,
              weight: torch.Tensor | None = None, eps: float = 1e-6,
              reduction: str = "mean", avg_factor=None):
    """1 - GIoU on decoded boxes."""
    return weight_reduce_loss(1.0 - _iou_for_loss(pred, target, "giou", eps),
                              weight, reduction, avg_factor)


def bounded_iou_loss(pred: torch.Tensor, target: torch.Tensor,
                     beta: float = 0.2, eps: float = 1e-3,
                     weight: torch.Tensor | None = None,
                     reduction: str = "mean", avg_factor=None):
    """Bounded IoU loss on decoded boxes: per box the 4-vector [dx, dy, dw,
    dh] of bounded IoU terms through a smooth-L1 envelope; no gradient
    reaches ``target``."""
    pcx = (pred[..., 0] + pred[..., 2]) * 0.5
    pcy = (pred[..., 1] + pred[..., 3]) * 0.5
    pw = pred[..., 2] - pred[..., 0]
    ph = pred[..., 3] - pred[..., 1]
    t = target.detach()
    tcx = (t[..., 0] + t[..., 2]) * 0.5
    tcy = (t[..., 1] + t[..., 3]) * 0.5
    tw = t[..., 2] - t[..., 0]
    th = t[..., 3] - t[..., 1]
    dx = _abs(tcx - pcx)
    dy = _abs(tcy - pcy)
    zero = pred.new_zeros(())
    loss_dx = 1 - torch.maximum((tw - 2 * dx) / (tw + 2 * dx + eps), zero)
    loss_dy = 1 - torch.maximum((th - 2 * dy) / (th + 2 * dy + eps), zero)
    loss_dw = 1 - torch.minimum(tw / (pw + eps), pw / (tw + eps))
    loss_dh = 1 - torch.minimum(th / (ph + eps), ph / (th + eps))
    comb = torch.stack([loss_dx, loss_dy, loss_dw, loss_dh], dim=-1)
    loss = torch.where(comb < beta, 0.5 * comb * comb / beta,
                       comb - 0.5 * beta)
    return weight_reduce_loss(loss, weight, reduction, avg_factor)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  weight: torch.Tensor | None = None,
                  reduction: str = "mean", avg_factor=None):
    """Softmax cross-entropy over the last axis, integer targets."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None].to(torch.int64))[..., 0]
    return weight_reduce_loss(nll, weight, reduction, avg_factor)


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with ``jnp.abs``'s gradient of 1 at 0."""
    return torch.where(x >= 0, x, -x)


def smooth_l1_loss(pred: torch.Tensor, target: torch.Tensor, beta: float = 1.0,
                   weight: torch.Tensor | None = None,
                   reduction: str = "mean", avg_factor=None):
    diff = _abs(pred - target)
    loss = torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)
    return weight_reduce_loss(loss, weight, reduction, avg_factor)


def l1_loss(pred: torch.Tensor, target: torch.Tensor,
            weight: torch.Tensor | None = None,
            reduction: str = "mean", avg_factor=None):
    return weight_reduce_loss(_abs(pred - target), weight, reduction,
                              avg_factor)


def balanced_l1_loss(pred: torch.Tensor, target: torch.Tensor,
                     beta: float = 1.0, alpha: float = 0.5,
                     gamma: float = 1.5, weight: torch.Tensor | None = None,
                     reduction: str = "mean", avg_factor=None):
    """Balanced L1 (Libra R-CNN): with b = e^(gamma / alpha) - 1, a
    log-shaped branch ``alpha / b * (b |d| + 1) * log1p(b |d| / beta) -
    alpha |d|`` below ``beta`` and ``gamma |d| + gamma / b - alpha * beta``
    from it, as the JAX package writes it."""
    diff = _abs(pred - target)
    b = math.e ** (gamma / alpha) - 1
    loss = torch.where(
        diff < beta,
        alpha / b * (b * diff + 1) * torch.log1p(b * diff / beta) - alpha * diff,
        gamma * diff + gamma / b - alpha * beta)
    return weight_reduce_loss(loss, weight, reduction, avg_factor)


def seesaw_ce_loss(cls_score: torch.Tensor, labels: torch.Tensor,
                   cum_samples: torch.Tensor, p: float = 0.8, q: float = 2.0,
                   eps: float = 1e-2, weight: torch.Tensor | None = None,
                   reduction: str = "mean", avg_factor=None):
    """Seesaw cross-entropy over (N, C) class logits, labels (N,) in [0, C):
    each other class's logit is raised by the log of its mitigation factor
    ``(N_j / N_i)^p`` where class j is rarer than the label i (cumulative
    counts ``cum_samples`` (C,), floored at 1) times its compensation factor
    ``(s_j / s_i)^q`` where its softmax score s_j (no gradient) passes the
    label's (floored at ``eps``). Each row's factors are computed from the
    label's count directly: the same divisions as the JAX package's (C, C)
    ratio matrix gathered at the labels."""
    labels = labels.to(torch.int64)
    nc = cls_score.shape[-1]
    onehot = (labels[..., None] == torch.arange(nc, device=labels.device)
              ).to(cls_score.dtype)
    seesaw = torch.ones_like(cls_score)
    one = cls_score.new_ones(())
    if p > 0:
        cs = torch.clamp_min(cum_samples.to(cls_score.dtype), 1.0)
        ratio = cs[None, :] / cs[labels][:, None]
        seesaw = seesaw * torch.where(ratio < 1.0, torch.pow(ratio, p), one)
    if q > 0:
        scores = torch.softmax(cls_score.detach(), dim=-1)
        self_s = torch.gather(scores, -1, labels[..., None])
        score_ratio = scores / torch.maximum(self_s, scores.new_full((), eps))
        seesaw = seesaw * torch.where(score_ratio > 1.0,
                                      torch.pow(score_ratio, q), one)
    adjusted = cls_score + torch.log(torch.maximum(
        seesaw, seesaw.new_full((), 1e-12))) * (1 - onehot)
    logp = torch.log_softmax(adjusted, dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    return weight_reduce_loss(nll, weight, reduction, avg_factor)


def seesaw_loss(cls_score: torch.Tensor, labels: torch.Tensor,
                cum_samples: torch.Tensor, num_classes: int, p: float = 0.8,
                q: float = 2.0, eps: float = 1e-2,
                weight: torch.Tensor | None = None, avg_factor=None):
    """The split head's loss: ``cls_score`` (N, C + 2) is C class logits and
    2 objectness logits, labels (N,) with C the background. Returns
    ``(loss_classes, loss_objectness, new_cum_samples)``: the counts
    (C + 1,) plus this call's labels (the background slot included), the
    objectness cross-entropy (positive 0, background 1) under ``weight``
    over ``avg_factor``, and :func:`seesaw_ce_loss` of the positives (their
    own average) on the new counts."""
    if cls_score.shape[-1] != num_classes + 2:
        raise ValueError(f"SeesawLoss reads C + 2 = {num_classes + 2} logits, "
                         f"got {cls_score.shape[-1]}")
    labels = labels.to(torch.int64)
    pos = labels < num_classes
    new_cum = cum_samples.index_add(
        0, labels.clamp(0, num_classes).reshape(-1),
        torch.ones(labels.numel(), dtype=cum_samples.dtype,
                   device=cum_samples.device))
    obj_logp = torch.log_softmax(cls_score[..., -2:], dim=-1)
    obj_labels = (~pos).to(torch.int64)
    loss_obj = weight_reduce_loss(
        -torch.gather(obj_logp, -1, obj_labels[..., None])[..., 0], weight,
        "mean", avg_factor)
    pos_w = pos.to(cls_score.dtype)
    if weight is not None:
        pos_w = pos_w * weight
    loss_classes = seesaw_ce_loss(
        cls_score[..., :-2], labels.clamp(0, num_classes - 1),
        new_cum[:num_classes], p=p, q=q, eps=eps, weight=pos_w,
        reduction="mean", avg_factor=torch.clamp_min(pos_w.sum(), 1.0))
    return loss_classes, loss_obj, new_cum


class SeesawCounter:
    """The running per-class sample counts that ``SeesawLoss`` reads, kept
    by the train loop: C + 1 entries starting at one, each batch's valid GT
    labels added before its step (``update``), then passed in as
    ``batch["cum_samples"]``. The counts stay on ``device``: an update adds
    ones and zeros, which sum exactly in any order."""

    def __init__(self, num_classes: int, device="cpu"):
        self.num_classes = num_classes
        self.counts = torch.ones((num_classes + 1,), dtype=torch.float32,
                                 device=device)

    def update(self, gt_labels: torch.Tensor,
               gt_valid: torch.Tensor | None = None) -> torch.Tensor:
        labels = gt_labels.reshape(-1).to(torch.int64).clamp(
            0, self.num_classes)
        ones = (torch.ones(labels.shape, dtype=torch.float32,
                           device=labels.device) if gt_valid is None
                else gt_valid.reshape(-1).to(torch.float32))
        self.counts.index_add_(0, labels.to(self.counts.device),
                               ones.to(self.counts.device))
        return self.counts
