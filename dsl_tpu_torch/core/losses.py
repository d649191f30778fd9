"""Functional losses of the FCOS, RPN, RoI and RetinaNet heads, in torch.

Counterpart of the part of ``dsl_tpu/core/losses.py`` that the ported
heads use: ``weight_reduce_loss``, ``sigmoid_focal_loss``,
``binary_cross_entropy``, ``giou_loss``, ``iou_loss``,
``bounded_iou_loss``, ``cross_entropy``, ``smooth_l1_loss`` and ``l1_loss``. They follow mmdet's contract: an optional
elementwise ``weight``, a ``reduction`` in {'none', 'mean', 'sum'}, and an
``avg_factor`` that replaces the denominator of 'mean'. Everything is dense
over fixed shapes, with masking by weight, so a point of weight 0 still
takes part (and its gradient must stay finite).

``max(x, c)`` is ``torch.maximum`` against a tensor, as ``jnp.maximum`` is,
so a tie splits the gradient as it does in JAX.
"""

from __future__ import annotations

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
