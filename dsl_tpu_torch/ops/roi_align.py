"""RoIAlign as gathers from a row table, with a deterministic backward.

Counterpart of ``dsl_tpu/ops/roi_align.py::roi_align`` (plain JAX, not a
Pallas kernel) in the form the RoI head runs it: aligned RoIAlign
(``aligned=True``: the half-pixel offset, a width floor of 1e-6; without
it no offset and a floor of 1), ``sampling_ratio`` samples per bin and axis
(2 where it is not positive: no adaptive count, as in JAX), each sample
bilinear from its 4 neighbours with the coordinate clipped to the map
(JAX's rule; mmcv zeroes a sample outside the map), the samples of a bin
averaged; an invalid RoI gives zeros.

The features are a row table ``(rows, C)``: one level's NHWC rows, or
several levels' one after another. A RoI's sample at (y, x) of its level
reads rows ``base + y * W + x``, where ``base`` is the row of its image on
its level, so the multi-level extract gathers every RoI from its own level
in one pass (the JAX package computes every RoI on every level and masks).

Forward: for each of the ``s * s`` samples of a bin and each of its 4
neighbours, one gather of (N, oh, ow, C) rows, weighted and summed. The
backward is the transpose: the weighted output gradients put back into a
zero table with ``index_put_(accumulate=True)`` under PyTorch's
deterministic algorithms (scoped to that call): on the card it sorts the
indices and sums each row's contributions in one order, so two backward
passes give the same bits, where ``index_add_`` / ``scatter_add_`` would
add with atomics in whatever order the threads run. Where the weights
need a gradient (a deformable sample's offsets reach the output through
them), it is each gathered row times the output's gradient summed over
the channels: no scatter.

``deform_roi_align_rows`` is the JAX package's ``deform_roi_align``
(deformable RoI pooling) on the same row table: each bin's samples
shifted by a learned offset, gathered the same way.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _deterministic():
    """PyTorch's deterministic algorithms for the block; the process's own
    setting comes back after it."""
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])


class _GatherRows(torch.autograd.Function):
    """out[n, ...] = sum_t table[idx[t, n, ...]] * w[t, n, ...], zero where
    ``valid[n]`` is False (no mask where ``valid`` is None)."""

    @staticmethod
    def forward(ctx, table, idx, w, valid):
        out = None
        for t in range(idx.shape[0]):
            term = table[idx[t]].mul_(w[t][..., None])
            out = term if out is None else out.add_(term)
        if valid is not None:
            out = torch.where(_rows_of(valid, out), out, out.new_zeros(()))
        # the table is kept only for the weights' gradient
        ctx.save_for_backward(table if ctx.needs_input_grad[2] else None,
                              idx, w, valid)
        ctx.rows = table.shape[0]
        return out

    @staticmethod
    def backward(ctx, grad_out):
        table, idx, w, valid = ctx.saved_tensors
        grad = (grad_out if valid is None else torch.where(
            _rows_of(valid, grad_out), grad_out, grad_out.new_zeros(())))
        table_grad = w_grad = None
        if ctx.needs_input_grad[0]:
            c = grad.shape[-1]
            values = (grad[None] * w[..., None]).reshape(-1, c)
            table_grad = grad.new_zeros((ctx.rows, c))
            with _deterministic():
                table_grad.index_put_((idx.reshape(-1),), values,
                                      accumulate=True)
        if ctx.needs_input_grad[2]:
            # the weights' gradient is a sum over the channels of each row:
            # no scatter, so it repeats without more care
            w_grad = torch.stack([(table[idx[t]] * grad).sum(-1)
                                  for t in range(idx.shape[0])])
        return table_grad, None, w_grad, None


def _rows_of(valid: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``valid`` (N,) shaped to broadcast over ``out`` (N, ...)."""
    return valid.reshape(valid.shape + (1,) * (out.dim() - 1))


def gather_rows(table: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                valid: torch.Tensor | None = None) -> torch.Tensor:
    """out[n, ...] = sum_t table[idx[t, n, ...]] * w[t, n, ...] (zero where
    ``valid[n]`` is False), whose backward puts the gradients back into the
    table in one order (the RoIAlign gather; PointRend's point samples and
    deformable convolution read it too) and gives the weights' gradient
    where they need one (a deformable sample's offsets reach the output
    through its bilinear weights)."""
    return _GatherRows.apply(table, idx, w, valid)


def _axis_taps(lo, extent, size, n_out: int, s: int, aligned: bool):
    """Sample positions along one axis of each RoI, clipped to the map:
    (low index, high index, fraction), each (N, n_out, s)."""
    extent = torch.maximum(extent, extent.new_full((), 1e-6 if aligned else 1.0))
    # a device tensor, not a python number: CUDA divides by a host scalar
    # as a multiply by its reciprocal, which rounds otherwise than the
    # CPU's (and JAX's) division by 7
    bin_size = (extent / extent.new_full((), float(n_out)))[:, None, None]
    i = torch.arange(n_out, dtype=lo.dtype, device=lo.device)[None, :, None]
    k = torch.arange(s, dtype=lo.dtype, device=lo.device)[None, None, :]
    pos = i * bin_size + (k + 0.5) * bin_size / s + lo[:, None, None]
    top = (size - 1).to(lo.dtype)[:, None, None]
    pos = torch.minimum(torch.maximum(pos, pos.new_zeros(())), top)
    p0 = torch.floor(pos)
    i0 = p0.to(torch.int64)
    i1 = torch.minimum(i0 + 1, (size - 1)[:, None, None])
    return i0, i1, pos - p0


def sample_taps(rois: torch.Tensor, base: torch.Tensor, height: torch.Tensor,
                width: torch.Tensor, spatial_scale: torch.Tensor,
                out_size=(7, 7), sampling_ratio: int = 2,
                aligned: bool = True):
    """The table rows each output bin reads and their weights: idx and w,
    each (T, N, oh, ow), T = 4 neighbours x ``s * s`` samples; the bin's
    mean is folded into w (1/(s*s), a power of two for s = 2, so the
    products round as JAX's sum / 4). Arguments as
    :func:`roi_align_rows`."""
    oh, ow = out_size
    s = sampling_ratio if sampling_ratio > 0 else 2
    offset = 0.5 if aligned else 0.0
    x1 = rois[:, 0] * spatial_scale - offset
    y1 = rois[:, 1] * spatial_scale - offset
    x2 = rois[:, 2] * spatial_scale - offset
    y2 = rois[:, 3] * spatial_scale - offset
    ys = _axis_taps(y1, y2 - y1, height, oh, s, aligned)
    xs = _axis_taps(x1, x2 - x1, width, ow, s, aligned)
    idx, wts = [], []
    for sy in range(s):
        rows = [(ys[0][..., sy], 1 - ys[2][..., sy]),
                (ys[1][..., sy], ys[2][..., sy])]
        for sx in range(s):
            cols = [(xs[0][..., sx], 1 - xs[2][..., sx]),
                    (xs[1][..., sx], xs[2][..., sx])]
            for r, wy in rows:
                for c, wx in cols:
                    idx.append(base[:, None, None]
                               + r[:, :, None] * width[:, None, None]
                               + c[:, None, :])
                    wts.append(wy[:, :, None] * wx[:, None, :] / (s * s))
    return torch.stack(idx), torch.stack(wts)


def roi_align_rows(table: torch.Tensor, rois: torch.Tensor,
                   base: torch.Tensor, height: torch.Tensor,
                   width: torch.Tensor, spatial_scale: torch.Tensor,
                   valid: torch.Tensor, out_size=(7, 7),
                   sampling_ratio: int = 2, aligned: bool = True
                   ) -> torch.Tensor:
    """RoIAlign of N RoIs from a row table.

    table (rows, C); rois (N, 4) image-coordinate corners; base, height,
    width (N,) int64: the table row of the RoI's image at (0, 0) of its
    level and the level's size; spatial_scale (N,) f32 (1 / stride);
    valid (N,) bool. Returns (N, oh, ow, C).
    """
    idx, w = sample_taps(rois, base, height, width, spatial_scale, out_size,
                         sampling_ratio, aligned)
    return _GatherRows.apply(table, idx, w, valid)


def _rows(features: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> the (B*H*W, C) row table of its NHWC layout."""
    return features.permute(0, 2, 3, 1).reshape(-1, features.shape[1])


def roi_align(features: torch.Tensor, rois: torch.Tensor, out_size=(7, 7),
              spatial_scale: float = 1.0, sampling_ratio: int = -1,
              aligned: bool = True, valid: torch.Tensor | None = None
              ) -> torch.Tensor:
    """RoIAlign over a batch of feature maps.

    features (B, C, H, W); rois (N, 5) rows ``(batch_idx, x1, y1, x2, y2)``
    in image coordinates; valid optional (N,) bool (an invalid RoI gives
    zeros). Returns (N, C, oh, ow).
    """
    b, _, h, w = features.shape
    n = rois.shape[0]
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=rois.device)
    bidx = rois[:, 0].to(torch.int64).clamp(0, b - 1)
    full = torch.full_like(bidx, 1)
    out = roi_align_rows(
        _rows(features), rois[:, 1:5], bidx * (h * w), full * h, full * w,
        torch.full_like(rois[:, 0], spatial_scale), valid, out_size,
        sampling_ratio, aligned)
    return out.permute(0, 3, 1, 2)



def deform_roi_align_rows(table: torch.Tensor, rois: torch.Tensor,
                          offsets: torch.Tensor, base: torch.Tensor,
                          height: torch.Tensor, width: torch.Tensor,
                          spatial_scale: torch.Tensor, valid: torch.Tensor,
                          out_size=(7, 7), sampling_ratio: int = 2,
                          gamma: float = 0.1) -> torch.Tensor:
    """Deformable RoI pooling of N RoIs from a row table: aligned RoIAlign
    whose bin (i, j) samples are shifted by ``gamma * (roi_w, roi_h) *
    offsets[n, i, j]`` (``offsets`` (N, oh, ow, 2) as (dx, dy), the JAX
    package's layout; mmcv's ``DeformRoIPool`` kernel's shift), each sample
    clipped to the map as RoIAlign's. The positions are the JAX function's,
    term by term: ``y1 + (i + (k + 0.5) / s) * bin_h + gamma * rh * dy``.
    Gradients reach the table and the offsets (through the bilinear
    weights, the clip splitting its gradient at a bound as ``jnp.clip``'s
    does). Other arguments as :func:`roi_align_rows`; returns (N, oh, ow,
    C)."""
    oh, ow = out_size
    s = sampling_ratio if sampling_ratio > 0 else 2
    x1 = rois[:, 0] * spatial_scale - 0.5
    y1 = rois[:, 1] * spatial_scale - 0.5
    x2 = rois[:, 2] * spatial_scale - 0.5
    y2 = rois[:, 3] * spatial_scale - 0.5
    floor = x1.new_full((), 1e-6)
    rw = torch.maximum(x2 - x1, floor)
    rh = torch.maximum(y2 - y1, floor)

    def axis(lo, extent, n_out: int, shift):
        # (N, n_out) bins x (s,) samples, broadcast to (N, oh, ow, s, s)
        bin_size = extent / extent.new_full((), float(n_out))
        i = torch.arange(n_out, dtype=lo.dtype, device=lo.device)[:, None]
        k = torch.arange(s, dtype=lo.dtype, device=lo.device)[None, :]
        t = i + (k + 0.5) / s
        return (lo[:, None, None] + t[None] * bin_size[:, None, None],
                (gamma * extent)[:, None, None] * shift)

    dx, dy = offsets[..., 0], offsets[..., 1]
    ty, sy = axis(y1, rh, oh, dy)
    tx, sx = axis(x1, rw, ow, dx)
    # (N, oh, ow, s, s): row i's sample k on y, column j's sample l on x
    ys = ty[:, :, None, :, None] + sy[..., None, None]
    xs = tx[:, None, :, None, :] + sx[..., None, None]
    top = (height - 1).to(ys.dtype)
    right = (width - 1).to(xs.dtype)
    y = torch.minimum(torch.maximum(ys, ys.new_zeros(())),
                      top[:, None, None, None, None])
    x = torch.minimum(torch.maximum(xs, xs.new_zeros(())),
                      right[:, None, None, None, None])
    y0f, x0f = torch.floor(y), torch.floor(x)
    ly, lx = y - y0f, x - x0f
    y0, x0 = y0f.to(torch.int64), x0f.to(torch.int64)
    y1i = torch.minimum(y0 + 1, (height - 1)[:, None, None, None, None])
    x1i = torch.minimum(x0 + 1, (width - 1)[:, None, None, None, None])
    w_ = width[:, None, None, None, None]
    b_ = base[:, None, None, None, None]
    idx = torch.stack([b_ + y0 * w_ + x0, b_ + y0 * w_ + x1i,
                       b_ + y1i * w_ + x0, b_ + y1i * w_ + x1i])
    hy, hx = 1 - ly, 1 - lx
    # the bin's mean folded in: 1 / (s * s), a power of two for s = 2
    wts = torch.stack([hy * hx, hy * lx, ly * hx, ly * lx]) / (s * s)
    # (4, N, oh, ow, s, s) -> (4 * s * s, N, oh, ow)
    idx = idx.permute(0, 4, 5, 1, 2, 3).reshape(4 * s * s, *idx.shape[1:4])
    wts = wts.permute(0, 4, 5, 1, 2, 3).reshape(4 * s * s, *wts.shape[1:4])
    return gather_rows(table, idx, wts, valid)


def deform_roi_align(features: torch.Tensor, rois: torch.Tensor,
                     offsets: torch.Tensor, out_size=(7, 7),
                     spatial_scale: float = 1.0, sampling_ratio: int = -1,
                     gamma: float = 0.1, valid: torch.Tensor | None = None
                     ) -> torch.Tensor:
    """Deformable RoI pooling over a batch of feature maps (the JAX
    package's ``deform_roi_align``): features (B, C, H, W); rois (N, 5)
    ``(batch_idx, x1, y1, x2, y2)``; offsets (N, oh, ow, 2) per-bin (dx,
    dy); valid optional (N,). Returns (N, C, oh, ow)."""
    b, _, h, w = features.shape
    n = rois.shape[0]
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=rois.device)
    bidx = rois[:, 0].to(torch.int64).clamp(0, b - 1)
    full = torch.full_like(bidx, 1)
    out = deform_roi_align_rows(
        _rows(features), rois[:, 1:5], offsets, bidx * (h * w), full * h,
        full * w, torch.full_like(rois[:, 0], spatial_scale), valid,
        out_size, sampling_ratio, gamma)
    return out.permute(0, 3, 1, 2)
