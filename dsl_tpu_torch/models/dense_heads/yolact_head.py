"""The part of YOLACT's head that HTC's semantic target reads.

Counterpart of ``paste_gt_crops`` and ``_bilinear_1ch`` in
``dsl_tpu/models/dense_heads/yolact_head.py`` (the YOLACT detector itself
is not ported yet): each GT's normalized mask crop pasted back at its box
onto an (h, w) canvas that spans the input image, by bilinear sampling
at the canvas pixels' centres, zero outside the box and for an invalid GT.
"""

from __future__ import annotations

import torch


def _bilinear_1ch(img: torch.Tensor, ys: torch.Tensor,
                  xs: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of (..., H, W) images at float coordinates (..., h,
    w), the corners clipped into the image and the weights into [0, 1]."""
    h, w = img.shape[-2:]
    y0 = torch.floor(ys).clamp(0, h - 1)
    x0 = torch.floor(xs).clamp(0, w - 1)
    y1 = (y0 + 1).clamp(0, h - 1)
    x1 = (x0 + 1).clamp(0, w - 1)
    wy = (ys - y0).clamp(0.0, 1.0)
    wx = (xs - x0).clamp(0.0, 1.0)
    flat = img.reshape(*img.shape[:-2], h * w)

    def at(yi, xi):
        idx = (yi.to(torch.int64) * w + xi.to(torch.int64))
        return torch.gather(flat, -1, idx.reshape(*idx.shape[:-2], -1)
                            ).reshape(idx.shape)

    return (at(y0, x0) * (1 - wy) * (1 - wx) + at(y0, x1) * (1 - wy) * wx
            + at(y1, x0) * wy * (1 - wx) + at(y1, x1) * wy * wx)


def paste_gt_crops(crops: torch.Tensor, boxes: torch.Tensor,
                   valid: torch.Tensor, out_hw, img_hw) -> torch.Tensor:
    """crops (..., K, M, M) in [0, 1], boxes (..., K, 4) in the input
    image's pixels (``img_hw``), valid (..., K) -> (..., K, h, w)."""
    h, w = out_hw
    ih, iw = img_hw
    m = crops.shape[-1]
    dev = boxes.device
    py = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) * (ih / h)
    px = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) * (iw / w)
    x1, y1, x2, y2 = (boxes[..., i, None] for i in range(4))
    floor = boxes.new_full((), 1e-3)
    ny = (py - y1) / torch.maximum(y2 - y1, floor)          # (..., K, h)
    nx = (px - x1) / torch.maximum(x2 - x1, floor)          # (..., K, w)
    inside = (((ny >= 0) & (ny <= 1))[..., :, None]
              & ((nx >= 0) & (nx <= 1))[..., None, :])
    sy = (ny * m - 0.5)[..., :, None].expand(*ny.shape, w)
    sx = (nx * m - 0.5)[..., None, :].expand(*nx.shape[:-1], h, w)
    vals = _bilinear_1ch(crops.to(torch.float32), sy, sx)
    vals = torch.where(inside, vals, vals.new_zeros(()))
    return vals * valid.to(torch.float32)[..., None, None]
