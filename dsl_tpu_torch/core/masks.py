"""Instance masks: ``BitmapMasks``, ``PolygonMasks``, rasterisation, RLE and
mask IoU.

Counterpart of ``dsl_tpu/core/masks.py`` for what the mask pipelines, the
Mask R-CNN loss and the ``segm`` evaluation use:

- ``BitmapMasks`` holds (N, H, W) uint8 on a device (the image's, in a
  pipeline); ``resize`` is OpenCV 5.0's ``INTER_NEAREST``
  (``image_ops.resize_nearest``, bit for bit ``cv2.resize``), then
  ``rescale``, ``flip``, ``crop``, ``pad`` and ``areas`` as the JAX class
  computes them;
- ``PolygonMasks`` holds per-instance lists of flat float64 polygons on the
  host, with the JAX class's methods only: ``rescale``, ``flip``,
  ``to_bitmap`` and ``areas``. Like the JAX class it has no ``resize`` and
  no ``pad``, so ``Resize`` and ``Pad`` fail on it as they fail there
  (``AttributeError: 'PolygonMasks' object has no attribute 'resize'``);
- ``rasterize_polygons``: the JAX package's even-odd rule at pixel centres
  in float64 (a pixel is inside where an odd number of the crossings of
  its row lies strictly right of its centre, each edge half-open in y),
  on the tensor's device. The crossings of a row are counted by a search
  in the sorted crossings, not by the JAX function's (H, W, E) comparison:
  the same count in (H, E) memory;
- ``encode_rle``, ``decode_rle``, ``rle_area`` and ``mask_iou``: host
  numpy, as the JAX package computes them.

The geometric transforms' ``translate``, ``shear`` and ``rotate`` are not
ported yet (``data/pipelines/geometric.py`` refuses masks).
"""

from __future__ import annotations

import numpy as np
import torch


class BitmapMasks:
    """(N, H, W) uint8 instance masks on a device."""

    def __init__(self, masks, height: int, width: int, device="cpu"):
        self.height = int(height)
        self.width = int(width)
        if torch.is_tensor(masks):
            self.masks = masks.to(torch.uint8).reshape(-1, self.height,
                                                       self.width)
        elif len(masks) == 0:
            self.masks = torch.zeros((0, self.height, self.width),
                                     dtype=torch.uint8, device=device)
        else:
            self.masks = torch.stack([torch.as_tensor(m).to(device)
                                      for m in masks]).to(torch.uint8).reshape(
                -1, self.height, self.width)

    def __len__(self):
        return int(self.masks.shape[0])

    def __getitem__(self, idx):
        return BitmapMasks(self.masks[idx], self.height, self.width)

    @property
    def device(self) -> torch.device:
        return self.masks.device

    @property
    def areas(self) -> torch.Tensor:
        return self.masks.sum((1, 2))

    def resize(self, out_shape) -> "BitmapMasks":
        from dsl_tpu_torch.data.pipelines.image_ops import resize_nearest

        h, w = out_shape
        if len(self) == 0:
            return BitmapMasks([], h, w, self.device)
        return BitmapMasks(resize_nearest(self.masks, h, w), h, w)

    def rescale(self, scale_factor) -> "BitmapMasks":
        if np.isscalar(scale_factor):
            sy = sx = scale_factor
        else:
            sx, sy = scale_factor[0], scale_factor[1]
        return self.resize((int(self.height * sy + 0.5),
                            int(self.width * sx + 0.5)))

    def flip(self, direction: str = "horizontal") -> "BitmapMasks":
        dim = 2 if direction == "horizontal" else 1
        return BitmapMasks(self.masks.flip(dim), self.height, self.width)

    def crop(self, bbox) -> "BitmapMasks":
        x1, y1, x2, y2 = [int(v) for v in bbox]
        x1, y1 = max(x1, 0), max(y1, 0)
        x2 = min(max(x2, x1 + 1), self.width)
        y2 = min(max(y2, y1 + 1), self.height)
        return BitmapMasks(self.masks[:, y1:y2, x1:x2], y2 - y1, x2 - x1)

    def pad(self, out_shape, pad_val: int = 0) -> "BitmapMasks":
        h, w = out_shape
        padded = self.masks.new_full((len(self), h, w), pad_val)
        padded[:, :self.height, :self.width] = self.masks
        return BitmapMasks(padded, h, w)


def rasterize_polygons(polys, height: int, width: int,
                       device="cpu") -> torch.Tensor:
    """(H, W) uint8 on ``device``: the union of the flat polygons ``polys``
    by the JAX package's even-odd pixel-centre rule (a square
    [x1, y1, x2, y2] covers exactly (x2 - x1) * (y2 - y1) pixels, as
    pycocotools' polygon-to-RLE, where ``cv2.fillPoly`` would add a row and
    a column)."""
    f64 = dict(dtype=torch.float64, device=device)
    mask = torch.zeros((height, width), dtype=torch.uint8, device=device)
    yc = (torch.arange(height, **f64) + 0.5)[:, None]             # (H, 1)
    xc = (torch.arange(width, **f64) + 0.5)[None, :].expand(height, width)
    for p in polys:
        p = torch.as_tensor(np.asarray(p, np.float64).reshape(-1, 2), **f64)
        if len(p) < 3:
            continue
        x, y = p[:, 0], p[:, 1]
        x2, y2 = x.roll(-1), y.roll(-1)
        crosses = (yc >= torch.minimum(y, y2)) & (yc < torch.maximum(y, y2))
        t = (yc - y) / (y2 - y)                                    # (H, E)
        xs = x + t * (x2 - x)
        xs = torch.where(crosses, xs, torch.full_like(xs, -torch.inf))
        # crossings strictly right of each centre: E - #(xs <= xc)
        left = torch.searchsorted(xs.sort(dim=1).values.contiguous(),
                                  xc.contiguous(), right=True)
        mask |= ((xs.shape[1] - left) % 2).to(torch.uint8)
    return mask


class PolygonMasks:
    """Per-instance lists of flat [x0, y0, x1, y1, ...] float64 polygons
    (host numpy)."""

    def __init__(self, masks, height: int, width: int):
        self.masks = [[np.asarray(p, np.float64) for p in inst]
                      for inst in masks]
        self.height = height
        self.width = width

    def __len__(self):
        return len(self.masks)

    def rescale(self, scale_factor) -> "PolygonMasks":
        if np.isscalar(scale_factor):
            sx = sy = scale_factor
        else:
            sx, sy = scale_factor[0], scale_factor[1]
        out = []
        for inst in self.masks:
            polys = []
            for p in inst:
                q = p.copy()
                q[0::2] *= sx
                q[1::2] *= sy
                polys.append(q)
            out.append(polys)
        return PolygonMasks(out, int(self.height * sy + 0.5),
                            int(self.width * sx + 0.5))

    def flip(self, direction: str = "horizontal") -> "PolygonMasks":
        out = []
        for inst in self.masks:
            polys = []
            for p in inst:
                q = p.copy()
                if direction == "horizontal":
                    q[0::2] = self.width - q[0::2]
                else:
                    q[1::2] = self.height - q[1::2]
                polys.append(q)
            out.append(polys)
        return PolygonMasks(out, self.height, self.width)

    def to_bitmap(self, device="cpu") -> BitmapMasks:
        return BitmapMasks([rasterize_polygons(inst, self.height, self.width,
                                               device)
                            for inst in self.masks],
                           self.height, self.width, device)

    @property
    def areas(self) -> np.ndarray:
        """Shoelace area summed over each instance's polygons."""
        out = []
        for inst in self.masks:
            a = 0.0
            for p in inst:
                x, y = p[0::2], p[1::2]
                a += 0.5 * abs(np.dot(x, np.roll(y, 1))
                               - np.dot(y, np.roll(x, 1)))
            out.append(a)
        return np.asarray(out)


def encode_rle(mask: np.ndarray) -> dict:
    """Binary (H, W) mask -> COCO uncompressed RLE: column-major runs, the
    first counting zeros (pycocotools' ``encode`` with plain counts)."""
    m = np.asarray(mask, np.uint8)
    h, w = m.shape
    flat = m.flatten(order="F")
    if len(flat) == 0:
        return dict(size=[h, w], counts=[0])
    change = np.nonzero(np.diff(flat))[0] + 1
    bounds = np.concatenate([[0], change, [len(flat)]])
    counts = np.diff(bounds).tolist()
    if flat[0] == 1:
        counts = [0] + counts
    return dict(size=[int(h), int(w)], counts=counts)


def decode_rle(rle: dict) -> np.ndarray:
    """COCO uncompressed RLE -> (H, W) uint8 binary mask."""
    h, w = rle["size"]
    flat = np.zeros(h * w, np.uint8)
    pos, val = 0, 0
    for c in rle["counts"]:
        c = int(c)
        if val:
            flat[pos:pos + c] = 1
        pos += c
        val = 1 - val
    return flat.reshape((h, w), order="F")


def rle_area(rle: dict) -> int:
    return int(sum(int(c) for c in rle["counts"][1::2]))


def mask_iou(dt_masks: np.ndarray, gt_masks: np.ndarray,
             iscrowd: np.ndarray) -> np.ndarray:
    """Pairwise IoU of binary masks (N, H, W) x (M, H, W); a crowd GT
    divides by the detection's area (COCO's rule, as for boxes)."""
    n, m = len(dt_masks), len(gt_masks)
    if n == 0 or m == 0:
        return np.zeros((n, m))
    d = dt_masks.reshape(n, -1).astype(np.float64)
    g = gt_masks.reshape(m, -1).astype(np.float64)
    inter = d @ g.T
    d_area = d.sum(1)[:, None]
    g_area = g.sum(1)[None, :]
    union = np.where(np.asarray(iscrowd, bool)[None, :], d_area,
                     d_area + g_area - inter)
    return inter / np.maximum(union, 1e-10)
