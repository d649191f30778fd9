"""``jax.image.resize(..., "bilinear")`` in torch, shared by the heads and
the FPN.

``resize_bilinear`` resizes the last two axes as two small matrix
products, one per axis, with JAX's own weights (``scale_and_translate``: a
triangle kernel at the half-pixel sample positions, widened by the shrink
factor when the map shrinks, so a 2x shrink takes 4 taps of 1/8, 3/8, 3/8,
1/8, normalised over the taps inside the map). Its backward is a matrix
product too, so it repeats bit for bit on the card, where the backward of
``F.interpolate`` adds with atomics (and, without ``antialias``, it would
not shrink as JAX does). The users: HTC's semantic head, SCNet's relay
head, PointRend's subdivision, YOLACT's protonet and the FPN's bilinear
top-down path (YOLACT's). ``resize_nearest`` is ``jax.image.resize``'s
nearest rule the same way, with 0/1 selection matrices (HRNet's fuse).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from dsl_tpu_torch.utils.device import to_device


@functools.lru_cache(maxsize=64)
def jax_resize_weights(src: int, dst: int) -> np.ndarray:
    """(dst, src) f32 weights of ``jax.image.resize``'s bilinear along one
    axis (``compute_weight_mat`` with antialias, in f32 as JAX computes
    it). Cached; never written."""
    if src == dst:
        return np.eye(src, dtype=np.float32)
    inv = np.float32(1.0 / (dst / src))
    kernel_scale = max(inv, np.float32(1.0))
    sample = ((np.arange(dst, dtype=np.float32) + np.float32(0.5)) * inv
              - np.float32(0.5))
    x = (np.abs(sample[None, :] - np.arange(src, dtype=np.float32)[:, None])
         / kernel_scale)
    w = np.maximum(np.float32(0), np.float32(1) - np.abs(x))
    total = w.sum(0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= src - 0.5)
    return np.ascontiguousarray(np.where(inside[None, :], w, 0).T
                                .astype(np.float32))


_WEIGHTS_ON: dict = {}


def _weights_on(src: int, dst: int, device: torch.device) -> torch.Tensor:
    key = (src, dst, str(device))
    if key not in _WEIGHTS_ON:
        _WEIGHTS_ON[key] = to_device(
            torch.from_numpy(jax_resize_weights(src, dst)), device)
    return _WEIGHTS_ON[key]


def resize_bilinear(x: torch.Tensor, out_hw) -> torch.Tensor:
    """(..., H, W) -> (..., oh, ow) as ``jax.image.resize(..., "bilinear")``
    resizes the spatial axes: rows, then columns."""
    h, w = x.shape[-2:]
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if h != oh:
        x = torch.matmul(_weights_on(h, oh, x.device).to(x.dtype), x)
    if w != ow:
        x = torch.matmul(x, _weights_on(w, ow, x.device).to(x.dtype).T)
    return x


@functools.lru_cache(maxsize=64)
def jax_nearest_index(src: int, dst: int) -> np.ndarray:
    """The source index of each of ``dst`` outputs along one axis under
    ``jax.image.resize(..., "nearest")``: ``floor((i + 0.5) * src / dst)``
    in f32, as JAX computes it. This is ``F.interpolate``'s
    ``"nearest-exact"``, not its ``"nearest"`` (``floor(i * src / dst)``),
    which picks otherwise wherever ``src`` does not divide ``dst`` (7 -> 13,
    13 -> 25). Cached; never written."""
    pos = ((np.arange(dst, dtype=np.float32) + np.float32(0.5))
           * np.float32(src) / np.float32(dst))
    return np.minimum(np.floor(pos).astype(np.int64), src - 1)


def _selection_on(src: int, dst: int, device: torch.device) -> torch.Tensor:
    key = ("nearest", src, dst, str(device))
    if key not in _WEIGHTS_ON:
        sel = np.zeros((dst, src), np.float32)
        sel[np.arange(dst), jax_nearest_index(src, dst)] = 1.0
        _WEIGHTS_ON[key] = to_device(torch.from_numpy(sel), device)
    return _WEIGHTS_ON[key]


def resize_nearest(x: torch.Tensor, out_hw) -> torch.Tensor:
    """(..., H, W) -> (..., oh, ow) as ``jax.image.resize(..., "nearest")``
    resizes the spatial axes (HRNet's fuse), as products with 0/1 selection
    matrices: each output is one input times 1 plus zeros, so the values
    are the gather's bit for bit, and the backward is a matrix product
    that repeats on the card (a gather's adds with atomics)."""
    h, w = x.shape[-2:]
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if h != oh:
        x = torch.matmul(_selection_on(h, oh, x.device).to(x.dtype), x)
    if w != ow:
        x = torch.matmul(x, _selection_on(w, ow, x.device).to(x.dtype).T)
    return x
