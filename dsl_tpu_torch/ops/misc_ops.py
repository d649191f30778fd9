"""CARAFE's content-aware reassembly, in torch ops.

Counterpart of ``dsl_tpu/ops/misc_ops.py::carafe`` (plain JAX, no Pallas
kernel): each output pixel of a ``scale``-times upsampled map is the sum,
over the k*k taps of the zero-padded source around its source pixel, of
the tap times that pixel's predicted kernel weight. The JAX package
gathers ``xp[:, ys + dy][:, :, xs + dx]`` with every source row repeated
``scale`` times; as an index gather its backward on the card would add
with atomics. Here each tap is the slice ``xp[..., dy:dy + H, dx:dx + W]``
broadcast over the ``scale x scale`` sub-pixels of the reshaped kernels,
multiplied and added in one ``addcmul`` per tap: the same sum in the same
tap order, whose backward is a slice's and a reduction's and repeats bit
for bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def carafe(x: torch.Tensor, masks: torch.Tensor, kernel_size: int = 5,
           scale: int = 2) -> torch.Tensor:
    """x (B, C, H, W); masks (B, k*k, H*scale, W*scale), each pixel's
    kernel (softmax-normalised by the caller), tap t = dy * k + dx.
    Returns (B, C, H*scale, W*scale)."""
    b, c, h, w = x.shape
    k, s = kernel_size, scale
    if tuple(masks.shape) != (b, k * k, h * s, w * s):
        raise ValueError(f"carafe: masks {tuple(masks.shape)} for a "
                         f"{k}x{k} kernel on {tuple(x.shape)} at scale {s}")
    pad = k // 2
    xp = F.pad(x, (pad, pad, pad, pad))
    m = masks.reshape(b, k * k, h, s, w, s)
    out = x.new_zeros((b, c, h, s, w, s))
    for dy in range(k):
        for dx in range(k):
            t = dy * k + dx
            patch = xp[:, :, dy:dy + h, dx:dx + w][:, :, :, None, :, None]
            out = torch.addcmul(out, patch, m[:, t:t + 1])
    return out.reshape(b, c, h * s, w * s)
