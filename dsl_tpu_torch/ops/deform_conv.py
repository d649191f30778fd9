"""Deformable convolution v1 / v2 and bilinear point sampling, torch ops
with a deterministic backward.

Counterpart of ``dsl_tpu/ops/deform_conv.py`` (plain JAX, no Pallas
kernel): each of the k*k taps of an output position samples the input
bilinearly at the tap's grid position plus its learned (dy, dx), each
deform group of input channels with its own offsets (and, for DCNv2, its
own modulation mask), then one product with the kernel applies the
weights. The sampling rule is the JAX package's, not mmcv's: a sample
counts where ``-1 < y < H`` and ``-1 < x < W`` (strict) and then reads the
map with its coordinate clipped to ``[0, H-1] x [0, W-1]`` (so y = -0.5
reads row 0 at full weight, where mmcv weighs it by 0.5); the clip is
``minimum(maximum(.))``, whose gradient at a bound is 0.5, as
``jnp.clip``'s is (``torch.clamp`` gives 1).

The samples go through ``ops/roi_align.gather_rows``: per corner one
gather of NHWC rows, weighted and summed, into the column tensor (B, oh,
ow, k*k, Cin), whose backward puts the input's gradient back with a
sorted ``index_put_`` (the same bits run to run on the card) and gives
the bilinear weights' gradient, through which the offsets and the mask
train. The column tensor times the kernel (per conv group for a grouped
kernel, as ResNeXt's) is the output.

Layouts are NCHW and mmcv's: the offsets (B, dg * 2 * k*k, oh, ow) are
group-major, then tap-major (row-major over the kernel), as (dy, dx);
DCNv2's mask (B, dg * k*k, oh, ow) follows all offsets in the offset
conv's output; a kernel is (Cout, Cin / groups, k, k). The modules carry
mmcv's names (``weight``, ``bias``, ``conv_offset``), so an mmdet
checkpoint of a DCN backbone or head loads by its own keys.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dsl_tpu_torch.ops.roi_align import gather_rows


def _corners(ys: torch.Tensor, xs: torch.Tensor, h: int, w: int,
             scale: torch.Tensor | None = None):
    """The rows (y * w + x) of the 4 neighbours of each sample at (ys, xs)
    and their bilinear weights, each (4, ...): zero weight outside ``-1 <
    y < h``, ``-1 < x < w``, the coordinate clipped to the map inside it
    (the JAX package's ``_bilinear_map``); ``scale`` (DCNv2's mask)
    multiplies every weight."""
    inb = (ys > -1.0) & (ys < h) & (xs > -1.0) & (xs < w)
    zero = ys.new_zeros(())
    y = torch.minimum(torch.maximum(ys, zero), ys.new_full((), h - 1.0))
    x = torch.minimum(torch.maximum(xs, zero), xs.new_full((), w - 1.0))
    y0f, x0f = torch.floor(y), torch.floor(x)
    ly, lx = y - y0f, x - x0f
    y0, x0 = y0f.to(torch.int64), x0f.to(torch.int64)
    y1 = torch.clamp_max(y0 + 1, h - 1)
    x1 = torch.clamp_max(x0 + 1, w - 1)
    hy, hx = 1 - ly, 1 - lx
    m = inb.to(ys.dtype)
    if scale is not None:
        m = m * scale
    idx = torch.stack([y0 * w + x0, y0 * w + x1, y1 * w + x0, y1 * w + x1])
    wts = torch.stack([hy * hx * m, hy * lx * m, ly * hx * m, ly * lx * m])
    return idx, wts


def deform_conv2d(x: torch.Tensor, offsets: torch.Tensor,
                  weight: torch.Tensor, bias: torch.Tensor | None = None,
                  mask: torch.Tensor | None = None, stride: int = 1,
                  dilation: int = 1, deform_groups: int = 1) -> torch.Tensor:
    """Deformable k x k convolution with "same" padding ``dilation * (k -
    1) // 2``.

    x (B, Cin, H, W); offsets (B, dg * 2 * k*k, oh, ow) as described in
    the module's docstring, at the output resolution (``oh`` = ceil(H /
    stride)); weight (Cout, Cin / groups, k, k), groups = Cin /
    weight.shape[1]; mask optional (B, dg * k*k, oh, ow), DCNv2's
    modulation (after its sigmoid); bias optional (Cout,). Returns (B,
    Cout, oh, ow)."""
    b, cin, h, w = x.shape
    cout, cg, k, _ = weight.shape
    dg = deform_groups
    taps = k * k
    pad = dilation * (k - 1) // 2
    oh, ow = offsets.shape[2:]
    dt, dev = x.dtype, x.device
    # (B, oh, ow, taps, dg, 2) as (dy, dx)
    off = offsets.reshape(b, dg, taps, 2, oh, ow).permute(0, 4, 5, 2, 1, 3)
    ti = torch.arange(k, device=dev).repeat_interleave(k) * dilation - pad
    tj = torch.arange(k, device=dev).repeat(k) * dilation - pad
    gy = (torch.arange(oh, dtype=dt, device=dev) * stride)[:, None] + ti.to(dt)
    gx = (torch.arange(ow, dtype=dt, device=dev) * stride)[:, None] + tj.to(dt)
    # the tap's grid position, then its offset, as the JAX package adds them
    ys = gy[None, :, None, :, None] + off[..., 0]
    xs = gx[None, None, :, :, None] + off[..., 1]
    scale = None
    if mask is not None:
        scale = mask.reshape(b, dg, taps, oh, ow).permute(0, 3, 4, 2, 1)
    idx, wts = _corners(ys, xs, h, w, scale)
    # each image's rows, each deform group's channels a row of its own
    img = (torch.arange(b, device=dev) * (h * w))[:, None, None, None, None]
    grp = torch.arange(dg, device=dev)
    idx = (idx + img) * dg + grp
    table = x.permute(0, 2, 3, 1).reshape(b * h * w * dg, cin // dg)
    col = gather_rows(table, idx, wts)          # (B, oh, ow, taps, dg, Cin/dg)
    p = b * oh * ow
    groups = cin // cg
    if groups == 1:
        wmat = weight.permute(2, 3, 1, 0).reshape(taps * cin, cout)
        out = col.reshape(p, taps * cin) @ wmat
    else:
        # ResNeXt's grouped kernel: each group's channels times its block
        colg = col.reshape(p, taps, groups, cg).permute(2, 0, 1, 3)
        wmat = weight.reshape(groups, cout // groups, cg, k, k).permute(
            0, 3, 4, 2, 1).reshape(groups, taps * cg, cout // groups)
        out = torch.bmm(colg.reshape(groups, p, taps * cg), wmat)
        out = out.permute(1, 0, 2).reshape(p, cout)
    if bias is not None:
        out = out + bias
    return out.reshape(b, oh, ow, cout).permute(0, 3, 1, 2).contiguous()


def sample_points(x: torch.Tensor, ys: torch.Tensor,
                  xs: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of x (B, C, H, W) at per-pixel points ys, xs (B,
    H', W', P), by the rule of :func:`deform_conv2d`. Returns (B, H', W', P,
    C), the JAX package's layout."""
    b, c, h, w = x.shape
    idx, wts = _corners(ys, xs, h, w)
    img = (torch.arange(b, device=x.device) * (h * w))[:, None, None, None]
    table = x.permute(0, 2, 3, 1).reshape(b * h * w, c)
    return gather_rows(table, idx + img, wts)


class _OffsetConv(nn.Module):
    """A deformable conv's offset (and mask) predictor: mmcv's
    ``conv_offset`` (``weight``, ``bias``), zero at the start, so the
    deformable conv starts as a plain one. Not an ``nn.Conv2d``, so the
    heads' and backbones' random init of their convs leaves it at zero."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int, dilation: int):
        super().__init__()
        self.stride, self.dilation = stride, dilation
        self.padding = dilation * (kernel_size - 1) // 2
        self.weight = nn.Parameter(torch.zeros(out_channels, in_channels,
                                               kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding,
                        self.dilation)


class DeformConv2dPack(nn.Conv2d):
    """A deformable conv that predicts its own offsets: mmcv's
    ``DeformConv2dPack`` (v1, ``modulated=False``) or
    ``ModulatedDeformConv2dPack`` (v2: the offset conv also gives dg * k*k
    mask logits, through a sigmoid), ``deform_groups`` offset groups,
    ``groups`` kernel groups. The kernel is this conv's ``weight`` (its
    init is the caller's, as a plain conv's), ``conv_offset`` the offset
    conv at the same stride and dilation."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, dilation: int = 1,
                 groups: int = 1, bias: bool = False,
                 modulated: bool = True, deform_groups: int = 1):
        if in_channels % deform_groups:
            raise ValueError(f"{in_channels} input channels in "
                             f"{deform_groups} deform groups")
        super().__init__(in_channels, out_channels, kernel_size,
                         stride=stride, padding=dilation * (kernel_size - 1) // 2,
                         dilation=dilation, groups=groups, bias=bias)
        self.modulated = modulated
        self.deform_groups = deform_groups
        per_tap = 3 if modulated else 2
        self.conv_offset = _OffsetConv(
            in_channels, deform_groups * per_tap * kernel_size ** 2,
            kernel_size, stride, dilation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        raw = self.conv_offset(x)
        n_off = self.deform_groups * 2 * self.kernel_size[0] ** 2
        mask = torch.sigmoid(raw[:, n_off:]) if self.modulated else None
        return deform_conv2d(x, raw[:, :n_off], self.weight, self.bias, mask,
                             self.stride[0], self.dilation[0],
                             self.deform_groups)


def dcn_pack(dcn: dict, in_channels: int, out_channels: int, stride: int = 1,
             dilation: int = 1, groups: int = 1,
             bias: bool = False) -> DeformConv2dPack:
    """The 3x3 deformable conv a backbone's ``dcn`` config asks for:
    ``type`` 'DCNv2' (the default, as the JAX package reads it) is
    modulated, 'DCN' is v1; ``deform_groups`` offset groups. Another key
    raises."""
    cfg = dict(dcn)
    kind = cfg.pop("type", "DCNv2")
    if kind not in ("DCN", "DCNv2", "dcnv2"):
        raise NotImplementedError(f"dcn type {kind!r}: only DCN and DCNv2")
    dg = int(cfg.pop("deform_groups", 1))
    if cfg:
        raise NotImplementedError(f"unhandled dcn keys: {sorted(cfg)}")
    return DeformConv2dPack(in_channels, out_channels, 3, stride, dilation,
                            groups, bias, modulated=kind != "DCN",
                            deform_groups=dg)


class DeformConv2d(nn.Module):
    """A deformable conv whose offsets come from outside (mmcv's
    ``DeformConv2d``: ``weight`` only, no bias, no mask), as VFNet's star
    convs take theirs from the box prediction."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               kernel_size, kernel_size))

    def forward(self, x: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
        return deform_conv2d(x, offsets, self.weight)
