"""Pillow- and OpenCV-exact image operations on (H, W, 3) tensors (uint8,
and float32 where the JAX package hands OpenCV a float image).

The JAX package's strong augmentations (``dsl_tpu/data/pipelines/
strong_aug.py``) call Pillow and OpenCV on the host. These are the same
operations as torch ops on the image's device, bit for bit with the
libraries (Pillow 12.1, OpenCV 5.0), each written from the library's
arithmetic: C ``float`` steps in float32 and ``double`` steps in float64,
one torch op per C operation (no fused multiply-add where C rounds twice),
integer steps in int32/int64. Per-image statistics (a mean, a histogram)
stay on the device, so no operation waits for the card.

Channels are taken in the order given: the data pipeline holds BGR images
and the JAX package hands them to Pillow as if they were RGB, so "R" here
is the first channel, as there.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from dsl_tpu_torch.utils.device import to_device


def _c_float(x) -> float:
    """``x`` rounded to a C float, as a Python scalar: a torch op takes it
    as the kernel's argument (a tensor made from it on the card would be a
    blocking copy)."""
    return float(np.float32(x))


# -- Pillow: Image.blend and ImageEnhance ------------------------------------


def blend(im1: torch.Tensor, im2: torch.Tensor, alpha: float) -> torch.Tensor:
    """``Image.blend(im1, im2, alpha)``: ``in1 + alpha * (in2 - in1)`` with a
    C float alpha, truncated to uint8 (clamped to [0, 255] first when alpha
    lies outside [0, 1])."""
    diff = (im2.to(torch.int32) - im1.to(torch.int32)).to(torch.float32)
    out = im1.to(torch.float32) + diff * _c_float(alpha)
    return out.clamp(0, 255).to(torch.uint8)


def to_l(img: torch.Tensor) -> torch.Tensor:
    """``convert("L")``: (H, W) uint8, ITU-R 601-2 luma in 16-bit fixed point."""
    x = img.to(torch.int32)
    return ((x[..., 0] * 19595 + x[..., 1] * 38470 + x[..., 2] * 7471 + 0x8000)
            >> 16).to(torch.uint8)


def color(img: torch.Tensor, factor: float) -> torch.Tensor:
    """``ImageEnhance.Color``: blend with the L image in three bands."""
    return blend(to_l(img)[..., None].expand_as(img), img, factor)


def contrast(img: torch.Tensor, factor: float) -> torch.Tensor:
    """``ImageEnhance.Contrast``: blend with a flat image at
    ``int(mean(L) + 0.5)``, the mean in float64 as ``ImageStat`` takes it."""
    lum = to_l(img)
    mean = lum.to(torch.int64).sum().to(torch.float64) / lum.numel()
    flat = torch.floor(mean + 0.5).to(torch.uint8)
    return blend(flat.expand_as(img), img, factor)


def brightness(img: torch.Tensor, factor: float) -> torch.Tensor:
    """``ImageEnhance.Brightness``: blend with black."""
    return blend(torch.zeros_like(img), img, factor)


def smooth(img: torch.Tensor) -> torch.Tensor:
    """``ImageFilter.SMOOTH``: the 3x3 kernel (1 1 1 / 1 5 1 / 1 1 1) / 13 in
    float32, summed row by row as ``ImagingFilter3x3`` does (row below,
    row, row above; left to right in each), rounded half up; the border
    pixels are copied unfiltered."""
    k1 = float(np.float32(1) / np.float32(13))
    k5 = float(np.float32(5) / np.float32(13))
    x = img.to(torch.float32)

    def row(r: torch.Tensor, centre: float) -> torch.Tensor:
        s = r[:, :-2] * k1
        s = s + r[:, 1:-1] * centre
        return s + r[:, 2:] * k1

    ss = row(x[2:], k1)
    ss = ss + row(x[1:-1], k5)
    ss = ss + row(x[:-2], k1)
    inner = torch.where(ss <= 0, 0.0, torch.where(ss >= 255, 255.0,
                                                  ss.double() + 0.5))
    out = img.clone()
    out[1:-1, 1:-1] = inner.to(torch.uint8)
    return out


def sharpness(img: torch.Tensor, factor: float) -> torch.Tensor:
    """``ImageEnhance.Sharpness``: blend with the SMOOTH-filtered image."""
    return blend(smooth(img), img, factor)


# -- Pillow: ImageOps lookup tables ------------------------------------------


def apply_lut(img: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """``Image.point`` with a (3, 256) table, its values clipped to uint8."""
    lut = lut.clamp(0, 255).to(torch.uint8).reshape(-1)
    offset = torch.arange(3, device=img.device) * 256
    return lut[img.to(torch.int64) + offset]


def _histograms(img: torch.Tensor) -> torch.Tensor:
    """(3, 256) int64 per-band histograms, on the device."""
    idx = (img.to(torch.int64) + torch.arange(3, device=img.device) * 256
           ).reshape(-1)
    hist = torch.zeros(3 * 256, dtype=torch.int64, device=img.device)
    hist.index_add_(0, idx, torch.ones_like(idx))
    return hist.reshape(3, 256)


def autocontrast(img: torch.Tensor) -> torch.Tensor:
    """``ImageOps.autocontrast`` (no cutoff): each band's [lo, hi] stretched
    to [0, 255] by ``int(ix * scale + offset)`` in float64."""
    lo = img.reshape(-1, 3).amin(0).to(torch.float64)[:, None]
    hi = img.reshape(-1, 3).amax(0).to(torch.float64)[:, None]
    ix = torch.arange(256, dtype=torch.float64, device=img.device)
    scale = 255.0 / (hi - lo).clamp_min(1)
    offset = -lo * scale
    lut = torch.trunc(ix * scale + offset).clamp(0, 255)
    lut = torch.where(hi <= lo, ix, lut)
    return apply_lut(img, lut)


def equalize(img: torch.Tensor) -> torch.Tensor:
    """``ImageOps.equalize``: per band, ``step = (count - h[last used
    level]) // 255`` and ``lut[i] = (step // 2 + sum(h[:i])) // step``;
    the identity where a band uses one level or ``step`` is 0."""
    hist = _histograms(img)
    levels = torch.arange(256, device=img.device)
    used = hist > 0
    last = torch.where(used, levels, -1).amax(1, keepdim=True)
    step = (hist.sum(1, keepdim=True) - hist.gather(1, last.clamp_min(0))) // 255
    before = torch.cumsum(hist, 1) - hist
    lut = (step // 2 + before) // step.clamp_min(1)
    identity = (used.sum(1, keepdim=True) <= 1) | (step == 0)
    return apply_lut(img, torch.where(identity, levels, lut))


def solarize(img: torch.Tensor, threshold: int) -> torch.Tensor:
    """``ImageOps.solarize``: levels at or above ``threshold`` inverted."""
    return torch.where(img.to(torch.int32) < threshold, img, 255 - img)


def posterize(img: torch.Tensor, bits: int) -> torch.Tensor:
    """``ImageOps.posterize``: keep the top ``bits`` bits."""
    return img & (~(2 ** (8 - bits) - 1) & 0xFF)


# -- Pillow: HSV --------------------------------------------------------------


def _round_half_away(x: torch.Tensor) -> torch.Tensor:
    """C ``round`` of non-negative doubles."""
    t = torch.trunc(x)
    return t + (x - t >= 0.5).to(x.dtype)


def rgb_to_hsv(img: torch.Tensor) -> torch.Tensor:
    """``convert("HSV")`` (``rgb2hsv_row``): C float quotients, the hue's
    offsets and ``fmod`` in double, both bytes truncated from double."""
    x = img.to(torch.int32)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    maxc = torch.maximum(r, torch.maximum(g, b))
    minc = torch.minimum(r, torch.minimum(g, b))
    cr = (maxc - minc).to(torch.float32)
    cr_safe = torch.where(cr == 0, 1.0, cr)
    s = cr / torch.where(maxc == 0, 1, maxc).to(torch.float32)
    rc = (maxc - r).to(torch.float32) / cr_safe
    gc = (maxc - g).to(torch.float32) / cr_safe
    bc = (maxc - b).to(torch.float32) / cr_safe
    rc64, gc64, bc64 = rc.double(), gc.double(), bc.double()
    h = torch.where(r == maxc, (bc - gc).double(),
                    torch.where(g == maxc, (2.0 + rc64) - bc64,
                                (4.0 + gc64) - rc64)).to(torch.float32)
    h = torch.fmod(h.double() / 6.0 + 1.0, 1.0).to(torch.float32)
    uh = torch.trunc(h.double() * 255.0).clamp(0, 255)
    us = torch.trunc(s.double() * 255.0).clamp(0, 255)
    flat = minc == maxc
    return torch.stack([torch.where(flat, 0.0, uh), torch.where(flat, 0.0, us),
                        maxc.double()], -1).to(torch.uint8)


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    """HSV -> RGB (``hsv2rgb``): sector and fraction from double, C float
    ``f`` and ``fs``, ``fs * f`` in float, the rest double, C ``round``."""
    x = hsv.to(torch.int64)
    h, s, v = x[..., 0], x[..., 1], x[..., 2]
    h6 = h.double() * 6.0 / 255.0
    i = torch.floor(h6)
    f = (h6 - i.to(torch.float32).double()).to(torch.float32)
    fs = (s.double() / 255.0).to(torch.float32)
    vd = v.double()
    p = _round_half_away(vd * (1.0 - fs.double())).clamp(0, 255)
    q = _round_half_away(vd * (1.0 - (fs * f).double())).clamp(0, 255)
    t = _round_half_away(vd * (1.0 - fs.double() * (1.0 - f.double()))).clamp(0, 255)
    sector = i.to(torch.int64) % 6
    vd = vd.expand_as(p)
    table = torch.stack([
        torch.stack([vd, t, p], -1), torch.stack([q, vd, p], -1),
        torch.stack([p, vd, t], -1), torch.stack([p, q, vd], -1),
        torch.stack([t, p, vd], -1), torch.stack([vd, p, q], -1)], -2)
    rgb = table.gather(-2, sector[..., None, None].expand(*sector.shape, 1, 3))
    rgb = rgb.squeeze(-2)
    grey = (s == 0)[..., None]
    return torch.where(grey, vd[..., None].expand_as(rgb), rgb).to(torch.uint8)


def shift_hue(img: torch.Tensor, shift: int) -> torch.Tensor:
    """RGB -> HSV, ``h = (h + shift) % 256``, HSV -> RGB."""
    hsv = rgb_to_hsv(img).to(torch.int64)
    hsv[..., 0] = torch.remainder(hsv[..., 0] + shift, 256)
    return hsv_to_rgb(hsv)


# -- Pillow: GaussianBlur ------------------------------------------------------


def _f32(x) -> np.float32:
    return np.float32(x)


def gaussian_blur_radius(sigma: float, passes: int = 3) -> np.float32:
    """``_gaussian_blur_radius``: the extended box radius, C float steps,
    its double intermediates as C promotes them."""
    sigma2 = _f32(_f32(_f32(sigma) * _f32(sigma)) / _f32(passes))
    big_l = _f32(math.sqrt(12.0 * float(sigma2) + 1.0))
    small_l = _f32(math.floor((float(big_l) - 1.0) / 2.0))
    a = _f32(_f32(2) * small_l + _f32(1)) * _f32(
        small_l * _f32(small_l + _f32(1)) - _f32(3) * sigma2)
    a = _f32(a / _f32(_f32(6) * _f32(sigma2 - _f32(small_l + _f32(1))
                                      * _f32(small_l + _f32(1)))))
    return _f32(small_l + a)


def _box_weights(radius: np.float32) -> tuple[int, int, int]:
    """(int radius, ww, fw) of ``ImagingHorizontalBoxBlur`` in 24-bit fixed
    point."""
    r = int(radius)
    ww = int(_f32(_f32(1 << 24) / _f32(radius * _f32(2) + _f32(1))))
    fw = ((1 << 24) - (2 * r + 1) * ww) // 2
    return r, ww, fw


def _box_pass(x: torch.Tensor, dim: int, r: int, ww: int, fw: int) -> torch.Tensor:
    """One extended box pass along ``dim`` with replicated edges: taps
    within ``r`` weigh ``ww``, the two at ``r + 1`` weigh ``fw``; rounded
    to uint8 levels."""
    n = x.shape[dim]
    pos = torch.arange(n, device=x.device)

    def tap(k: int) -> torch.Tensor:
        return x.index_select(dim, (pos + k).clamp(0, n - 1))

    acc = sum(tap(k) for k in range(-r, r + 1))
    bulk = acc * ww + (tap(-r - 1) + tap(r + 1)) * fw
    return (bulk + (1 << 23)) >> 24


def gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """``img.filter(ImageFilter.GaussianBlur(radius=sigma))``: three
    extended box passes along x, then three along y."""
    r, ww, fw = _box_weights(gaussian_blur_radius(sigma))
    x = img.to(torch.int64)
    for dim in (1, 1, 1, 0, 0, 0):
        x = _box_pass(x, dim, r, ww, fw)
    return x.to(torch.uint8)


# -- OpenCV ----------------------------------------------------------------


def rgb_to_gray_cv(img: torch.Tensor) -> torch.Tensor:
    """``cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)``: OpenCV 5's 15-bit fixed
    point (0.299, 0.587, 0.114 scaled to 9798, 19235, 3735)."""
    x = img.to(torch.int32)
    return ((x[..., 0] * 9798 + x[..., 1] * 19235 + x[..., 2] * 3735 + 16384)
            >> 15).to(torch.uint8)


# OpenCV's INTER_RESIZE_COEF_SCALE: linear resize weights in 11 bits
RESIZE_COEF_SCALE = 2048


@functools.lru_cache(maxsize=256)
def _linear_taps(src: int, dst: int, horizontal: bool
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """OpenCV 5's uint8 ``INTER_LINEAR`` taps along one axis: (2, dst)
    int64 source indices and (2, dst) int32 weights in 11-bit fixed point,
    host tensors (cached per size pair; never written). The source position
    is a C float, ``(d + 0.5) * scale - 0.5`` with ``scale`` in double,
    split into its floor and fraction; a weight is the fraction (or one
    less it) times 2048 in float, rounded half to even. Along x a position
    before the first or past the last pixel takes that pixel with weight 1;
    along y only the rows are clamped and the fraction stays, as OpenCV
    does (at an upscale's first and last rows the two taps are one row with
    split weights, which truncate otherwise than one weight of 2048)."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5
         ).astype(np.float32)
    s = np.floor(f)
    f = f - s
    s = s.astype(np.int64)
    if horizontal:
        edge = (s < 0) | (s >= src - 1)
        s = np.clip(s, 0, src - 1)
        f[edge] = 0
    w0 = np.rint((np.float32(1) - f) * np.float32(RESIZE_COEF_SCALE))
    w1 = np.rint(f * np.float32(RESIZE_COEF_SCALE))
    idx = np.stack([np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1)])
    return (torch.from_numpy(idx),
            torch.from_numpy(np.stack([w0, w1]).astype(np.int32)))


def resize_linear_u8(img: torch.Tensor, new_h: int, new_w: int) -> torch.Tensor:
    """``cv2.resize(img, (new_w, new_h), interpolation=cv2.INTER_LINEAR)``
    on a uint8 (H, W, C) tensor, as OpenCV 5 computes it: a horizontal pass
    into int32 (``p0 * w0 + p1 * w1``), then a vertical pass
    ``((w0 * (r0 >> 4)) >> 16) + ((w1 * (r1 >> 4)) >> 16) + 2 >> 2``
    (its vector kernel's fixed point), clamped to [0, 255]. The taps are
    built on the host and reach the card without a wait. At an exact half
    it gives the 2x2 mean rounded, as OpenCV's INTER_AREA path there does."""
    if img.dtype != torch.uint8:
        raise TypeError(f"resize_linear_u8 takes uint8, not {img.dtype}")
    h, w = img.shape[:2]
    dev = img.device
    xi, xw = (to_device(t, dev) for t in _linear_taps(w, new_w, True))
    yi, yw = (to_device(t, dev) for t in _linear_taps(h, new_h, False))
    x = img.to(torch.int32)
    rows = (x.index_select(1, xi[0]) * xw[0][:, None]
            + x.index_select(1, xi[1]) * xw[1][:, None])
    r0 = rows.index_select(0, yi[0]) >> 4
    r1 = rows.index_select(0, yi[1]) >> 4
    out = ((((yw[0][:, None, None] * r0) >> 16)
            + ((yw[1][:, None, None] * r1) >> 16) + 2) >> 2)
    return out.clamp(0, 255).to(torch.uint8)


@functools.lru_cache(maxsize=256)
def _nearest_taps(src: int, dst: int) -> torch.Tensor:
    """``INTER_NEAREST`` source indices along one axis, as OpenCV 5.0's
    ``resizeNN`` takes them: ``min(floor(d * (1 / (dst / src))), src - 1)``
    in double. (dst,) int64, a host tensor (cached; never written)."""
    inv = 1.0 / (dst / src)
    idx = np.floor(np.arange(dst, dtype=np.float64) * inv).astype(np.int64)
    return torch.from_numpy(np.minimum(idx, src - 1))


def resize_nearest(img: torch.Tensor, new_h: int, new_w: int) -> torch.Tensor:
    """``cv2.resize(img, (new_w, new_h), interpolation=cv2.INTER_NEAREST)``
    on the last two axes of ``img`` (..., H, W), any dtype: two gathers of
    host-built indices, so bit for bit OpenCV's on either device."""
    h, w = img.shape[-2:]
    dev = img.device
    rows = to_device(_nearest_taps(h, new_h), dev)
    cols = to_device(_nearest_taps(w, new_w), dev)
    return img.index_select(-2, rows).index_select(-1, cols)


@functools.lru_cache(maxsize=256)
def _linear_taps_f32(src: int, dst: int) -> tuple[torch.Tensor, torch.Tensor]:
    """float ``INTER_LINEAR`` taps along one axis, as OpenCV 5's IPP path
    takes them: the source position ``(d + 0.5) * (src / dst) - 0.5`` in
    double, its floor and its fraction rounded to float; a position before
    the first or past the last pixel takes that pixel (fraction 0). (2, dst)
    int64 indices and (dst,) float32 fractions, host tensors (cached; never
    written)."""
    c = (np.arange(dst, dtype=np.float64) + 0.5) * (src / dst) - 0.5
    s = np.floor(c).astype(np.int64)
    f = (c - s).astype(np.float32)
    f[(s < 0) | (s >= src - 1)] = 0
    idx = np.stack([np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1)])
    return torch.from_numpy(idx), torch.from_numpy(f)


# the largest upscale along an axis at which the float resize is held bit
# for bit to OpenCV's (past it, IPP computes the columns and rows more than
# four pixels beyond the outer source centres another way)
RESIZE_F32_EXACT_UPSCALE = 8


def resize_linear_f32(img: torch.Tensor, new_h: int, new_w: int
                      ) -> torch.Tensor:
    """``cv2.resize(img, (new_w, new_h), interpolation=cv2.INTER_LINEAR)``
    on a float32 (H, W, C) tensor, as OpenCV 5.0 computes it with IPP
    (``cv2.ipp.useIPP()`` True, as installed): a horizontal pass
    ``fma(fx, p1 - p0, p0)`` on the two source rows, then a vertical pass
    ``fma(fy, r1 - r0, r0)``, each a float FMA rounded once. Bit for bit
    OpenCV's up to an upscale of ``RESIZE_F32_EXACT_UPSCALE`` per axis; past
    it the outermost columns and rows part from it by a few ulps
    (``tests/test_torch_port_ssd.py``)."""
    if img.dtype != torch.float32:
        raise TypeError(f"resize_linear_f32 takes float32, not {img.dtype}")
    h, w = img.shape[:2]
    dev = img.device
    xi, fx = (to_device(t, dev) for t in _linear_taps_f32(w, new_w))
    yi, fy = (to_device(t, dev) for t in _linear_taps_f32(h, new_h))
    p0 = img.index_select(1, xi[0])
    p1 = img.index_select(1, xi[1])
    rows = _fma_f32(fx[:, None], p1 - p0, p0)
    r0 = rows.index_select(0, yi[0])
    r1 = rows.index_select(0, yi[1])
    return _fma_f32(fy[:, None, None], r1 - r0, r0)


def get_rotation_matrix_2d(center, angle: float, scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D``: (2, 3) float64; the centre is a C float
    point, the angle's cosine and sine from libm."""
    cx, cy = float(np.float32(center[0])), float(np.float32(center[1]))
    angle = angle * (math.pi / 180)
    alpha = math.cos(angle) * scale
    beta = math.sin(angle) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]], np.float64)


def invert_affine(m) -> np.ndarray:
    """OpenCV's inverse of a (2, 3) affine in double (``warpAffine`` without
    ``WARP_INVERSE_MAP``), flattened to 6."""
    m = np.asarray(m, np.float64).reshape(6).copy()
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0] = a11
    m[1] *= -d
    m[3] *= -d
    m[4] = a22
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return m


def _fma_f32(a: torch.Tensor, b: torch.Tensor | float, c: torch.Tensor
             ) -> torch.Tensor:
    """float32 ``fma(a, b, c)``, rounded once: the product is exact in
    double, the sum is rounded to odd there (error-free sum, then the last
    bit forced where the sum was inexact), and round-to-odd at 53 bits then
    to nearest at 24 is the correctly rounded result."""
    p = a.double() * (b.double() if torch.is_tensor(b) else b)
    cd = c.double()
    s = p + cd
    bv = s - p
    err = (p - (s - bv)) + (cd - bv)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.full_like(s, math.inf).where(err > 0, -math.inf)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


# OpenCV 5 warps 8-bit three-channel images in blocks of 16 columns with
# vector FMAs (its AVX2 kernel) and the columns past the last block in
# scalar code that the compiler contracted to FMAs as well.
WARP_BLOCK = 16


def warp_source_coords(m_inv: np.ndarray, h: int, w: int, device
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Source (x, y) of each destination pixel, float32 (h, w), as OpenCV
    5's ``warpAffine`` computes them from the inverse in C float: in the
    vector blocks ``fma(x, M0, y * M1 + M2)``; past them
    ``fma(x, M0, y * M1) + M2``."""
    m = [_c_float(v) for v in m_inv]
    xs = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    ys = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    blocked = (w // WARP_BLOCK) * WARP_BLOCK
    out = []
    for m0, m1, m2 in ((m[0], m[1], m[2]), (m[3], m[4], m[5])):
        xb = xs[:, :blocked].expand(h, blocked)
        vec = _fma_f32(xb, m0, (ys * m1 + m2).expand(h, blocked))
        xt = xs[:, blocked:].expand(h, w - blocked)
        tail = _fma_f32(xt, m0, (ys * m1).expand(h, w - blocked)) + m2
        out.append(torch.cat([vec, tail], 1))
    return out[0], out[1]


def warp_affine(img: torch.Tensor, m, cval=125) -> torch.Tensor:
    """``cv2.warpAffine(img, m, (w, h), INTER_LINEAR, BORDER_CONSTANT,
    cval)``: the inverse map in double, source coordinates in float
    (:func:`warp_source_coords`), bilinear in float as ``fma(a, p01 - p00,
    p00)`` along x then along y, rounded half to even; taps outside the
    image take ``cval``, one level for every channel or one per channel
    (OpenCV's ``borderValue`` scalar, saturated to uchar)."""
    h, w = img.shape[:2]
    sx, sy = warp_source_coords(invert_affine(m), h, w, img.device)
    x0f, y0f = torch.floor(sx), torch.floor(sy)
    a = (sx - x0f)[..., None].expand(h, w, 3)
    b = (sy - y0f)[..., None].expand(h, w, 3)
    # coordinates far outside stay far outside once clamped to +-2 images
    x0 = x0f.clamp(-2 * w - 2, 2 * w + 2).to(torch.int64)
    y0 = y0f.clamp(-2 * h - 2, 2 * h + 2).to(torch.int64)
    src = img.to(torch.float32)
    fill = ([float(min(max(round(c), 0), 255)) for c in cval]
            if isinstance(cval, (tuple, list)) else [float(cval)])
    if len(set(fill)) == 1:
        fill = fill[:1]

    def tap(yy, xx):
        inside = ((yy >= 0) & (yy < h) & (xx >= 0) & (xx < w))[..., None]
        v = src[yy.clamp(0, h - 1), xx.clamp(0, w - 1)]
        if len(fill) == 1:
            return torch.where(inside, v, fill[0])
        return torch.stack([torch.where(inside[..., 0], v[..., c], fill[c])
                            for c in range(v.shape[-1])], -1)

    def lerp(p, q, t):
        return _fma_f32(t, q - p, p)

    v0 = lerp(tap(y0, x0), tap(y0, x0 + 1), a)
    v1 = lerp(tap(y0 + 1, x0), tap(y0 + 1, x0 + 1), a)
    return torch.round(lerp(v0, v1, b)).clamp(0, 255).to(torch.uint8)


# -- OpenCV: HSV on uint8, grayscale, addWeighted --------------------------

HSV_SHIFT = 12


@functools.lru_cache(maxsize=1)
def _hsv_tables() -> tuple[torch.Tensor, torch.Tensor]:
    """OpenCV's ``sdiv_table`` and ``hdiv_table180`` (``RGB2HSV_b``): int32
    host tensors, ``saturate_cast<int>`` (round half to even) of
    ``(255 << 12) / i`` and ``(180 << 12) / (6 i)``, 0 at ``i = 0``."""
    i = np.arange(1, 256, dtype=np.float64)
    sdiv, hdiv = np.zeros(256, np.int32), np.zeros(256, np.int32)
    sdiv[1:] = np.rint((255 << HSV_SHIFT) / i)
    hdiv[1:] = np.rint((180 << HSV_SHIFT) / (6.0 * i))
    return torch.from_numpy(sdiv), torch.from_numpy(hdiv)


def bgr_to_hsv_cv(img: torch.Tensor) -> torch.Tensor:
    """``cv2.cvtColor(img, cv2.COLOR_BGR2HSV)`` on uint8: OpenCV's integer
    path, H in [0, 180), S and V in [0, 255]."""
    sdiv, hdiv = (to_device(t, img.device) for t in _hsv_tables())
    x = img.to(torch.int32)
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    v = torch.maximum(torch.maximum(b, g), r)
    diff = v - torch.minimum(torch.minimum(b, g), r)
    half = 1 << (HSV_SHIFT - 1)
    s = (diff * sdiv[v] + half) >> HSV_SHIFT
    h = torch.where(v == r, g - b,
                    torch.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * hdiv[diff] + half) >> HSV_SHIFT
    h = torch.where(h < 0, h + 180, h)
    return torch.stack([h, s, v], -1).to(torch.uint8)


# OpenCV 5's HSV2BGR on uint8 converts each row in vector blocks of 32
# pixels, then the pixels past the last block in scalar code.
HSV2BGR_BLOCK = 32
# per sector, the table entries that give B, G and R (OpenCV's sector_data)
_HSV_SECTORS = torch.tensor([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1],
                             [0, 1, 3], [2, 1, 0]])


def hsv_to_bgr_cv(hsv: torch.Tensor) -> torch.Tensor:
    """``cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR)`` on uint8: H in 2-degree
    steps (``hscale = 6 / 180``), S and V scaled by ``1 / 255`` in float,
    OpenCV 5's float ``HSV2RGB`` (sector and fraction from ``h * hscale``,
    the four table values ``v``, ``v (1 - s)``, ``v fma(-s, f, 1)``,
    ``v fma(-s, 1 - f, 1)``, its AVX2 build's contractions), then the
    product with 255 to uchar: truncated in each row's vector blocks of
    ``HSV2BGR_BLOCK`` pixels, rounded half to even in the scalar tail past
    them (measured: each of the 2^24 triples, H past 179 too, equals
    ``cv2.cvtColor``'s in rows of 4096 and of 16 pixels, and rows of every
    width from 1 to 80 agree)."""
    x = hsv.to(torch.float32)
    h = x[..., 0] * _c_float(6.0 / 180.0)
    s = x[..., 1] * _c_float(1.0 / 255.0)
    v = x[..., 2] * _c_float(1.0 / 255.0)
    h = torch.where(h >= 6, h - 6, h)
    sector = torch.floor(h)
    f = h - sector
    one = torch.ones_like(s)
    tab = torch.stack([v, v * (1 - s), v * _fma_f32(-s, f, one),
                       v * _fma_f32(-s, 1 - f, one)], -1)
    order = to_device(_HSV_SECTORS, hsv.device)
    idx = order[sector.to(torch.int64).clamp(0, 5)]
    bgr = tab.gather(-1, idx)
    bgr = torch.where((s == 0)[..., None], v[..., None].expand_as(bgr), bgr)
    x = bgr * 255.0
    w = hsv.shape[-2]
    blocked = torch.arange(w, device=hsv.device) < w // HSV2BGR_BLOCK * HSV2BGR_BLOCK
    x = torch.where(blocked[:, None], torch.trunc(x), torch.round(x))
    return x.clamp(0, 255).to(torch.uint8)


def bgr_to_gray_cv(img: torch.Tensor) -> torch.Tensor:
    """``cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)`` on uint8 (OpenCV 5's 15-bit
    fixed point, as :func:`rgb_to_gray_cv` with the channels reversed)."""
    return rgb_to_gray_cv(img.flip(-1))


# AVX2 float32 vectors: 8 lanes. cv2.addWeighted runs an array of at least
# one vector as vectors (the last one overlapping the one before it), a
# shorter one in scalar code.
ADD_WEIGHTED_LANES = 8


def add_weighted(a: torch.Tensor, alpha: float, b: torch.Tensor, beta: float,
                 gamma: float = 0.0) -> torch.Tensor:
    """``cv2.addWeighted(a, alpha, b, beta, gamma)`` on float32 arrays, as
    OpenCV 5's AVX2 build computes it: the three scalars rounded to float;
    ``fma(a, alpha, fma(b, beta, gamma))`` (its ``v_muladd`` pair) where the
    array holds at least ``ADD_WEIGHTED_LANES`` values, else the scalar
    code's contraction ``fma(a, alpha, b * beta) + gamma``."""
    al, be, ga = _c_float(alpha), _c_float(beta), _c_float(gamma)
    a, b = a.to(torch.float32), b.to(torch.float32)
    if a.numel() >= ADD_WEIGHTED_LANES:
        return _fma_f32(a, al, _fma_f32(b, be, torch.full_like(b, ga)))
    return _fma_f32(a, al, b * be) + ga


def saturate_trunc_u8(x: torch.Tensor) -> torch.Tensor:
    """numpy's ``np.clip(x, 0, 255).astype(np.uint8)`` of a float array:
    clamped, then truncated."""
    return x.clamp(0, 255).to(torch.uint8)
