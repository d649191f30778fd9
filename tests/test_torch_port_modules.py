"""Port modules against the JAX package, in f32, at small sizes.

Inputs and variables are seeded numpy handed to both frameworks; layouts
are converted at the boundary (NHWC <-> NCHW, HWIO <-> OIHW through the
weight bridge). Tolerances:

- box math and points: exact up to 1 ulp-scale rounding (rtol 1e-6);
- single layers (FrozenBN, conv, pool, upsample): rtol/atol 1e-5;
- GroupNorm: flax takes the variance as E[x^2] - E[x]^2, ``F.group_norm``
  in two passes: rtol/atol 1e-4;
- conv stacks (backbone, FPN, head): rtol 1e-4 and atol 1e-4 times the
  output's largest magnitude (sums over thousands of products in another
  order).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import flax.linen as fnn

import torch_port_util as U
from dsl_tpu.core import boxes as jboxes
from dsl_tpu.core.points import MlvlPointGenerator as JPoints
from dsl_tpu.models import layers as jlayers
from dsl_tpu.models.necks.fpn import _upsample_nearest_2x as j_upsample
from dsl_tpu_torch.core import boxes as tboxes
from dsl_tpu_torch.core.points import MlvlPointGenerator as TPoints
from dsl_tpu_torch.models import layers as tlayers
from dsl_tpu_torch.models.necks.fpn import _upsample_nearest_2x as t_upsample

torch.set_num_threads(2)


nchw, nhwc = U.nchw, U.nhwc


def _boxes(rng, n):
    xy = rng.rand(n, 2).astype(np.float32) * 100
    wh = rng.rand(n, 2).astype(np.float32) * 40
    wh[::5] = 0.0                               # some zero-area boxes
    return np.concatenate([xy, xy + wh], -1)


def test_box_math_matches_jax():
    rng = np.random.RandomState(0)
    a, b = _boxes(rng, 37), _boxes(rng, 23)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(tboxes.bbox_area(ta).numpy(),
                               np.asarray(jboxes.bbox_area(a)), rtol=1e-6)
    np.testing.assert_allclose(tboxes.bbox_overlaps(ta, tb).numpy(),
                               np.asarray(jboxes.bbox_overlaps(a, b)),
                               rtol=1e-6, atol=1e-7)
    pts = rng.rand(37, 2).astype(np.float32) * 100
    dist = rng.rand(37, 4).astype(np.float32) * 60
    np.testing.assert_allclose(
        tboxes.distance2bbox(torch.from_numpy(pts), torch.from_numpy(dist),
                             (64, 96)).numpy(),
        np.asarray(jboxes.distance2bbox(pts, dist, (64, 96))), rtol=1e-6)
    np.testing.assert_array_equal(
        tboxes.clip_boxes(ta * 2 - 20, (50, 70)).numpy(),
        np.asarray(jboxes.clip_boxes(a * 2 - 20, (50, 70))))


def test_points_match_jax():
    sizes = [(100, 168), (50, 84), (25, 42), (13, 21), (7, 11)]
    strides = [8, 16, 32, 64, 128]
    got = TPoints(strides).grid_points(sizes)
    want = JPoints(strides).grid_points(sizes)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_frozen_bn_matches_jax(dtype):
    rng = np.random.RandomState(1)
    c = 16
    v = {"params": {"scale": rng.randn(c).astype(np.float32),
                    "bias": rng.randn(c).astype(np.float32)},
         "batch_stats": {"mean": rng.randn(c).astype(np.float32),
                         "var": rng.uniform(0.5, 2, c).astype(np.float32)}}
    x = rng.randn(2, 5, 7, c).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jlayers.FrozenBatchNorm().apply(v, jnp.asarray(x).astype(jd))
    bn = tlayers.FrozenBatchNorm(c)
    bn.load_state_dict({"weight": torch.from_numpy(v["params"]["scale"]),
                        "bias": torch.from_numpy(v["params"]["bias"]),
                        "running_mean": torch.from_numpy(v["batch_stats"]["mean"]),
                        "running_var": torch.from_numpy(v["batch_stats"]["var"])})
    got = bn(nchw(x).to(td))
    assert got.dtype == td
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(nhwc(got.float()),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


def test_group_norm_matches_jax():
    rng = np.random.RandomState(2)
    c = 64
    x = (rng.randn(2, 6, 9, c) * 3 + 1).astype(np.float32)
    scale = rng.randn(c).astype(np.float32)
    bias = rng.randn(c).astype(np.float32)
    want = fnn.GroupNorm(num_groups=32, epsilon=1e-5).apply(
        {"params": {"scale": scale, "bias": bias}}, jnp.asarray(x))
    gn = tlayers.make_norm(dict(type="GN", num_groups=32), c)
    gn.load_state_dict({"weight": torch.from_numpy(scale),
                        "bias": torch.from_numpy(bias)})
    np.testing.assert_allclose(nhwc(gn(nchw(x))), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


def _group_norm_input_grad(x: np.ndarray, dy: np.ndarray, scale, bias,
                           dtype):
    """(flax's, the port's) gradient of sum(GroupNorm(x) * dy) in x, NHWC,
    computed in ``dtype``."""
    with jax.enable_x64(dtype == np.float64):
        params = {"params": {"scale": jnp.asarray(scale, dtype),
                             "bias": jnp.asarray(bias, dtype)}}
        want = np.asarray(jax.grad(lambda v: jnp.sum(
            fnn.GroupNorm(num_groups=32, epsilon=1e-5).apply(params, v)
            * jnp.asarray(dy, dtype)))(jnp.asarray(x, dtype)))
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    gn = tlayers.make_norm(dict(type="GN", num_groups=32), x.shape[-1]).to(tdt)
    gn.load_state_dict({"weight": torch.tensor(scale, dtype=tdt),
                        "bias": torch.tensor(bias, dtype=tdt)})
    xt = nchw(x).to(tdt).requires_grad_(True)
    (gn(xt) * nchw(dy).to(tdt)).sum().backward()
    return want, nhwc(xt.grad)


@pytest.mark.parametrize("channels", [256, 64])
def test_group_norm_grad_on_a_1x1_map(channels):
    """GroupNorm's gradient in x on a 1x1 map (the stride-128 level of a
    64x96 canvas), each framework in f32 against the f64 gradient, which
    both give alike (1e-9). With the config's 8 channels per group (256)
    both f32 gradients are within 1e-5 of the largest. With 2 per group
    (the 64-wide tiny head) the output is d / sqrt(d^2 + eps) and its
    gradient is negligible except where a group's variance nears eps; at
    the two values the supervised baseline's fourth step gave there
    (variance 1.96e-6 < eps = 1e-5, about 1e-7 of their squared mean) the
    backward cancels (|x| 3.95 against |x - mean| 1.4e-3), and both
    frameworks' f32 gradients part from the f64 one by more than 1e-3 of
    the largest."""
    rng = np.random.RandomState(5)
    x = (rng.randn(1, 1, 1, channels) * 3 + 1).astype(np.float32)
    if channels == 64:
        x[0, 0, 0, 36:38] = [3.9486124515533447, 3.9458093643188477]
    dy = rng.randn(*x.shape).astype(np.float32)
    scale = rng.randn(channels).astype(np.float32)
    bias = rng.randn(channels).astype(np.float32)
    want64, got64 = _group_norm_input_grad(x, dy, scale, bias, np.float64)
    np.testing.assert_allclose(got64, want64, rtol=1e-9, atol=1e-9)
    want32, got32 = _group_norm_input_grad(x, dy, scale, bias, np.float32)
    peak = np.abs(want64).max()
    for err in (np.abs(got32 - want64).max(), np.abs(want32 - want64).max()):
        if channels == 256:
            assert err <= 1e-5 * peak
        else:
            assert err > 1e-3 * peak


@pytest.mark.parametrize("k,stride,dilation", [(3, 2, 1), (1, 2, 1), (3, 1, 2)])
def test_conv_padding_matches_jax(k, stride, dilation):
    rng = np.random.RandomState(3)
    x = rng.randn(1, 13, 10, 8).astype(np.float32)       # odd sizes
    w = rng.randn(k, k, 8, 6).astype(np.float32) * 0.1
    conv = jlayers.make_conv(None, 6, k, stride=stride, dilation=dilation)
    want = conv.apply({"params": {"kernel": w}}, jnp.asarray(x))
    tconv = tlayers.make_conv(None, 8, 6, k, stride=stride, dilation=dilation)
    tconv.weight.data = torch.from_numpy(w.transpose(3, 2, 0, 1).copy())
    np.testing.assert_allclose(nhwc(tconv(nchw(x))), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_pool_upsample_scale_match_jax():
    rng = np.random.RandomState(4)
    x = rng.randn(2, 13, 11, 3).astype(np.float32)
    np.testing.assert_array_equal(
        nhwc(tlayers.max_pool_3x3_s2(nchw(x))),
        np.asarray(jlayers.max_pool_3x3_s2(jnp.asarray(x))))
    small = rng.randn(1, 4, 3, 2).astype(np.float32)
    np.testing.assert_array_equal(
        nhwc(t_upsample(nchw(small), (7, 5))),
        np.asarray(j_upsample(jnp.asarray(small), (7, 5))))
    s = tlayers.Scale(1.0)
    s.scale.data.fill_(0.75)
    want = jlayers.Scale().apply({"params": {"scale": np.float32(0.75)}},
                                 jnp.asarray(x))
    np.testing.assert_array_equal(nhwc(s(nchw(x))), np.asarray(want))


# ---------------------------------------------------------------------------
# backbone -> neck -> head of the tiny flagship, each fed the JAX outputs of
# the stage before it
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    det, var = U.jax_detector_and_variables(U.TINY_CFG, seed=0)
    port = U.port_detector(U.TINY_CFG, var)
    x = U.images(1, 2, (64, 96))

    def stage(fn):
        return jax.jit(lambda v, a: det.apply(v, a, method=fn))

    feats = stage(lambda m, a: m.backbone(a))(var, jnp.asarray(x))
    pyr = stage(lambda m, a: m.neck(a))(var, feats)
    head = stage(lambda m, a: m.bbox_head(a, training=False))(var, pyr)
    return port, x, feats, pyr, head


def _assert_stack(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * max(np.abs(want).max(), 1.0))


def test_rla_backbone_matches_jax(tiny):
    port, x, feats, _, _ = tiny
    with torch.no_grad():
        got = port.backbone(nchw(x))
    assert len(got) == len(feats) == 4
    for g, w in zip(got, feats):
        _assert_stack(nhwc(g), w)


def test_fpn_matches_jax(tiny):
    port, _, feats, pyr, _ = tiny
    with torch.no_grad():
        got = port.neck(tuple(nchw(f) for f in feats))
    assert len(got) == len(pyr) == 5
    for g, w in zip(got, pyr):
        _assert_stack(nhwc(g), w)


def test_fcos_head_matches_jax(tiny):
    port, _, _, pyr, head = tiny
    with torch.no_grad():
        got = port.bbox_head(tuple(nchw(p) for p in pyr))
    for g_lvls, w_lvls in zip(got, head):
        for g, w in zip(g_lvls, w_lvls):
            assert g.shape == w.shape                  # NHWC, as in JAX
            _assert_stack(g.numpy(), w)
