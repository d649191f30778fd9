"""Shared building blocks: convs, norms, scale.

Counterpart of the parts of ``dsl_tpu/models/layers.py`` that the ported
detectors use (``WSConv`` is mmcv's ``ConvWS2d``; ``NormedConv2d`` is the
JAX package's ``NormedConv``). Tensors are NCHW. Convolutions take explicit padding
``p = d*(k-1)//2`` (none for 1x1), which is what the JAX package passes to
``nn.Conv``, so the two frameworks pad alike at every stride.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class FrozenBatchNorm(nn.Module):
    """BatchNorm that always uses its stored statistics (``norm_eval=True``).

    ``weight``/``bias`` are parameters, ``running_mean``/``running_var``
    buffers (mmdet's names). The statistics fold into a scale and shift in
    float32, which then apply in the input's dtype, so a bf16 backbone stays
    bf16.
    """

    def __init__(self, num_features: int, eps: float = 1e-5,
                 zero_init: bool = False):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.zeros(num_features) if zero_init
                                   else torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv32 = self.weight.float() * torch.rsqrt(self.running_var.float()
                                                  + self.eps)
        shift32 = self.bias.float() - self.running_mean.float() * inv32
        return (x * inv32.to(x.dtype)[:, None, None]
                + shift32.to(x.dtype)[:, None, None])


class GroupNorm(nn.GroupNorm):
    """GroupNorm(32, eps 1e-5) as the JAX package builds it.

    flax computes the variance as E[x^2] - E[x]^2; ``F.group_norm`` takes two
    passes. The parity tests state the tolerance that follows.
    """

    def __init__(self, num_channels: int, num_groups: int = 32,
                 zero_init: bool = False):
        super().__init__(num_groups, num_channels, eps=1e-5)
        if zero_init:
            nn.init.zeros_(self.weight)


def make_norm(norm_cfg: dict | None, num_features: int,
              zero_init: bool = False) -> nn.Module:
    """'BN'/'SyncBN' -> FrozenBatchNorm, 'GN' -> GroupNorm. ``zero_init``
    zero-inits the affine scale (mmdet's ``zero_init_residual``)."""
    norm_cfg = norm_cfg or dict(type="BN")
    t = norm_cfg.get("type", "BN")
    if t in ("BN", "SyncBN"):
        return FrozenBatchNorm(num_features, zero_init=zero_init)
    if t == "GN":
        return GroupNorm(num_features, norm_cfg.get("num_groups", 32),
                         zero_init=zero_init)
    raise ValueError(f"unknown norm type {t}")


class Scale(nn.Module):
    """Learnable scalar multiplier (mmcv ``Scale``)."""

    def __init__(self, init_value: float = 1.0):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor(float(init_value)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale


class WSConv(nn.Conv2d):
    """Weight-standardised convolution (mmcv ``ConvWS2d``, the JAX
    package's ``WSConv``): each output channel's kernel is standardised
    over (Cin/groups, kh, kw) before the convolution, with the unbiased
    std taken as ``sqrt(var + 1e-12)`` (so its gradient stays finite where
    a kernel has no spread) and ``eps`` 1e-5 added to it."""

    eps = 1e-5

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        flat = w.reshape(w.shape[0], -1)
        n = flat.shape[1]
        mean = flat.mean(dim=1, keepdim=True)
        var = (flat - mean).square().mean(dim=1, keepdim=True) \
            * (n / max(n - 1, 1))
        std = torch.sqrt(var + 1e-12)
        w = ((flat - mean) / (std + self.eps)).reshape(w.shape)
        return self._conv_forward(x, w.to(x.dtype), self.bias)


class NormedConv2d(nn.Module):
    """The Seesaw configs' normed mask predictor as the JAX package's
    ``NormedConv`` computes it: each output's weights divided by their L2
    norm over (in, kh, kw), each pixel's input by its L2 norm over the
    channels (1e-6 inside both square roots), the conv (padding k // 2),
    times ``tempearture``; no bias. mmdet's ``NormedConv2d`` has a bias and
    adds its eps outside the root: a checkpoint holding that bias raises
    naming the key."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 1, tempearture: float = 20.0):
        super().__init__()
        self.kernel_size = kernel_size
        self.tempearture = float(tempearture)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               kernel_size, kernel_size))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        if f"{prefix}bias" in state_dict:
            raise KeyError(f"{prefix}bias: the normed predictor has no bias "
                           f"(the JAX package's NormedConv; mmdet's "
                           f"NormedConv2d adds one)")
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        wn = w / torch.sqrt((w * w).sum(dim=(1, 2, 3), keepdim=True) + 1e-6)
        xn = x / torch.sqrt((x * x).sum(dim=1, keepdim=True) + 1e-6)
        return F.conv2d(xn, wn, padding=self.kernel_size // 2) * self.tempearture


def is_ws(conv_cfg: dict | None) -> bool:
    return bool(conv_cfg) and conv_cfg.get("type") in ("ConvWS", "ConvWS2d")


def make_conv(conv_cfg: dict | None, in_channels: int, out_channels: int,
              kernel_size: int, stride: int = 1, dilation: int = 1,
              use_bias: bool = False, groups: int = 1) -> nn.Conv2d:
    """``nn.Conv2d`` with the JAX package's explicit padding, or
    :class:`WSConv` for ``conv_cfg=dict(type='ConvWS')``; another conv
    type raises (as mmcv's ``build_conv_layer`` does)."""
    if conv_cfg and not is_ws(conv_cfg):
        raise ValueError(f"unknown conv type {conv_cfg.get('type')!r}")
    p = dilation * (kernel_size - 1) // 2
    cls = WSConv if is_ws(conv_cfg) else nn.Conv2d
    return cls(in_channels, out_channels, kernel_size, stride=stride,
               padding=p, dilation=dilation, groups=groups, bias=use_bias)


def conv3x3(in_channels: int, out_channels: int, stride: int = 1,
            dilation: int = 1, use_bias: bool = False,
            conv_cfg: dict | None = None) -> nn.Conv2d:
    return make_conv(conv_cfg, in_channels, out_channels, 3, stride, dilation,
                     use_bias)


def conv1x1(in_channels: int, out_channels: int, stride: int = 1,
            use_bias: bool = False, conv_cfg: dict | None = None) -> nn.Conv2d:
    return make_conv(conv_cfg, in_channels, out_channels, 1, stride,
                     use_bias=use_bias)


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """3x3/2 max pool with pad 1 (``MaxPool2d(3, 2, 1)``)."""
    return F.max_pool2d(x, 3, stride=2, padding=1)


def he_normal_(weight: torch.Tensor, generator: torch.Generator | None = None):
    """flax ``he_normal``: truncated normal, variance 2/fan_in (a grouped
    conv's fan-in is its group's)."""
    fan_in = weight[0].numel()
    # flax truncates at 2 std and rescales so the variance stays 2/fan_in
    std = math.sqrt(2.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std,
                                 generator=generator)


def normal_init(module: nn.Module, std: float = 0.01, bias: float = 0.0,
                generator: torch.Generator | None = None):
    nn.init.normal_(module.weight, 0.0, std, generator=generator)
    if getattr(module, "bias", None) is not None:
        nn.init.constant_(module.bias, bias)


def bias_init_with_prob(prior_prob: float) -> float:
    """Focal-loss classifier bias: -log((1-p)/p)."""
    return float(-math.log((1 - prior_prob) / prior_prob))


def is_frozen(name: str, frozen_stages: int) -> bool:
    """Whether the backbone parameter ``name`` is frozen, as
    ``dsl_tpu/train/optim.py:45-79`` reads the reference's ``_freeze_stages``:
    with ``frozen_stages >= 0`` the stem (``conv1``, ``bn1``); with
    ``frozen_stages = k`` also stages ``0..k-1``: an RLA-ResNet's with their
    ``conv_outs``, ``recurrent_convs`` and ``stage_bns``, a ResNet's
    ``layer1..layerk``; and always an RLA-ResNet's ``stage_bns.3.2``, the
    hidden-state BN after the last block, whose output nothing reads."""
    parts = name.split(".")
    if parts[:3] == ["stage_bns", "3", "2"]:
        return True
    if frozen_stages < 0:
        return False
    if parts[0] in ("conv1", "bn1"):
        return True
    if parts[0].startswith("layer"):
        return int(parts[0][len("layer"):]) <= frozen_stages
    return (parts[0] in ("stages", "conv_outs", "recurrent_convs", "stage_bns")
            and int(parts[1]) < frozen_stages)


class _ContextLayerNorm(nn.Module):
    """flax ``LayerNorm`` over the channels of a (B, C, 1, 1) context, as
    the JAX package's ``ContextBlock`` normalises it: epsilon 1e-6, the
    variance taken as ``max(E[x^2] - E[x]^2, 0)`` (flax's fast variance),
    then ``(x - mean) * (rsqrt(var + eps) * scale) + bias``. The affine
    parameters are (C, 1, 1), mmcv's ``LayerNorm([planes, 1, 1])``
    shapes, so an mmdet checkpoint loads by its own keys."""

    eps = 1e-6

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels, 1, 1))
        self.bias = nn.Parameter(torch.zeros(channels, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=1, keepdim=True)
        var = torch.clamp_min((x * x).mean(dim=1, keepdim=True)
                              - mean * mean, 0.0)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) \
            + self.bias


class ContextBlock(nn.Module):
    """GCNet's global-context block, as ``dsl_tpu/models/layers.py``'s
    ``ContextBlock`` computes it (mmcv's ``context_block.py``): the
    context is the attention-pooled feature (``conv_mask``, a softmax over
    H*W) or the mean (``pooling_type='avg'``); each fusion transforms it
    by a 1x1 to ``planes`` channels, the LayerNorm above, a relu and a
    zero-initialised 1x1 back; ``channel_mul`` multiplies its sigmoid onto
    every position, then ``channel_add`` adds its own. Submodule names are
    mmcv's (``conv_mask``, ``channel_add_conv.{0,1,3}``,
    ``channel_mul_conv.{0,1,3}``)."""

    def __init__(self, in_channels: int, ratio: float = 1.0 / 4,
                 pooling_type: str = "att",
                 fusion_types=("channel_add",)):
        super().__init__()
        if pooling_type not in ("att", "avg"):
            raise ValueError(f"ContextBlock pooling_type {pooling_type!r}")
        fusion_types = tuple(fusion_types)
        if not fusion_types or set(fusion_types) - {"channel_add",
                                                    "channel_mul"}:
            raise ValueError(f"ContextBlock fusion_types {fusion_types}")
        planes = max(int(in_channels * ratio), 1)
        self.pooling_type = pooling_type
        self.conv_mask = (nn.Conv2d(in_channels, 1, 1)
                          if pooling_type == "att" else None)

        def transform():
            return nn.Sequential(nn.Conv2d(in_channels, planes, 1),
                                 _ContextLayerNorm(planes), nn.ReLU(),
                                 nn.Conv2d(planes, in_channels, 1))

        self.channel_add_conv = (transform() if "channel_add" in fusion_types
                                 else None)
        self.channel_mul_conv = (transform() if "channel_mul" in fusion_types
                                 else None)

    def init_weights(self, generator: torch.Generator | None = None):
        """He-normal convs, the last of each transform zero (the block
        starts as the identity), as the JAX package initialises it."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                he_normal_(m.weight, generator)
                nn.init.zeros_(m.bias)
        for t in (self.channel_add_conv, self.channel_mul_conv):
            if t is not None:
                nn.init.zeros_(t[3].weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        if self.conv_mask is not None:
            attn = torch.softmax(self.conv_mask(x).reshape(b, h * w, 1), dim=1)
            ctx = torch.bmm(x.reshape(b, c, h * w), attn).reshape(b, c, 1, 1)
        else:
            ctx = x.mean(dim=(2, 3), keepdim=True)
        out = x
        if self.channel_mul_conv is not None:
            out = out * torch.sigmoid(self.channel_mul_conv(ctx))
        if self.channel_add_conv is not None:
            out = out + self.channel_add_conv(ctx)
        return out


def refuse_foreign_keys(module: nn.Module, state_dict: dict, prefix: str,
                        what: str):
    """From a module's ``_load_from_state_dict``: raise naming the first
    key under ``prefix`` that is none of the module's own (an mmdet
    checkpoint of a part the JAX package builds otherwise)."""
    own = set(module.state_dict())
    for key in state_dict:
        if key.startswith(prefix) and key[len(prefix):] not in own:
            raise KeyError(f"{key}: no counterpart in {what}")


class GeneralizedAttention(nn.Module):
    """Generalized spatial attention as ``dsl_tpu/models/layers.py``'s
    ``GeneralizedAttention`` computes it (an independent design, not
    mmcv's): the logits of each of ``num_heads`` heads are the sum of the
    terms the ``attention_type`` bits select, [0] query . key, [1] query .
    relative position, [2] a learned bias . key, [3] a learned bias .
    relative position, over keys and values subsampled by ``kv_stride``
    (every ``kv_stride``-th row and column); the position term factorises
    additively over y and x, each offset's sine features through
    ``geom_fc_y`` / ``geom_fc_x``. ``spatial_range`` > 0 masks keys farther
    than it in y or x with -1e9. A softmax over the keys weighs the
    values; ``proj_conv``'s output, times the zero-initialised ``gamma``,
    is added to the input.

    Channels split head-major, as the JAX package's ``reshape(b, h, w, m,
    dk)``: ``view(B, m, dk, H, W)`` in NCHW. The parameters carry the JAX
    package's names (``query_conv`` only where term 0 or 1 is on, as
    there; ``key_conv`` always); a key of mmcv's module that has no
    counterpart here (``appr_geom_fc_x``, ``appr_bias``, ...) raises on
    load, naming the key."""

    def __init__(self, in_channels: int, num_heads: int = 8,
                 attention_type: str = "1111", kv_stride: int = 2,
                 spatial_range: int = -1, position_magnitude: float = 1.0):
        super().__init__()
        if len(attention_type) != 4 or set(attention_type) - {"0", "1"}:
            raise ValueError(f"attention_type {attention_type!r}: four bits")
        self.bits = [ch == "1" for ch in attention_type]
        self.num_heads = num_heads
        self.kv_stride = kv_stride
        self.spatial_range = spatial_range
        self.position_magnitude = position_magnitude
        m = num_heads
        dk = max(in_channels // m, 1)
        self.dk = dk
        bits = self.bits
        self.query_conv = (nn.Conv2d(in_channels, m * dk, 1, bias=False)
                           if bits[0] or bits[1] else None)
        self.key_conv = nn.Conv2d(in_channels, m * dk, 1, bias=False)
        self.value_conv = nn.Conv2d(in_channels, in_channels, 1, bias=False)
        self.key_content_bias = (nn.Parameter(torch.zeros(m, dk)) if bits[2]
                                 else None)
        if bits[1] or bits[3]:
            half = max(dk, 2) // 2
            self.geom_fc_y = nn.Linear(2 * half, m * dk, bias=False)
            self.geom_fc_x = nn.Linear(2 * half, m * dk, bias=False)
        else:
            self.geom_fc_y = self.geom_fc_x = None
        self.geom_bias = nn.Parameter(torch.zeros(m, dk)) if bits[3] else None
        self.proj_conv = nn.Conv2d(in_channels, in_channels, 1)
        self.gamma = nn.Parameter(torch.zeros(()))

    def init_weights(self, generator: torch.Generator | None = None):
        """The JAX package's init: he-normal 1x1s, normal(1/sqrt(dk))
        biases, lecun-normal position FCs, ``gamma`` 0."""
        for conv in (self.query_conv, self.key_conv, self.value_conv,
                     self.proj_conv):
            if conv is not None:
                he_normal_(conv.weight, generator)
        nn.init.zeros_(self.proj_conv.bias)
        for p in (self.key_content_bias, self.geom_bias):
            if p is not None:
                nn.init.normal_(p, 0.0, self.dk ** -0.5, generator=generator)
        for fc in (self.geom_fc_y, self.geom_fc_x):
            if fc is not None:
                std = fc.in_features ** -0.5 / 0.87962566103423978
                nn.init.trunc_normal_(fc.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
        nn.init.zeros_(self.gamma)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        refuse_foreign_keys(self, state_dict, prefix, "the JAX package's "
                            "GeneralizedAttention (mmcv's differs)")
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def _pos_embed(self, n: int, nk: int, device, dtype) -> torch.Tensor:
        """Sine features of the offsets i - j * kv_stride: (n, nk, 2 *
        half), as the JAX package's ``_pos_embed``."""
        half = max(self.dk, 2) // 2
        rel = (torch.arange(n, dtype=torch.float32, device=device)[:, None]
               - torch.arange(nk, dtype=torch.float32, device=device)[None]
               * self.kv_stride)
        freq = torch.pow(torch.tensor(100.0, device=device),
                         -torch.arange(half, dtype=torch.float32,
                                       device=device) / half)
        ang = rel[..., None] * freq / self.position_magnitude
        return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bits = self.bits
        b, c, h, w = x.shape
        m, dk, s = self.num_heads, self.dk, self.kv_stride
        kv = x[:, :, ::s, ::s]
        hk, wk = kv.shape[2:]
        k = self.key_conv(kv).reshape(b, m, dk, hk, wk)
        v = self.value_conv(kv).reshape(b, m, c // m, hk * wk)
        q = (self.query_conv(x).reshape(b, m, dk, h, w) * dk ** -0.5
             if self.query_conv is not None else None)
        terms = []
        if bits[0]:
            qeff = q
            if bits[2]:
                qeff = q + self.key_content_bias.to(x.dtype)[None, :, :,
                                                             None, None]
            terms.append(torch.einsum("bmdyw,bmdvu->bmywvu", qeff, k))
        elif bits[2]:
            # the bias alone: one logit per key, the same at every query
            terms.append(torch.einsum("md,bmdvu->bmvu",
                                      self.key_content_bias.to(x.dtype),
                                      k)[:, :, None, None])
        if bits[1] or bits[3]:
            ry = self.geom_fc_y(self._pos_embed(h, hk, x.device, x.dtype)
                                ).reshape(h, hk, m, dk)
            rx = self.geom_fc_x(self._pos_embed(w, wk, x.device, x.dtype)
                                ).reshape(w, wk, m, dk)
            qg = q if bits[1] else x.new_zeros((b, m, dk, h, w))
            if bits[3]:
                qg = qg + self.geom_bias.to(x.dtype)[None, :, :, None, None]
            terms.append(torch.einsum("bmdyw,yvmd->bmywv", qg, ry)[..., None])
            terms.append(torch.einsum("bmdyw,wumd->bmywu", qg, rx)[
                ..., None, :])
        logits = None
        for t in terms:
            logits = t if logits is None else logits + t
        if logits is None:
            logits = x.new_zeros((b, m, 1, 1, hk, wk))
        if self.spatial_range > 0:
            dev = x.device
            yy = (torch.arange(h, device=dev)[:, None]
                  - torch.arange(hk, device=dev)[None] * s).abs()
            xx = (torch.arange(w, device=dev)[:, None]
                  - torch.arange(wk, device=dev)[None] * s).abs()
            near = ((yy[:, None, :, None] <= self.spatial_range)
                    & (xx[None, :, None, :] <= self.spatial_range))
            logits = logits.masked_fill(~near, -1e9)
        # (B, m, 1, 1, Hk, Wk) where no term depends on the query: one
        # softmax serves every position
        nq = logits.shape[2] * logits.shape[3]
        attn = torch.softmax(logits.reshape(b, m, nq, hk * wk), dim=-1)
        out = torch.matmul(v, attn.transpose(2, 3))
        out = out.expand(b, m, c // m, h * w).reshape(b, c, h, w)
        return x + self.gamma.to(x.dtype) * self.proj_conv(out)
