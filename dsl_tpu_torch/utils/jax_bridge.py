"""Weight bridge between the JAX package's flax variables and the port's
``state_dict``.

``flax_to_state_dict`` maps a ``{"params", "batch_stats"}`` tree of numpy
arrays (as ``dsl_tpu``'s detectors hold them) to the port's state_dict;
``state_dict_to_flax`` maps back. Neither imports JAX or flax: the tree is
plain nested dicts. What changes on the way:

- conv kernels: flax HWIO <-> torch OIHW (``transpose(3, 2, 0, 1)``);
- FrozenBN: ``params/scale,bias`` + ``batch_stats/mean,var`` <->
  ``weight, bias, running_mean, running_var``; GroupNorm ``scale,bias`` <->
  ``weight, bias``; the per-level ``Scale`` keeps its scalar ``scale``;
- Dense kernels (in, out) <-> ``nn.Linear`` weights (out, in). The RoI
  head's ``shared_fc0`` (each cascade stage's, and the mask IoU head's
  ``fc0``) reads RoI features flattened (h, w, c) in the JAX package
  (NHWC) and (c, h, w) in the port (NCHW, mmdet's order): its input rows
  are permuted on the way, so a JAX checkpoint computes the same function
  here and an mmdet checkpoint's ``shared_fcs.0`` (``fcs.0``) loads as it
  is;
- PointRend's coarse mask head flattens (h, w, c) into its ``fc0`` and
  writes its logits (h, w, classes) in the JAX package, (c, h, w) and
  (classes, h, w) in the port (mmdet's orders): ``fcs.0``'s input rows and
  ``fc_logits``' output rows (weight and bias) are permuted on the way;
- SCNet's relay head's ``fc`` writes a (s, s, c) map in the JAX package
  and a (c, s, s) one in the port (mmdet's order): its output rows
  (weight and bias) are permuted on the way;
- a SAC's ``weight`` and ``weight_diff`` (flax params of that name, HWIO)
  <-> OIHW, as a kernel;
- the mask head's ``upsample`` (each HTC stage's too): flax's ``ConvTranspose`` kernel (kh, kw,
  in, out) without ``transpose_kernel`` gives ``out[2i + a] = x[i]
  k[1 - a]``, torch's ``ConvTranspose2d`` weight (in, out, kh, kw) gives
  ``out[2i + a] = x[i] w[a]``: the kernel is flipped in both spatial axes
  on the way;
- module names: flax's flat names (``layer2_0``, ``stage_bn1_0``,
  ``extra_conv0``, ``cls_gn3``, ``scale2``, ``shared_fc1``) <-> the
  mmdet/RLA checkpoint names the port's modules carry (``stages.1.0``,
  ``stage_bns.1.0``, ``fpn_convs.3.conv``, ``cls_convs.3.gn``,
  ``scales.2``, ``shared_fcs.1``), and for the variants
  (``stem_conv1`` / ``stem_bn1`` of a deep stem <-> ``stem.3`` /
  ``stem.4``; ``fpn_norm2`` <-> ``fpn_convs.2.gn``; ``shared_conv3`` /
  ``shared_norm3`` <-> ``shared_convs.3.conv`` / ``.gn``; SSD's modules
  keep the JAX package's names, ``l2_norm`` its ``weight``); a two-stage
  or Fast R-CNN detector's top-level ``bbox_head`` <->
  ``roi_head.bbox_head``, a Cascade R-CNN's ``bbox_heads_{i}`` <->
  ``roi_head.bbox_head.{i}`` (told from the multi-head detector's
  ``bbox_heads_{i}`` by the ``rpn_head`` beside them), a Mask R-CNN's
  ``mask_head.conv{i}``, ``upsample`` and ``conv_logits`` <->
  ``roi_head.mask_head.convs.{i}.conv``, ``.upsample`` and
  ``.conv_logits`` (a Cascade Mask R-CNN's one mask head too), a Mask
  Scoring R-CNN's ``mask_iou_head.conv{i}``, ``fc{i}`` and
  ``fc_mask_iou`` <-> ``roi_head.mask_iou_head.convs.{i}.conv``,
  ``.fcs.{i}`` and ``.fc_mask_iou``, PointRend's coarse mask head's
  ``mask_head.downsample_conv`` and ``fc{i}`` <->
  ``roi_head.mask_head.downsample_conv.conv`` and ``.fcs.{i}`` and its
  point head's ``point_head.fc{i}`` <-> ``roi_head.point_head.fcs.{i}.conv``
  (mmdet's ``Conv1d`` weights, (out, in, 1), against the JAX package's
  ``Dense`` kernels), YOLACT's ``bbox_head.head_conv{i}`` <->
  ``bbox_head.head_convs.{i}.conv`` and its ``proto_head`` (``proto_conv{j}``,
  ``post_up_conv``, ``proto_out``) <-> mmdet's protonet ``Sequential``
  (``mask_head.protonet.{2j}``, then the two indices after the upsample
  and its relu), a C4 detector's
  ``shared_head.block{i}`` <-> ``roi_head.shared_head.layer{S+1}.{i}``
  (S the stage, from the blocks' width); an HTC's ``mask_heads_{i}``
  (``conv{j}``, ``conv_res``) <-> ``roi_head.mask_head.{i}`` (``convs.{j}.conv``,
  ``conv_res.conv``) and its ``semantic_head`` (``lateral{i}``, ``conv{i}``,
  ``conv_embedding``, ``conv_logits``) <-> ``roi_head.semantic_head``
  (``lateral_convs.{i}.conv``, ``convs.{i}.conv``, ``conv_embedding.conv``,
  ``conv_logits``); an SCNet's ``glbctx_head`` (``res{i}`` or ``conv{i}``,
  ``fc``), ``relay_head`` and mask head's ``res{i}`` <->
  ``roi_head.glbctx_head`` (``convs.{i}``, ``convs.{i}.conv``, ``fc``),
  ``roi_head.feat_relay_head`` and ``roi_head.mask_head.convs.{i}``; a
  DetectoRS backbone's ``stem_conv``, ``stem_bn`` and ``stages_{S}_{B}``
  <-> ``conv1``, ``bn1`` and ``layer{S+1}.{B}`` (the second backbone of
  the RFP neck's too, ``neck.rfp_modules_{i}`` <-> ``neck.rfp_modules.{i}``),
  the RFP neck's ``fpn`` at the neck's top level (mmdet's ``RFP`` is an
  ``FPN``) and ``rfp_aspp.aspp{i}`` <-> ``rfp_aspp.aspp.{i}`` (told from a
  ResNet by a SAC's ``weight_diff`` or an ``rfp_conv`` in its blocks: a
  DetectoRS backbone with neither has a ResNet's names here); a multi-head
  detector's ``necks_0`` and ``bbox_heads_1`` <-> ``necks.0`` and
  ``bbox_heads.1`` (its necks are alike: the first one's laterals count
  for all). A block
  ``layerS_B`` is an RLA-ResNet's ``stages.{S-1}.B`` where the backbone has
  the RLA hidden-state convs (``conv_out0``), else a ResNet's ``layerS.B``;
- the backbones of slice 16 under mmdet's names: HRNet's
  ``transition{s}_{b}_conv`` / ``_bn`` <-> ``transition{s+1}.{b}.{0,1}``
  (an adapted branch) or ``.{b}.0.{0,1}`` (a new one, told by the branch
  count of the stage before), ``stage{S}_module{m}`` <-> ``stage{S}.{m}``,
  ``branch{b}_block{k}`` <-> ``branches.{b}.{k}``, ``fuse{i}_{j}_conv`` /
  ``_bn`` <-> ``fuse_layers.{i}.{j}.{0,1}`` and ``fuse{i}_{j}_ds{k}_conv`` /
  ``_bn`` <-> ``fuse_layers.{i}.{j}.{k}.{0,1}``; HRFPN's ``reduction_conv``
  and ``fpn_conv{i}`` <-> ``reduction_conv.conv`` and ``fpn_convs.{i}.conv``;
  the avg-down shortcut of ResNeSt and Res2Net (``downsample_conv`` /
  ``_bn`` <-> ``downsample.{1,2}``, ``downsample.0`` being mmdet's pool),
  Res2Net's ``conv2_{k}`` / ``bn2_{k}`` <-> ``convs.{k}`` / ``bns.{k}``,
  ResNeSt's split-attention FCs (the JAX package's ``Dense`` kernels (in,
  out) <-> mmdet's 1x1 convs (out, in, 1, 1)), MobileNetV2's ``conv1`` /
  ``bn1`` <-> ``conv1.{conv,bn}`` and ``{expand,depthwise,project}_{conv,bn}``
  <-> ``{expand,depthwise,linear}_conv.{conv,bn}``. RegNet has a ResNet's
  names;
- the plugins and the other necks: a bottleneck's ``plugin{k}`` <-> mmcv's abbreviation
  (``context_block``, ``gen_attention_block``; back by each block's order
  of appearance), a ContextBlock's ``channel_{add,mul}_conv1`` / ``_ln`` /
  ``_conv2`` <-> ``channel_{add,mul}_conv.{0,1,3}`` (its LayerNorm's
  affine (planes,) <-> mmcv's (planes, 1, 1)); a list neck's ``necks_{i}``
  <-> ``neck.{i}``; BFP's ``refine`` <-> ``refine.conv``; PAFPN's
  ``downsample_conv{i}`` and ``pafpn_conv{i}`` <-> ``downsample_convs.{i}.conv``
  and ``pafpn_convs.{i-1}.conv``; FPN_CARAFE's ``lateral{i}`` and
  ``up{i}`` <-> ``lateral_convs.{i}.conv`` and ``upsample_modules.{i-1}``,
  the content encoder's output channels permuted from the JAX package's
  sub-pixel-major order to mmcv's tap-major one (and back);
  RetinaSepBNHead's ``{cls,reg}_conv{i}`` <-> every level's
  ``{cls,reg}_convs.{l}.{i}.conv`` (one kernel, as mmdet ties them) and
  ``{cls,reg}_bn_l{l}_s{i}`` <-> ``.{l}.{i}.bn``; NASFCOSHead's
  ``{cls,reg}_op{i}`` (a deformable op's kernel its own leaf, its offset
  conv ``conv_offset``) <-> ``{cls,reg}_convs.{i}.conv`` and ``.gn``. The
  NAS-FPN, NAS-FCOS FPN, FPG and GeneralizedAttention modules carry the
  JAX package's names.

``dsl_tpu_torch.train.bridge`` carries a whole train state across on top of
these two.
"""

from __future__ import annotations

import re

import numpy as np
import torch

# (flax dotted module path pattern, torch replacement); `{n_lat}` is the
# number of FPN laterals, where mmdet's fpn_convs list continues with the
# extra convs.
_TO_TORCH = [
    (r"\b(necks|bbox_heads)_(\d+)\b", lambda m, n: f"{m[1]}.{m[2]}"),
    (r"\blayer(\d+)_(\d+)\b", lambda m, n: f"stages.{int(m[1]) - 1}.{m[2]}"),
    # a ResNet block's (PointRend's coarse mask head has its own)
    (r"(?<!mask_head\.)\bdownsample_conv\b", lambda m, n: "downsample.0"),
    (r"\bdownsample_bn\b", lambda m, n: "downsample.1"),
    (r"\bconv_out(\d+)\b", lambda m, n: f"conv_outs.{m[1]}"),
    (r"\brecurrent_conv(\d+)\b", lambda m, n: f"recurrent_convs.{m[1]}"),
    (r"\bstage_bn(\d+)_(\d+)\b", lambda m, n: f"stage_bns.{m[1]}.{m[2]}"),
    (r"\blateral_conv(\d+)\b", lambda m, n: f"lateral_convs.{m[1]}.conv"),
    (r"\bfpn_conv(\d+)\b", lambda m, n: f"fpn_convs.{m[1]}.conv"),
    (r"\bextra_conv(\d+)\b", lambda m, n: f"fpn_convs.{n + int(m[1])}.conv"),
    (r"\b(cls|reg)_conv(\d+)\b", lambda m, n: f"{m[1]}_convs.{m[2]}.conv"),
    (r"\b(cls|reg)_gn(\d+)\b", lambda m, n: f"{m[1]}_convs.{m[2]}.gn"),
    (r"\bscale(\d+)\b", lambda m, n: f"scales.{m[1]}"),
    (r"\bshared_fc(\d+)\b", lambda m, n: f"shared_fcs.{m[1]}"),
    (r"\bshared_conv(\d+)\b", lambda m, n: f"shared_convs.{m[1]}.conv"),
    (r"\bshared_norm(\d+)\b", lambda m, n: f"shared_convs.{m[1]}.gn"),
    (r"\bstem_conv(\d+)\b", lambda m, n: f"stem.{3 * int(m[1])}"),
    (r"\bstem_bn(\d+)\b", lambda m, n: f"stem.{3 * int(m[1]) + 1}"),
    (r"\blateral_norm(\d+)\b", lambda m, n: f"lateral_convs.{m[1]}.gn"),
    (r"\bfpn_norm(\d+)\b", lambda m, n: f"fpn_convs.{m[1]}.gn"),
    (r"\bextra_norm(\d+)\b", lambda m, n: f"fpn_convs.{n + int(m[1])}.gn"),
    (r"^bbox_head\.vfnet_reg_conv$", lambda m, n: "bbox_head.vfnet_reg_conv.conv"),
    (r"^bbox_head\.vfnet_reg_conv_gn$", lambda m, n: "bbox_head.vfnet_reg_conv.gn"),
    (r"^bbox_head\.(reg_refine|cls)_dconv$",
     lambda m, n: f"bbox_head.vfnet_{m[1]}_dconv"),
    (r"\bscale_refine(\d+)\b", lambda m, n: f"scales_refine.{m[1]}"),
    (r"^roi_pool_pack\.offset_fc(\d)$",
     lambda m, n: f"roi_head.roi_pool_pack.offset_fc.{2 * int(m[1])}"),
    (r"^roi_pool_pack\.mask_fc(\d)$",
     lambda m, n: f"roi_head.roi_pool_pack.mask_fc.{2 * int(m[1])}"),
]

# a ResNet's blocks, applied before _TO_TORCH where the backbone is no
# RLA-ResNet
_RESNET_TO_TORCH = [(r"\blayer(\d+)_(\d+)\b", lambda m, n: f"layer{m[1]}.{m[2]}")]

# the split-attention FCs of a ResNeSt block: Dense kernels in the JAX
# package, 1x1 convs in the port (mmdet's)
SA_FC = re.compile(r"^backbone\.layer\d+\.\d+\.conv2\.fc[12]$")
_BLOCK = r"^(backbone\.layer\d+_\d+)"        # a backbone block, flax names
_TBLOCK = r"^(backbone\.layer\d+\.\d+)"      # the same, the port's names


def _backbone_to_torch(params: dict) -> list:
    """The renames of an HRNet, ResNeSt, Res2Net or MobileNetV2 backbone
    and of an HRFPN neck (flax -> port), applied before the ResNet rules."""
    bb = params.get("backbone", {})
    blocks = [v for k, v in bb.items() if re.fullmatch(r"layer\d+_\d+", k)]
    rules = []
    if "stage2_module0" in bb:
        # a transition's branch b is new where the stage before had b or
        # fewer branches (stage 1 has one)
        prev = {0: 1}
        for si in (1, 2):
            prev[si] = sum(1 for k in bb.get(f"stage{si + 1}_module0", {})
                           if re.fullmatch(r"branch\d+_block0", k))
        rules += [
            (r"^backbone\.transition(\d+)_(\d+)_(conv|bn)$",
             lambda m, n: (f"backbone.transition{int(m[1]) + 1}.{m[2]}."
                           + ("0." if int(m[2]) >= prev[int(m[1])] else "")
                           + ("0" if m[3] == "conv" else "1"))),
            (r"^backbone\.(stage\d)_module(\d+)\b",
             lambda m, n: f"backbone.{m[1]}.{m[2]}"),
            (r"\bbranch(\d+)_block(\d+)\b",
             lambda m, n: f"branches.{m[1]}.{m[2]}"),
            (r"\bfuse(\d+)_(\d+)_ds(\d+)_(conv|bn)$",
             lambda m, n: (f"fuse_layers.{m[1]}.{m[2]}.{m[3]}."
                           + ("0" if m[4] == "conv" else "1"))),
            (r"\bfuse(\d+)_(\d+)_(conv|bn)$",
             lambda m, n: (f"fuse_layers.{m[1]}.{m[2]}."
                           + ("0" if m[3] == "conv" else "1")))]
    if any(any(re.fullmatch(r"conv2_\d+(_offset|_kernel)?", k) for k in b)
           or "fc1" in b.get("conv2", {}) for b in blocks):
        # Res2Net's or ResNeSt's avg-down shortcut, Res2Net's scale convs
        rules += [(_BLOCK + r"\.downsample_conv$",
                   lambda m, n: f"{m[1]}.downsample.1"),
                  (_BLOCK + r"\.downsample_bn$",
                   lambda m, n: f"{m[1]}.downsample.2"),
                  (_BLOCK + r"\.conv2_(\d+)$", lambda m, n: f"{m[1]}.convs.{m[2]}"),
                  (_BLOCK + r"\.bn2_(\d+)$", lambda m, n: f"{m[1]}.bns.{m[2]}")]
    if any("depthwise_conv" in b for b in blocks):
        rules += [(r"^backbone\.conv1$", lambda m, n: "backbone.conv1.conv"),
                  (r"^backbone\.bn1$", lambda m, n: "backbone.conv1.bn"),
                  (_BLOCK + r"\.(expand|depthwise)_(conv|bn)$",
                   lambda m, n: f"{m[1]}.{m[2]}_conv.{m[3]}"),
                  (_BLOCK + r"\.project_(conv|bn)$",
                   lambda m, n: f"{m[1]}.linear_conv.{m[2]}")]
    if "reduction_conv" in params.get("neck", {}):
        rules.append((r"^neck\.reduction_conv$",
                      lambda m, n: "neck.reduction_conv.conv"))
    return rules


def _plugin_rules(params: dict) -> list:
    """A bottleneck's ``plugin{k}`` (flax) -> mmcv's abbreviation, told by
    its parts (a ContextBlock's ``conv_mask`` or transforms), and a
    ContextBlock's transform convs and LayerNorm."""
    abbr = {}
    for name, block in params.get("backbone", {}).items():
        for k, part in block.items() if isinstance(block, dict) else ():
            if re.fullmatch(r"plugin\d+", k):
                context = any(c == "conv_mask" or c.startswith("channel_")
                              for c in part)
                abbr[(name, k)] = ("context_block" if context
                                   else "gen_attention_block")
    if not abbr:
        return []
    return [(r"^backbone\.(layer\d+_\d+)\.(plugin\d+)\b",
             lambda m, n: f"backbone.{m[1]}.{abbr[(m[1], m[2])]}"),
            (r"\.(channel_(?:add|mul))_conv1$", lambda m, n: f".{m[1]}_conv.0"),
            (r"\.(channel_(?:add|mul))_ln$", lambda m, n: f".{m[1]}_conv.1"),
            (r"\.(channel_(?:add|mul))_conv2$", lambda m, n: f".{m[1]}_conv.3")]


def _plugins_to_flax(state_dict: dict) -> list:
    """:func:`_plugin_rules` back: each block's plugins numbered in their
    order in the state dict (the module's, which is the config's)."""
    index: dict = {}
    for key in state_dict:
        m = re.match(r"^(backbone\.layer\d+\.\d+)\."
                     r"((?:context_block|gen_attention_block)\w*)\.", key)
        if m and (m[1], m[2]) not in index:
            index[(m[1], m[2])] = sum(1 for b, _ in index if b == m[1])
    if not index:
        return []
    return [(r"^(backbone\.layer\d+\.\d+)\."
             r"((?:context_block|gen_attention_block)\w*)\b",
             lambda m, n: f"{m[1]}.plugin{index[(m[1], m[2])]}"),
            (r"\.(channel_(?:add|mul))_conv\.0$", lambda m, n: f".{m[1]}_conv1"),
            (r"\.(channel_(?:add|mul))_conv\.1$", lambda m, n: f".{m[1]}_ln"),
            (r"\.(channel_(?:add|mul))_conv\.3$", lambda m, n: f".{m[1]}_conv2")]


def _neck_to_torch(params: dict) -> list:
    """The renames of a list neck, BFP, PAFPN and FPN_CARAFE (flax ->
    port), applied before the FPN rules."""
    neck = params.get("neck", {})
    parts = [neck] + [v for k, v in neck.items() if re.fullmatch(r"necks_\d+", k)]
    rules = [(r"^neck\.necks_(\d+)\b", lambda m, n: f"neck.{m[1]}")]
    if any("refine" in p for p in parts):
        rules.append((r"^neck\.((?:\d+\.)?)refine$",
                      lambda m, n: f"neck.{m[1]}refine.conv"))
    if "pafpn_conv1" in neck:
        rules += [(r"^neck\.downsample_conv(\d+)$",
                   lambda m, n: f"neck.downsample_convs.{m[1]}.conv"),
                  (r"^neck\.pafpn_conv(\d+)$",
                   lambda m, n: f"neck.pafpn_convs.{int(m[1]) - 1}.conv")]
    if "up1" in neck:
        rules += [(r"^neck\.lateral(\d+)$",
                   lambda m, n: f"neck.lateral_convs.{m[1]}.conv"),
                  (r"^neck\.up(\d+)\b",
                   lambda m, n: f"neck.upsample_modules.{int(m[1]) - 1}")]
    return rules


def _neck_to_flax(state_dict: dict) -> list:
    """:func:`_neck_to_torch`'s renames back, applied before the FPN
    rules."""
    keys = list(state_dict)
    rules = [(r"^neck\.(\d+)\.", lambda m, n: f"neck.necks_{m[1]}.")]
    if any(re.match(r"^neck\.(\d+\.)?refine\.conv\.", k) for k in keys):
        rules.append((r"^neck\.((?:necks_\d+\.)?)refine\.conv$",
                      lambda m, n: f"neck.{m[1]}refine"))
    if any(k.startswith("neck.pafpn_convs.") for k in keys):
        rules += [(r"^neck\.downsample_convs\.(\d+)\.conv$",
                   lambda m, n: f"neck.downsample_conv{m[1]}"),
                  (r"^neck\.pafpn_convs\.(\d+)\.conv$",
                   lambda m, n: f"neck.pafpn_conv{int(m[1]) + 1}")]
    if any(k.startswith("neck.upsample_modules.") for k in keys):
        rules += [(r"^neck\.lateral_convs\.(\d+)\.conv$",
                   lambda m, n: f"neck.lateral{m[1]}"),
                  (r"^neck\.upsample_modules\.(\d+)\b",
                   lambda m, n: f"neck.up{int(m[1]) + 1}")]
    return rules


def _heads_to_torch(params: dict) -> list:
    """The renames of NASFCOSHead's and RetinaSepBNHead's towers (flax ->
    port), applied before the FCOS / RetinaNet rules."""
    head = params.get("bbox_head", {})
    rules = []
    if "cls_op0" in head:
        rules += [(r"^bbox_head\.(cls|reg)_op(\d+)$",
                   lambda m, n: f"bbox_head.{m[1]}_convs.{m[2]}.conv"),
                  (r"^bbox_head\.(cls|reg)_op(\d+)\.(conv|gn)$",
                   lambda m, n: f"bbox_head.{m[1]}_convs.{m[2]}.{m[3]}")]
    if "cls_bn_l0_s0" in head:
        rules.append((r"^bbox_head\.(cls|reg)_bn_l(\d+)_s(\d+)$",
                      lambda m, n: f"bbox_head.{m[1]}_convs.{m[2]}.{m[3]}.bn"))
    return rules


def _heads_to_flax(state_dict: dict) -> list:
    """:func:`_heads_to_torch`'s renames back."""
    rules = []
    if NASFCOS_OFFSETS <= set(state_dict):
        rules.append((r"^bbox_head\.(cls|reg)_convs\.(\d+)\.(conv|gn)\b",
                      lambda m, n: f"bbox_head.{m[1]}_op{m[2]}.{m[3]}"))
    if "bbox_head.cls_convs.0.0.bn.weight" in state_dict:
        rules += [(r"^bbox_head\.(cls|reg)_convs\.(\d+)\.(\d+)\.bn$",
                   lambda m, n: f"bbox_head.{m[1]}_bn_l{m[2]}_s{m[3]}"),
                  (r"^bbox_head\.(cls|reg)_convs\.\d+\.(\d+)\.conv$",
                   lambda m, n: f"bbox_head.{m[1]}_conv{m[2]}")]
    return rules


# FPN_CARAFE's content encoders, whose output channels are tap-major here
# and sub-pixel-major in the JAX package
CARAFE_ENCODER = re.compile(r"^neck\.upsample_modules\.\d+\.content_encoder$")
# a ContextBlock's LayerNorm, whose affine parameters are (planes, 1, 1)
CONTEXT_LN = re.compile(r"\.context_block\w*\.channel_(add|mul)_conv\.1$")
# RetinaSepBNHead's tied tower convs, one per (level, conv) here
SEPBN_CONV = re.compile(r"^bbox_head\.(cls|reg)_convs\.(\d+)\.(\d+)\.conv\.weight$")
# NASFCOSHead's deformable ops (FCOS's dcn_on_last_conv has one, the last)
NASFCOS_OFFSETS = {"bbox_head.cls_convs.0.conv.conv_offset.weight",
                   "bbox_head.cls_convs.2.conv.conv_offset.weight"}
# GeneralizedAttention's parameters whose names end in _bias (not a
# deformable conv's bias)
ATTENTION_BIASES = ("key_content_bias", "geom_bias")


def _carafe_order(n_out: int, scale: int = 2) -> np.ndarray:
    """The JAX package's content-encoder channel of each of mmcv's: mmcv's
    channel t * scale**2 + q is the JAX package's q * k*k + t (q the
    sub-pixel, t the tap)."""
    s2 = scale * scale
    return np.arange(n_out).reshape(s2, n_out // s2).T.reshape(-1)


def _backbone_to_flax(state_dict: dict) -> list:
    """:func:`_backbone_to_torch`'s renames back (port -> flax), applied
    before the ResNet rules."""
    keys = list(state_dict)
    rules = []
    if any(k.startswith("backbone.stage2.0.") for k in keys):
        rules += [
            (r"^backbone\.transition(\d+)\.(\d+)\.(?:0\.)?([01])$",
             lambda m, n: (f"backbone.transition{int(m[1]) - 1}_{m[2]}_"
                           + ("conv" if m[3] == "0" else "bn"))),
            (r"^backbone\.(stage\d)\.(\d+)\b",
             lambda m, n: f"backbone.{m[1]}_module{m[2]}"),
            (r"\bbranches\.(\d+)\.(\d+)\b",
             lambda m, n: f"branch{m[1]}_block{m[2]}"),
            (r"\bfuse_layers\.(\d+)\.(\d+)\.(\d+)\.([01])$",
             lambda m, n: (f"fuse{m[1]}_{m[2]}_ds{m[3]}_"
                           + ("conv" if m[4] == "0" else "bn"))),
            (r"\bfuse_layers\.(\d+)\.(\d+)\.([01])$",
             lambda m, n: (f"fuse{m[1]}_{m[2]}_"
                           + ("conv" if m[3] == "0" else "bn")))]
    if any(re.match(_TBLOCK + r"\.downsample\.2\.", k) for k in keys):
        rules += [(_TBLOCK + r"\.downsample\.1$",
                   lambda m, n: f"{m[1]}.downsample_conv"),
                  (_TBLOCK + r"\.downsample\.2$",
                   lambda m, n: f"{m[1]}.downsample_bn"),
                  (_TBLOCK + r"\.convs\.(\d+)$", lambda m, n: f"{m[1]}.conv2_{m[2]}"),
                  (_TBLOCK + r"\.bns\.(\d+)$", lambda m, n: f"{m[1]}.bn2_{m[2]}")]
    if any(".depthwise_conv." in k for k in keys):
        rules += [(r"^backbone\.conv1\.conv$", lambda m, n: "backbone.conv1"),
                  (r"^backbone\.conv1\.bn$", lambda m, n: "backbone.bn1"),
                  (_TBLOCK + r"\.(expand|depthwise)_conv\.(conv|bn)$",
                   lambda m, n: f"{m[1]}.{m[2]}_{m[3]}"),
                  (_TBLOCK + r"\.linear_conv\.(conv|bn)$",
                   lambda m, n: f"{m[1]}.project_{m[2]}")]
    if "neck.reduction_conv.conv.weight" in state_dict:
        rules += [(r"^neck\.reduction_conv\.conv$",
                   lambda m, n: "neck.reduction_conv"),
                  (r"^neck\.fpn_convs\.(\d+)\.conv$",
                   lambda m, n: f"neck.fpn_conv{m[1]}")]
    return rules


# DetectoRS: the backbones' stems and blocks, the RFP neck's parts
_DETECTORS_TO_TORCH = [
    (r"^neck\.fpn\.", lambda m, n: "neck."),
    (r"^neck\.rfp_modules_(\d+)\.", lambda m, n: f"neck.rfp_modules.{m[1]}."),
    (r"^neck\.rfp_aspp\.aspp(\d+)\b", lambda m, n: f"neck.rfp_aspp.aspp.{m[1]}"),
    (r"^(backbone|neck\.rfp_modules\.\d+)\.stem_conv\b",
     lambda m, n: f"{m[1]}.conv1"),
    (r"^(backbone|neck\.rfp_modules\.\d+)\.stem_bn\b",
     lambda m, n: f"{m[1]}.bn1"),
    (r"^(backbone|neck\.rfp_modules\.\d+)\.stages_(\d+)_(\d+)\b",
     lambda m, n: f"{m[1]}.layer{int(m[2]) + 1}.{m[3]}"),
]
# the same back: the backbone's where it is DetectoRS's, the neck's where
# it is the RFP
_DETECTORS_BACKBONE_TO_FLAX = [
    (r"^backbone\.conv1\b", lambda m, n: "backbone.stem_conv"),
    (r"^backbone\.bn1\b", lambda m, n: "backbone.stem_bn"),
    (r"^backbone\.layer(\d+)\.(\d+)\b",
     lambda m, n: f"backbone.stages_{int(m[1]) - 1}_{m[2]}"),
]
_RFP_TO_FLAX = [
    (r"^neck\.rfp_aspp\.aspp\.(\d+)\b", lambda m, n: f"neck.rfp_aspp.aspp{m[1]}"),
    (r"^neck\.(lateral_convs|fpn_convs)\.", lambda m, n: f"neck.fpn.{m[1]}."),
    (r"^neck\.rfp_modules\.(\d+)\.conv1\b",
     lambda m, n: f"neck.rfp_modules_{m[1]}.stem_conv"),
    (r"^neck\.rfp_modules\.(\d+)\.bn1\b",
     lambda m, n: f"neck.rfp_modules_{m[1]}.stem_bn"),
    (r"^neck\.rfp_modules\.(\d+)\.layer(\d+)\.(\d+)\b",
     lambda m, n: f"neck.rfp_modules_{m[1]}.stages_{int(m[2]) - 1}_{m[3]}"),
]

_TO_FLAX = [
    (r"\b(necks|bbox_heads)\.(\d+)\b", lambda m, n: f"{m[1]}_{m[2]}"),
    (r"\bstages\.(\d+)\.(\d+)\b", lambda m, n: f"layer{int(m[1]) + 1}_{m[2]}"),
    (r"\blayer(\d+)\.(\d+)\b", lambda m, n: f"layer{m[1]}_{m[2]}"),
    (r"\bdownsample\.0\b", lambda m, n: "downsample_conv"),
    (r"\bdownsample\.1\b", lambda m, n: "downsample_bn"),
    (r"\bconv_outs\.(\d+)\b", lambda m, n: f"conv_out{m[1]}"),
    (r"\brecurrent_convs\.(\d+)\b", lambda m, n: f"recurrent_conv{m[1]}"),
    (r"\bstage_bns\.(\d+)\.(\d+)\b", lambda m, n: f"stage_bn{m[1]}_{m[2]}"),
    (r"\blateral_convs\.(\d+)\.conv\b", lambda m, n: f"lateral_conv{m[1]}"),
    (r"\bfpn_convs\.(\d+)\.conv\b",
     lambda m, n: (f"fpn_conv{m[1]}" if int(m[1]) < n
                   else f"extra_conv{int(m[1]) - n}")),
    (r"\b(cls|reg)_convs\.(\d+)\.conv\b", lambda m, n: f"{m[1]}_conv{m[2]}"),
    (r"\b(cls|reg)_convs\.(\d+)\.gn\b", lambda m, n: f"{m[1]}_gn{m[2]}"),
    (r"\bscales\.(\d+)\b", lambda m, n: f"scale{m[1]}"),
    (r"\bshared_fcs\.(\d+)\b", lambda m, n: f"shared_fc{m[1]}"),
    (r"\bshared_convs\.(\d+)\.conv\b", lambda m, n: f"shared_conv{m[1]}"),
    (r"\bshared_convs\.(\d+)\.gn\b", lambda m, n: f"shared_norm{m[1]}"),
    (r"\bstem\.(\d+)\b",
     lambda m, n: (f"stem_conv{int(m[1]) // 3}" if int(m[1]) % 3 == 0
                   else f"stem_bn{int(m[1]) // 3}")),
    (r"\blateral_convs\.(\d+)\.gn\b", lambda m, n: f"lateral_norm{m[1]}"),
    (r"\bfpn_convs\.(\d+)\.gn\b",
     lambda m, n: (f"fpn_norm{m[1]}" if int(m[1]) < n
                   else f"extra_norm{int(m[1]) - n}")),
    (r"^roi_head\.bbox_head\b", lambda m, n: "bbox_head"),
    (r"^bbox_head\.vfnet_reg_conv\.conv$", lambda m, n: "bbox_head.vfnet_reg_conv"),
    (r"^bbox_head\.vfnet_reg_conv\.gn$", lambda m, n: "bbox_head.vfnet_reg_conv_gn"),
    (r"^bbox_head\.vfnet_(reg_refine|cls)_dconv$",
     lambda m, n: f"bbox_head.{m[1]}_dconv"),
    (r"\bscales_refine\.(\d+)\b", lambda m, n: f"scale_refine{m[1]}"),
    (r"^roi_head\.roi_pool_pack\.(offset|mask)_fc\.(\d)$",
     lambda m, n: f"roi_pool_pack.{m[1]}_fc{int(m[2]) // 2}"),
]

# the FCs that read RoI features flattened: a RoI head's (a cascade
# stage's) first shared FC and the mask IoU head's first FC
ROI_FC = re.compile(r"^roi_head\.(bbox_head(\.\d+)?\.shared_fcs|"
                    r"mask_iou_head\.fcs)\.0$")
# the mask heads' transposed convs (a Mask R-CNN's, each HTC stage's)
MASK_UPSAMPLE = re.compile(r"^roi_head\.mask_head(\.\d+)?\.upsample$")
# SCNet's relay FC, whose output rows are a (c, s, s) map in the port
RELAY_FC = "roi_head.feat_relay_head.fc"
# PointRend's coarse mask head: its first FC reads (c, h, w), its logits are
# (classes, h, w) in the port
COARSE_FC0 = "roi_head.mask_head.fcs.0"
COARSE_LOGITS = "roi_head.mask_head.fc_logits"
# PointRend's point head: mmdet's Conv1d weights (out, in, 1)
POINT_FC = re.compile(r"^roi_head\.point_head\.(fcs\.\d+\.conv|fc_logits)$")
# the deformable RoI pooling pack's FCs: the first of each branch reads RoI
# features flattened, offset_fc's last writes the bins' (dx, dy)
PACK_IN_FC = re.compile(r"^roi_head\.roi_pool_pack\.(offset|mask)_fc\.0$")
PACK_OFFSET_FC = "roi_head.roi_pool_pack.offset_fc.4"
_ROI_PARTS_TO_FLAX = [
    (r"^roi_head\.bbox_head\.(\d+)\b", lambda m, n: f"bbox_heads_{m[1]}"),
    (r"^roi_head\.mask_head\.(\d+)\.convs\.(\d+)\.conv\b",
     lambda m, n: f"mask_heads_{m[1]}.conv{m[2]}"),
    (r"^roi_head\.mask_head\.(\d+)\.conv_res\.conv\b",
     lambda m, n: f"mask_heads_{m[1]}.conv_res"),
    (r"^roi_head\.mask_head\.(\d+)\b", lambda m, n: f"mask_heads_{m[1]}"),
    (r"^roi_head\.mask_head\.downsample_conv\.conv\b",
     lambda m, n: "mask_head.downsample_conv"),
    (r"^roi_head\.mask_head\.fcs\.(\d+)\b", lambda m, n: f"mask_head.fc{m[1]}"),
    (r"^roi_head\.point_head\.fcs\.(\d+)\.conv\b",
     lambda m, n: f"point_head.fc{m[1]}"),
    (r"^roi_head\.point_head\b", lambda m, n: "point_head"),
    (r"^bbox_head\.head_convs\.(\d+)\.conv\b",
     lambda m, n: f"bbox_head.head_conv{m[1]}"),
    (r"^roi_head\.mask_head\.convs\.(\d+)\.conv\b",
     lambda m, n: f"mask_head.conv{m[1]}"),
    (r"^roi_head\.mask_head\.convs\.(\d+)\b",
     lambda m, n: f"mask_head.res{m[1]}"),
    (r"^roi_head\.mask_head\b", lambda m, n: "mask_head"),
    (r"^roi_head\.semantic_head\.lateral_convs\.(\d+)\.conv\b",
     lambda m, n: f"semantic_head.lateral{m[1]}"),
    (r"^roi_head\.semantic_head\.convs\.(\d+)\.conv\b",
     lambda m, n: f"semantic_head.conv{m[1]}"),
    (r"^roi_head\.semantic_head\.conv_embedding\.conv\b",
     lambda m, n: "semantic_head.conv_embedding"),
    (r"^roi_head\.semantic_head\b", lambda m, n: "semantic_head"),
    (r"^roi_head\.glbctx_head\.convs\.(\d+)\.conv\b",
     lambda m, n: f"glbctx_head.conv{m[1]}"),
    (r"^roi_head\.glbctx_head\.convs\.(\d+)\b",
     lambda m, n: f"glbctx_head.res{m[1]}"),
    (r"^roi_head\.glbctx_head\b", lambda m, n: "glbctx_head"),
    (r"^roi_head\.feat_relay_head\b", lambda m, n: "relay_head"),
    (r"^roi_head\.mask_iou_head\.convs\.(\d+)\.conv\b",
     lambda m, n: f"mask_iou_head.conv{m[1]}"),
    (r"^roi_head\.mask_iou_head\.fcs\.(\d+)\b",
     lambda m, n: f"mask_iou_head.fc{m[1]}"),
    (r"^roi_head\.mask_iou_head\b", lambda m, n: "mask_iou_head"),
    (r"^roi_head\.shared_head\.layer\d+\.(\d+)\b",
     lambda m, n: f"shared_head.block{m[1]}"),
]


def _roi_parts_to_torch(params: dict) -> list:
    """The renames of a two-stage detector's top-level RoI parts."""
    rules = []
    if "fc_cls" in params.get("bbox_head", {}):
        # a two-stage or Fast R-CNN detector's RoI head
        rules.append((r"^bbox_head\b", lambda m, n: "roi_head.bbox_head"))
    if "rpn_head" in params:
        # a cascade's stages (a multi-head detector's bbox_heads_{i} have
        # no RPN beside them)
        rules.append((r"^bbox_heads_(\d+)\b",
                      lambda m, n: f"roi_head.bbox_head.{m[1]}"))
    if "point_head" in params:
        rules += [(r"^point_head\.fc(\d+)\b",
                   lambda m, n: f"roi_head.point_head.fcs.{m[1]}.conv"),
                  (r"^point_head\b", lambda m, n: "roi_head.point_head")]
    if "proto_head" in params:
        n_proto = sum(1 for k in params["proto_head"]
                      if k.startswith("proto_conv"))
        rules += [(r"^proto_head\.proto_conv(\d+)\b",
                   lambda m, n: f"mask_head.protonet.{2 * int(m[1])}"),
                  (r"^proto_head\.post_up_conv\b",
                   lambda m, n: f"mask_head.protonet.{2 * n_proto + 2}"),
                  (r"^proto_head\.proto_out\b",
                   lambda m, n: f"mask_head.protonet.{2 * n_proto + 4}")]
    if "head_conv0" in params.get("bbox_head", {}):
        rules.append((r"^bbox_head\.head_conv(\d+)\b",
                      lambda m, n: f"bbox_head.head_convs.{m[1]}.conv"))
    if "mask_head" in params:
        rules += [(r"^mask_head\.downsample_conv\b",
                   lambda m, n: "roi_head.mask_head.downsample_conv.conv"),
                  (r"^mask_head\.fc(\d+)\b",
                   lambda m, n: f"roi_head.mask_head.fcs.{m[1]}"),
                  (r"^mask_head\.conv(\d+)\b",
                   lambda m, n: f"roi_head.mask_head.convs.{m[1]}.conv"),
                  (r"^mask_head\.res(\d+)\b",
                   lambda m, n: f"roi_head.mask_head.convs.{m[1]}"),
                  (r"^mask_head\b", lambda m, n: "roi_head.mask_head")]
    if "mask_heads_0" in params:
        rules += [(r"^mask_heads_(\d+)\.conv(\d+)\b",
                   lambda m, n: f"roi_head.mask_head.{m[1]}.convs.{m[2]}.conv"),
                  (r"^mask_heads_(\d+)\.conv_res\b",
                   lambda m, n: f"roi_head.mask_head.{m[1]}.conv_res.conv"),
                  (r"^mask_heads_(\d+)\b",
                   lambda m, n: f"roi_head.mask_head.{m[1]}")]
    if "semantic_head" in params:
        rules += [(r"^semantic_head\.lateral(\d+)\b", lambda m, n:
                   f"roi_head.semantic_head.lateral_convs.{m[1]}.conv"),
                  (r"^semantic_head\.conv(\d+)\b",
                   lambda m, n: f"roi_head.semantic_head.convs.{m[1]}.conv"),
                  (r"^semantic_head\.conv_embedding\b",
                   lambda m, n: "roi_head.semantic_head.conv_embedding.conv"),
                  (r"^semantic_head\b", lambda m, n: "roi_head.semantic_head")]
    if "glbctx_head" in params:
        rules += [(r"^glbctx_head\.res(\d+)\b",
                   lambda m, n: f"roi_head.glbctx_head.convs.{m[1]}"),
                  (r"^glbctx_head\.conv(\d+)\b",
                   lambda m, n: f"roi_head.glbctx_head.convs.{m[1]}.conv"),
                  (r"^glbctx_head\b", lambda m, n: "roi_head.glbctx_head")]
    if "relay_head" in params:
        rules.append((r"^relay_head\b", lambda m, n: "roi_head.feat_relay_head"))
    if "mask_iou_head" in params:
        rules += [(r"^mask_iou_head\.conv(\d+)\b",
                   lambda m, n: f"roi_head.mask_iou_head.convs.{m[1]}.conv"),
                  (r"^mask_iou_head\.fc(\d+)\b",
                   lambda m, n: f"roi_head.mask_iou_head.fcs.{m[1]}"),
                  (r"^mask_iou_head\b", lambda m, n: "roi_head.mask_iou_head")]
    if "shared_head" in params:
        width = np.asarray(params["shared_head"]["block0"]["conv1"]["kernel"]
                           ).shape[-1]
        layer = int(np.log2(width // 64)) + 1
        rules.append((r"^shared_head\.block(\d+)\b",
                      lambda m, n: f"roi_head.shared_head.layer{layer}.{m[1]}"))
    return rules


def _roi_rows(n_in: int, channels: int, to_chw: bool) -> np.ndarray:
    """The permutation of a RoI FC's (``ROI_FC``) n_in = channels * s * s
    input rows from the JAX package's (h, w, c) order to the port's
    (c, h, w) (or back)."""
    s = int(round((n_in // channels) ** 0.5))
    if channels * s * s != n_in:
        raise ValueError(f"a RoI FC has {n_in} inputs, not {channels} "
                         f"channels times a square RoI")
    hwc = np.arange(n_in).reshape(s, s, channels)
    chw = hwc.transpose(2, 0, 1).reshape(-1)
    return chw if to_chw else np.argsort(chw)


def _rename(path: str, rules, n_lat: int) -> str:
    for pattern, repl in rules:
        path = re.sub(pattern, lambda m: repl(m, n_lat), path)
    return path


def _leaves(tree: dict, prefix: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def flax_to_state_dict(variables: dict) -> dict[str, torch.Tensor]:
    """flax ``{"params", "batch_stats"}`` tree of arrays -> port state_dict."""
    params = variables["params"]
    neck = params.get("neck", params.get("necks_0", {}))
    neck = neck.get("fpn", neck.get("necks_0", neck))
    n_lat = sum(1 for k in neck if k.startswith("lateral_conv"))
    rla = "conv_out0" in params.get("backbone", {})
    rules = (_roi_parts_to_torch(params) + _backbone_to_torch(params)
             + _plugin_rules(params) + _neck_to_torch(params)
             + _heads_to_torch(params) + _DETECTORS_TO_TORCH
             + (_TO_TORCH if rla else _RESNET_TO_TORCH + _TO_TORCH))
    sd: dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, arr in _leaves(variables.get(collection, {})):
            mod_path, leaf, suffix = path[:-1], path[-1], ""
            dcn = (re.fullmatch(r"(\w+)_(kernel|bias)", leaf)
                   if leaf not in ATTENTION_BIASES else None)
            if dcn:
                # a deformable conv's own kernel or bias, a leaf of its parent
                mod_path, leaf = mod_path + (dcn[1],), dcn[2]
            elif mod_path and mod_path[-1].endswith("_offset"):
                mod_path = mod_path[:-1] + (mod_path[-1][:-len("_offset")],)
                suffix = ".conv_offset"
            module = _rename(".".join(mod_path), rules, n_lat) + suffix
            arr = np.asarray(arr)
            if collection == "batch_stats":
                name = {"mean": "running_mean", "var": "running_var"}[leaf]
            elif leaf == "kernel" and arr.ndim == 2:
                name = "weight"
                if ROI_FC.match(module):
                    arr = arr[_roi_rows(arr.shape[0],
                                        _roi_channels(params, path),
                                        to_chw=True)]
                if module == RELAY_FC:
                    arr = arr[:, _roi_rows(arr.shape[1],
                                           _roi_channels(params, path),
                                           to_chw=True)]
                if module == COARSE_FC0:
                    arr = arr[_roi_rows(arr.shape[0], _coarse_dims(params)[0],
                                        to_chw=True)]
                if module == COARSE_LOGITS:
                    arr = arr[:, _roi_rows(arr.shape[1],
                                           _coarse_dims(params)[1],
                                           to_chw=True)]
                if PACK_IN_FC.match(module):
                    arr = arr[_roi_rows(arr.shape[0], _pack_channels(params),
                                        to_chw=True)]
                if module == PACK_OFFSET_FC:
                    arr = arr[:, _roi_rows(arr.shape[1], 2, to_chw=True)]
                arr = arr.T
                if POINT_FC.match(module):
                    arr = arr[:, :, None]
                if SA_FC.match(module):
                    arr = arr[:, :, None, None]
            elif CONTEXT_LN.search(module):
                name = "weight" if leaf == "scale" else leaf
                arr = arr.reshape(-1, 1, 1)
            elif CARAFE_ENCODER.match(module):
                name = "weight" if leaf == "kernel" else leaf
                arr = arr[..., _carafe_order(arr.shape[-1])]
                if leaf == "kernel":
                    arr = np.transpose(arr, (3, 2, 0, 1))
            elif leaf == "bias" and module == PACK_OFFSET_FC:
                name = leaf
                arr = arr[_roi_rows(arr.shape[0], 2, to_chw=True)]
            elif leaf == "bias" and module in (RELAY_FC, COARSE_LOGITS):
                name = leaf
                arr = arr[_roi_rows(
                    arr.shape[0], _coarse_dims(params)[1]
                    if module == COARSE_LOGITS else _roi_channels(params, path),
                    to_chw=True)]
            elif leaf in ("weight", "weight_diff") and arr.ndim == 4:
                name = leaf                       # a SAC's kernels
                arr = np.transpose(arr, (3, 2, 0, 1))
            elif leaf == "kernel" and MASK_UPSAMPLE.match(module):
                name = "weight"
                arr = np.transpose(arr, (2, 3, 0, 1))[:, :, ::-1, ::-1]
            elif leaf == "kernel":
                name = "weight"
                arr = np.transpose(arr, (3, 2, 0, 1))
            elif leaf == "scale":
                name = ("scale" if re.search(r"\bscales(_refine)?\.\d+$", module)
                        else "weight")
            else:
                name = leaf
            # np.array, not ascontiguousarray, which makes 0-d arrays 1-d
            sd[f"{module}.{name}"] = torch.from_numpy(np.array(arr, np.float32))
    if "cls_bn_l0_s0" in params.get("bbox_head", {}):
        # RetinaSepBNHead: its one kernel per tower conv under every level
        levels = sum(1 for k in params["bbox_head"]
                     if re.fullmatch(r"cls_bn_l\d+_s0", k))
        for key in [k for k in sd
                    if re.fullmatch(r"bbox_head\.(cls|reg)_convs\.\d+\.conv\.weight", k)]:
            kind, i = key.split(".")[1], key.split(".")[2]
            w = sd.pop(key)
            for lvl in range(levels):
                sd[f"bbox_head.{kind}.{lvl}.{i}.conv.weight"] = w
    return sd


def _roi_channels(params: dict, path: tuple) -> int:
    """The channels of the features the RoI FC at ``path`` (flax names)
    reads: the mask IoU head's last conv's; the last shared conv's where
    the bbox head has convs, else the RoI features' (the FPN's output
    width, or the single level's, which the RPN reads)."""
    head = params[path[0]]
    if path[0] == "mask_iou_head":
        last = max(int(k[4:]) for k in head if k.startswith("conv"))
        return int(np.asarray(head[f"conv{last}"]["kernel"]).shape[-1])
    if "shared_conv3" in head:
        return int(np.asarray(head["shared_conv3"]["kernel"]).shape[-1])
    neck = params.get("neck", {})
    neck = neck.get("fpn", neck)
    if "fpn_conv0" in neck:
        return int(np.asarray(neck["fpn_conv0"]["kernel"]).shape[-1])
    return int(np.asarray(params["rpn_head"]["rpn_conv"]["kernel"]).shape[-2])


def _pack_channels(params: dict) -> int:
    """The channels of the RoI features the deformable RoI pooling pack
    reads (flax names): its first FC's inputs over the bins, which its
    ``offset_fc2`` counts twice."""
    pk = params["roi_pool_pack"]
    cells = np.asarray(pk["offset_fc2"]["kernel"]).shape[1] // 2
    return int(np.asarray(pk["offset_fc0"]["kernel"]).shape[0] // cells)


def _coarse_dims(params: dict) -> tuple[int, int]:
    """PointRend's coarse mask head (flax names): (the channels its
    ``fc0`` reads per cell, its classes)."""
    mh = params["mask_head"]
    convs = sorted(int(k[4:]) for k in mh if re.fullmatch(r"conv\d+", k))
    if "downsample_conv" in mh:
        ch = np.asarray(mh["downsample_conv"]["kernel"]).shape[-1]
    elif convs:
        ch = np.asarray(mh[f"conv{convs[-1]}"]["kernel"]).shape[-1]
    else:
        ch = _roi_channels(params, ("mask_head", "fc0", "kernel"))
    cells = np.asarray(mh["fc0"]["kernel"]).shape[0] // ch
    return int(ch), int(np.asarray(mh["fc_logits"]["kernel"]).shape[1]
                        // cells)


def _coarse_dims_torch(state_dict: dict) -> tuple[int, int]:
    """:func:`_coarse_dims` on the port's names."""
    head = "roi_head.mask_head"
    convs = [k for k in state_dict
             if re.match(rf"^{head}\.convs\.\d+\.conv\.weight$", k)]
    if f"{head}.downsample_conv.conv.weight" in state_dict:
        ch = state_dict[f"{head}.downsample_conv.conv.weight"].shape[0]
    elif convs:
        ch = state_dict[max(convs, key=lambda k: int(k.split(".")[3]))
                        ].shape[0]
    else:
        ch = _roi_channels_torch(state_dict, f"{head}.fcs.0")
    cells = state_dict[f"{COARSE_FC0}.weight"].shape[1] // ch
    return int(ch), int(state_dict[f"{COARSE_LOGITS}.weight"].shape[0]
                        // cells)


def _pack_channels_torch(state_dict: dict) -> int:
    """:func:`_pack_channels` on the port's names."""
    cells = state_dict[f"{PACK_OFFSET_FC}.weight"].shape[0] // 2
    return int(state_dict["roi_head.roi_pool_pack.offset_fc.0.weight"].shape[1]
               // cells)


def _roi_channels_torch(state_dict: dict, module: str) -> int:
    """:func:`_roi_channels` on the port's names, for the RoI FC
    ``module``."""
    head = module.rsplit(".", 2)[0]
    if head == "roi_head.mask_iou_head":
        convs = [k for k in state_dict
                 if re.match(rf"^{head}\.convs\.\d+\.conv\.weight$", k)]
        last = max(convs, key=lambda k: int(k.split(".")[3]))
        return int(state_dict[last].shape[0])
    for key, dim in ((f"{head}.shared_convs.3.conv.weight", 0),
                     ("neck.fpn_convs.0.conv.weight", 0),
                     ("rpn_head.rpn_conv.weight", 1)):
        if key in state_dict:
            return int(state_dict[key].shape[dim])
    raise KeyError("no layer gives the RoI head's input channels")


def state_dict_to_flax(state_dict: dict) -> dict:
    """Port state_dict -> flax ``{"params", "batch_stats"}`` tree of numpy
    arrays (the inverse of :func:`flax_to_state_dict`)."""
    n_lat = len({m[1] for k in state_dict
                 if (m := re.match(r"necks?(?:\.0)?\.lateral_convs\.(\d+)\.", k))})
    detectors = any(re.match(r"^backbone\..*\.(weight_diff|rfp_conv\.)", k)
                    for k in state_dict)
    rfp = "neck.rfp_weight.weight" in state_dict
    protonet = sorted({int(m[1]) for k in state_dict
                       if (m := re.match(r"^mask_head\.protonet\.(\d+)\.", k))})
    proto_names = {i: f"proto_conv{j}" for j, i in enumerate(protonet[:-2])}
    proto_names.update(zip(protonet[-2:], ("post_up_conv", "proto_out")))
    rules = (_ROI_PARTS_TO_FLAX
             + [(r"^mask_head\.protonet\.(\d+)\b",
                 lambda m, n: f"proto_head.{proto_names[int(m[1])]}")]
             + (_DETECTORS_BACKBONE_TO_FLAX if detectors else [])
             + (_RFP_TO_FLAX if rfp else []) + _backbone_to_flax(state_dict)
             + _plugins_to_flax(state_dict) + _neck_to_flax(state_dict)
             + _heads_to_flax(state_dict) + _TO_FLAX)
    out: dict = {"params": {}, "batch_stats": {}}
    # the port's deformable convs: an mmcv pack (with its conv_offset) or
    # VFNet's star convs
    deform = {k[:-len(".conv_offset.weight")] for k in state_dict
              if k.endswith(".conv_offset.weight")}
    deform |= {m for m in ("bbox_head.vfnet_reg_refine_dconv",
                           "bbox_head.vfnet_cls_dconv")
               if f"{m}.weight" in state_dict}
    nasfcos = NASFCOS_OFFSETS <= set(state_dict)
    for key, value in state_dict.items():
        module, name = key.rsplit(".", 1)
        if name == "num_batches_tracked":
            continue
        sepbn = SEPBN_CONV.match(key)
        if sepbn and sepbn[2] != "0":
            continue                  # a tied kernel: level 0's is the one
        arr = value.detach().cpu().numpy()
        collection = "params"
        if module in deform or module.endswith(".conv_offset"):
            kind = "kernel" if name == "weight" else name
            if module in deform and nasfcos and module.startswith("bbox_head."):
                # NASFCOSHead's deformable op: its kernel a leaf of the op
                parent, leaf = _rename(module, rules, n_lat)[:-len(".conv")], kind
            elif module in deform:
                # a leaf of its parent: X_kernel (HWIO), X_bias
                parent, own = _rename(module, rules, n_lat).rsplit(".", 1)
                leaf = f"{own}_{kind}"
            else:
                parent = _rename(module[:-len(".conv_offset")], rules,
                                 n_lat) + "_offset"
                leaf = kind
            d = out["params"]
            for part in parent.split("."):
                d = d.setdefault(part, {})
            d[leaf] = np.array(np.transpose(arr, (2, 3, 1, 0))
                               if arr.ndim == 4 else arr)
            continue
        if name in ("running_mean", "running_var"):
            collection, leaf = "batch_stats", name[len("running_"):]
        elif CONTEXT_LN.search(module):
            leaf, arr = ("scale" if name == "weight" else name), arr.reshape(-1)
        elif CARAFE_ENCODER.match(module):
            if name == "weight":
                leaf, arr = "kernel", np.transpose(arr, (2, 3, 1, 0))
            else:
                leaf = name
            arr = arr[..., np.argsort(_carafe_order(arr.shape[-1]))]
        elif name in ("weight", "weight_diff") and (
                f"{module}.weight_diff" in state_dict):
            leaf, arr = name, np.transpose(arr, (2, 3, 1, 0))   # a SAC's
        elif name == "weight" and MASK_UPSAMPLE.match(module):
            leaf, arr = "kernel", np.transpose(arr[:, :, ::-1, ::-1],
                                               (2, 3, 0, 1))
        elif name == "weight" and SA_FC.match(module):
            leaf, arr = "kernel", arr[:, :, 0, 0].T
        elif name == "weight" and arr.ndim == 4:
            leaf, arr = "kernel", np.transpose(arr, (2, 3, 1, 0))
        elif name == "weight" and arr.ndim == 3 and POINT_FC.match(module):
            leaf, arr = "kernel", arr[:, :, 0].T
        elif name == "weight" and arr.ndim == 2:
            leaf, arr = "kernel", arr.T
            if ROI_FC.match(module):
                arr = arr[_roi_rows(arr.shape[0],
                                    _roi_channels_torch(state_dict, module),
                                    to_chw=False)]
            if module == RELAY_FC:
                arr = arr[:, _roi_rows(arr.shape[1],
                                       _roi_channels_torch(state_dict, module),
                                       to_chw=False)]
            if module == COARSE_FC0:
                arr = arr[_roi_rows(arr.shape[0],
                                    _coarse_dims_torch(state_dict)[0],
                                    to_chw=False)]
            if module == COARSE_LOGITS:
                arr = arr[:, _roi_rows(arr.shape[1],
                                       _coarse_dims_torch(state_dict)[1],
                                       to_chw=False)]
            if PACK_IN_FC.match(module):
                arr = arr[_roi_rows(arr.shape[0],
                                    _pack_channels_torch(state_dict),
                                    to_chw=False)]
            if module == PACK_OFFSET_FC:
                arr = arr[:, _roi_rows(arr.shape[1], 2, to_chw=False)]
        elif name == "weight" and not module.endswith("l2_norm"):
            leaf = "scale"
        else:
            leaf = name
            if module == RELAY_FC:
                arr = arr[_roi_rows(arr.shape[0],
                                    _roi_channels_torch(state_dict, module),
                                    to_chw=False)]
            if module == COARSE_LOGITS:
                arr = arr[_roi_rows(arr.shape[0],
                                    _coarse_dims_torch(state_dict)[1],
                                    to_chw=False)]
            if module == PACK_OFFSET_FC:
                arr = arr[_roi_rows(arr.shape[0], 2, to_chw=False)]
        d = out[collection]
        for part in _rename(module, rules, n_lat).split("."):
            d = d.setdefault(part, {})
        d[leaf] = np.array(arr)
    return out
