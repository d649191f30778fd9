"""Load the reference's torch checkpoints into the port's modules.

Counterpart of ``dsl_tpu/utils/torch_import.py``, which maps two backbone
layouts into flax: the RLA ImageNet checkpoint (``stages.S.B.convK``,
``stage_bns.S.B``, ``conv_outs.S``, ``recurrent_convs.S``) and the mmdet
or torchvision ResNet (``layerS.B.convK``, ``layerS.B.bnK``,
``layerS.B.downsample.{0,1}``), and a whole mmdet detector (``backbone.``,
``neck.lateral_convs.i.conv``, ``neck.fpn_convs.i.conv``,
``bbox_head.cls_convs.i.{conv,gn}``, ``bbox_head.scales.i.scale``, ...).
The port's modules carry those very names, so the key map here is the
identity once a leading ``module.`` (and, for a backbone, ``backbone.``)
is stripped, and no kernel is transposed.

A checkpoint is a state dict, or a dict holding one under ``state_dict``
or ``model``; only its tensors are read, with ``weights_only`` unpickling.
Each load names the module's keys the file lacks and the file's keys the
module lacks (a classifier, ``num_batches_tracked``); both are left alone,
as the JAX package leaves them. A shape that differs, a file whose keys
match none of the module's, or a path that does not exist raises, where
the JAX package warns and keeps its random init.
"""

from __future__ import annotations

import logging
import re

import torch
from torch import nn

logger = logging.getLogger("dsl_tpu_torch")


def state_dict_of(ckpt: dict) -> dict[str, torch.Tensor]:
    """The tensors of a loaded checkpoint, unwrapped from ``state_dict`` or
    ``model`` where it holds one."""
    for key in ("state_dict", "model"):
        if isinstance(ckpt.get(key), dict):
            ckpt = ckpt[key]
            break
    return {k: v for k, v in ckpt.items() if torch.is_tensor(v)}


def load_state_dict_file(path: str) -> dict[str, torch.Tensor]:
    """:func:`state_dict_of` a torch checkpoint file, on the CPU."""
    return state_dict_of(torch.load(str(path), map_location="cpu",
                                    weights_only=True))


def load_into(module: nn.Module, state_dict: dict[str, torch.Tensor],
              source: str) -> tuple[list[str], list[str]]:
    """``module.load_state_dict`` by name, not strict: returns (missing,
    unexpected) keys and logs them. A per-level ``Scale`` saved with shape
    (1,) loads into the port's 0-d scale. Raises on a shape mismatch and
    where no key of the file is the module's."""
    own = module.state_dict()
    sd = {k: (v.reshape(own[k].shape) if k in own and v.numel() == 1
              and own[k].numel() == 1 else v)
          for k, v in state_dict.items()}
    if own and not set(sd) & set(own):
        raise KeyError(f"{source}: none of its {len(sd)} keys (e.g. "
                       f"{sorted(sd)[:3]}) is a key of {type(module).__name__}")
    result = module.load_state_dict(sd, strict=False)
    missing, unexpected = list(result.missing_keys), list(result.unexpected_keys)
    logger.info("loaded %s into %s: %d keys, %d missing %s, %d unexpected %s",
                source, type(module).__name__, len(sd) - len(unexpected),
                len(missing), missing[:5], len(unexpected), unexpected[:5])
    return missing, unexpected


def strip_prefix(state_dict: dict, prefixes: str = r"module\.") -> dict:
    """Keys without one leading match of the regex ``prefixes``."""
    return {re.sub(rf"^({prefixes})", "", k): v for k, v in state_dict.items()}


def load_torch_backbone(path: str, backbone: nn.Module
                        ) -> tuple[list[str], list[str]]:
    """A backbone checkpoint (RLA ImageNet ``.pth.tar``, mmdet or
    torchvision ResNet) into ``backbone``; ``module.`` and ``backbone.``
    prefixes are stripped."""
    sd = strip_prefix(load_state_dict_file(path), r"module\.|backbone\.")
    return load_into(backbone, sd, str(path))


def load_torch_detector(path: str, detector: nn.Module
                        ) -> tuple[list[str], list[str]]:
    """A whole-detector checkpoint (mmdet layout: ``backbone.``, ``neck.``,
    ``bbox_head.``) into ``detector``; a ``module.`` prefix is stripped."""
    sd = strip_prefix(load_state_dict_file(path))
    return load_into(detector, sd, str(path))
