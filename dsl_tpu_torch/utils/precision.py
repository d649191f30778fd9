"""Compute-dtype helpers for the forward pass.

Counterpart of ``dsl_tpu/utils/precision.py``. As in the JAX package,
``compute_dtype=torch.bfloat16`` casts EVERY floating variable — BN
statistics included — and the images to bf16 before the forward, and the
head outputs go back to f32 before loss and decode. This is not
``torch.autocast``, which would keep BN statistics and some ops in f32.

The cast is ``.to()``, which autograd differentiates: in training the
gradients land, in f32, on the f32 master parameters.
"""

from __future__ import annotations

import torch
from torch import nn


def to_compute(module: nn.Module, images: torch.Tensor, compute_dtype,
               params: dict | None = None):
    """Variables (as a name -> tensor dict for ``torch.func.functional_call``)
    and images cast to ``compute_dtype``; the module itself is not touched.
    ``params`` replaces the module's parameters (the EMA teacher's); the
    buffers are the module's. With ``compute_dtype=None`` both come back as
    they are."""
    variables = {**dict(module.named_parameters() if params is None
                        else params.items()),
                 **dict(module.named_buffers())}
    if compute_dtype is None:
        return variables, images
    cast = {k: v.to(compute_dtype) if v.is_floating_point() else v
            for k, v in variables.items()}
    return cast, images.to(compute_dtype)


def outputs_to_f32(outputs):
    """Cast (nested tuples of) tensors to float32."""
    if isinstance(outputs, (tuple, list)):
        return type(outputs)(outputs_to_f32(o) for o in outputs)
    return outputs.float()
