"""A train state across the JAX package and the port, as a plain tree.

``train_state_to_jax`` writes the fields of the JAX package's ``TrainState``
(``dsl_tpu/train/train_state.py``) as nested dicts of numpy arrays, in the
flax names of ``utils.jax_bridge``; ``train_state_from_jax`` reads them
back into a port ``TrainState``. Neither imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from dsl_tpu_torch.train.train_state import TrainState, create_train_state
from dsl_tpu_torch.utils.jax_bridge import flax_to_state_dict, state_dict_to_flax


def train_state_to_jax(state: TrainState) -> dict:
    """A port ``TrainState`` -> the fields of the JAX package's
    ``TrainState`` as a plain tree of numpy arrays: ``params``,
    ``batch_stats``, ``teacher_params``, ``opt_state`` = ``{"momentum",
    "count"}`` (its ``SGDState``), ``step``, ``ema_ratio``,
    ``ema_initialized``.

    The JAX optimizer keeps a momentum buffer for every parameter, frozen
    ones included (it decays there and is never applied); the port keeps
    none for a frozen parameter, nor for one not yet stepped: both are
    written as zeros.
    """
    det = state.student
    variables = state_dict_to_flax(det.state_dict())
    momentum = {}
    for name, p in det.named_parameters():
        buf = state.optimizer.state.get(p, {}).get("momentum_buffer")
        momentum[name] = torch.zeros_like(p) if buf is None else buf
    return dict(
        params=variables["params"], batch_stats=variables["batch_stats"],
        teacher_params=state_dict_to_flax(state.teacher_params)["params"],
        opt_state=dict(momentum=state_dict_to_flax(momentum)["params"],
                       count=np.int32(state.opt_count)),
        step=np.int32(state.step),
        ema_ratio=np.float32(state.ema_ratio.item()),
        ema_initialized=np.bool_(state.ema_initialized))


def train_state_from_jax(tree: dict, detector, tx,
                         device: str | torch.device = "cuda") -> TrainState:
    """The tree :func:`train_state_to_jax` writes -> a port ``TrainState``
    for ``detector`` (loaded with ``params``/``batch_stats`` and moved to
    ``device``) and ``tx`` (an ``MMCVSGD``). Momentum buffers of parameters
    the port does not optimize (frozen ones) are dropped."""
    detector.load_state_dict(flax_to_state_dict(
        {"params": tree["params"], "batch_stats": tree["batch_stats"]}))
    state = create_train_state(detector, tx, float(tree["ema_ratio"]), device)
    dev = state.ema_ratio.device
    teacher = flax_to_state_dict({"params": tree["teacher_params"]})
    state.teacher_params = {k: teacher[k].to(dev) for k in state.teacher_params}
    momentum = flax_to_state_dict({"params": tree["opt_state"]["momentum"]})
    names = {id(p): n for n, p in detector.named_parameters()}
    for group in state.optimizer.param_groups:
        for p in group["params"]:
            state.optimizer.state[p]["momentum_buffer"] = (
                momentum[names[id(p)]].to(dev))
    state.opt_count = int(tree["opt_state"]["count"])
    state.step = int(tree["step"])
    state.ema_initialized = bool(tree["ema_initialized"])
    return state
