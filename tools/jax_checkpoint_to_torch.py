#!/usr/bin/env python
"""Convert a JAX-package train checkpoint into the PyTorch port's layout.

Usage:
  python tools/jax_checkpoint_to_torch.py CONFIG JAX_CHECKPOINT OUT.pth

``JAX_CHECKPOINT`` is the path ``dsl_tpu.utils.checkpoint.save_checkpoint``
was given (an orbax directory ``<path>.orbax``, or the npz fallback
``<path>.npz.d``, beside ``<path>.meta.json``). The JAX side builds the
config's detector and optimizer to restore the ``TrainState`` into; its
fields cross as plain numpy through ``dsl_tpu_torch.train.bridge.
train_state_from_jax`` into a port ``TrainState`` (student, EMA teacher,
SGD momentum, step, EMA ratio) on the CPU, which
``dsl_tpu_torch.utils.checkpoint.save_checkpoint`` writes to ``OUT.pth``
with the JAX checkpoint's meta (its epoch). The result resumes
``train_detector`` and serves through ``init_detector``.

This script imports JAX, flax and orbax, so it runs where the JAX package
does; the port itself imports none of them.
"""

from __future__ import annotations

import argparse
import os.path as osp
import sys

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

import numpy as np


def jax_train_state_tree(config: str, checkpoint: str) -> tuple[dict, dict]:
    """The JAX checkpoint as the bridge's plain tree, and its meta."""
    import jax
    import jax.numpy as jnp

    from dsl_tpu.config import Config
    from dsl_tpu.models.detectors.single_stage import (
        build_detector, init_detector_variables)
    from dsl_tpu.train import (
        build_optimizer_from_cfg, create_train_state, frozen_backbone_mask)
    from dsl_tpu.utils.checkpoint import load_checkpoint

    cfg = Config.fromfile(config)
    det = build_detector(dict(cfg.model))
    # the variables' shapes do not depend on the canvas
    shapes = jax.eval_shape(
        lambda: init_detector_variables(det, jax.random.PRNGKey(0),
                                        jnp.zeros((1, 64, 64, 3), jnp.float32)))
    variables = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes)
    frozen = frozen_backbone_mask(
        variables["params"], cfg.model.get("backbone", {}).get(
            "frozen_stages", -1))
    tx, _ = build_optimizer_from_cfg(
        variables["params"], dict(cfg.optimizer),
        optimizer_config=dict(cfg.get("optimizer_config", {}) or {}),
        lr_config=dict(cfg.get("lr_config", {}) or {}), frozen_mask=frozen)
    target = create_train_state(variables, tx)
    state, meta = load_checkpoint(checkpoint, target)
    tree = dict(params=state.params, batch_stats=state.batch_stats,
                teacher_params=state.teacher_params,
                opt_state=dict(momentum=state.opt_state.momentum,
                               count=state.opt_state.count),
                step=state.step, ema_ratio=state.ema_ratio,
                ema_initialized=state.ema_initialized)
    meta = {k: v for k, v in meta.items() if k != "backend"}
    return jax.tree_util.tree_map(np.asarray, tree), meta


def convert(config: str, checkpoint: str, out: str):
    """Write ``checkpoint`` (JAX) to ``out`` (the port's layout); returns
    the port ``TrainState``."""
    from dsl_tpu_torch.config import Config
    from dsl_tpu_torch.models import build_detector
    from dsl_tpu_torch.train import build_optimizer_from_cfg
    from dsl_tpu_torch.train.bridge import train_state_from_jax
    from dsl_tpu_torch.utils.checkpoint import save_checkpoint

    tree, meta = jax_train_state_tree(config, checkpoint)
    cfg = Config.fromfile(config)
    det = build_detector(dict(cfg.model))
    tx, _ = build_optimizer_from_cfg(
        dict(cfg.optimizer),
        optimizer_config=dict(cfg.get("optimizer_config", {}) or {}),
        lr_config=dict(cfg.get("lr_config", {}) or {}))
    state = train_state_from_jax(tree, det, tx, device="cpu")
    save_checkpoint(out, state, meta=meta)
    return state


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("config")
    p.add_argument("checkpoint", help="the JAX checkpoint's path")
    p.add_argument("out", help="the port's checkpoint to write")
    a = p.parse_args()
    state = convert(a.config, a.checkpoint, a.out)
    print(f"wrote {a.out}: step {state.step}")


if __name__ == "__main__":
    main()
