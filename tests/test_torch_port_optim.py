"""The port's mmcv SGD, LR schedule and frozen mask against the JAX package.

- Parameter classes: for every parameter of a small flagship with the full
  model's backbone names (``layers=[2, 1, 1, 3]``, so ``stage_bns.3.2`` and
  the downsample BNs exist), the port's optimizer (its group's lr_mult and
  weight decay, and whether the parameter is in it at all) equals JAX's
  ``is_bias_param`` / ``frozen_backbone_mask`` under the bridge's names;
  ``make_train_step`` refuses a frozen mask that the module's
  ``requires_grad`` does not hold.
- LR: each policy at steps 0, 1, 499, 500, the step boundaries and the end,
  within 1e-6 relative and 1e-8 absolute (the port computes on the host in
  f64, JAX in f32).
- Two SGD updates (so momentum carries) on a seeded gradient tree of the
  tiny flagship's head (one of its convs frozen) against
  ``make_optimizer``, the clip inactive and active:
  parameters within 1e-6 relative (atol 1e-8), ``grad_norm`` within 1e-5 of
  its f64 value (an f32 sum of squares over every gradient).
- AdamW (with ``custom_keys`` lr multipliers, the clip active), Adam (its
  weight decay 0 by default) and SGD under ``momentum_config`` (cosine and
  linear anneal) over 50 updates on seeded gradients against
  ``make_adamw`` / ``make_optimizer`` with ``build_momentum_schedule``:
  every parameter tensor within 1e-6 of its largest magnitude after every
  10 updates; the
  momentum schedule within 1e-6 relative at every step; Adam or AdamW with
  ``momentum_config`` raises in both packages.
"""

import copy

import jax
import numpy as np
import pytest
import torch

import torch_port_util as U
from dsl_tpu.train import build_lr_schedule as j_build_lr_schedule
from dsl_tpu.train import build_optimizer_from_cfg as j_build_optimizer
from dsl_tpu.train import frozen_backbone_mask as j_frozen_backbone_mask
from dsl_tpu.train.optim import is_bias_param as j_is_bias_param
from dsl_tpu_torch.models import build_detector
from dsl_tpu_torch.train import (
    build_lr_schedule, build_optimizer_from_cfg, frozen_backbone_mask,
    make_train_step)
from dsl_tpu_torch.utils.jax_bridge import flax_to_state_dict, state_dict_to_flax

torch.set_num_threads(2)

DEEP_CFG = copy.deepcopy(U.TINY_CFG)
DEEP_CFG["backbone"]["layers"] = [2, 1, 1, 3]


@pytest.fixture(scope="module")
def deep():
    return U.jax_detector_and_variables(DEEP_CFG, seed=2)[1]


def _classes_by_name(det, tx) -> dict:
    """name -> (lr_mult, decay_mult, frozen) as the port's optimizer holds it."""
    opt = tx.init(det)
    group_of = {id(p): g for g in opt.param_groups for p in g["params"]}
    out = {}
    for name, p in det.named_parameters():
        g = group_of.get(id(p))
        out[name] = ((0.0, 0.0, 1.0) if g is None else
                     (g["lr_mult"], g["weight_decay"] / 1e-4, 0.0))
    return out


def _code(cls) -> float:
    lr_mult, decay_mult, frozen = cls
    return 100 * lr_mult + 10 * decay_mult + frozen


def test_param_classes_match_jax(deep):
    det = build_detector(DEEP_CFG)
    frozen = frozen_backbone_mask(det, 1)
    tx, _ = build_optimizer_from_cfg(U.OPTIMIZER, U.OPTIMIZER_CONFIG,
                                     U.LR_CONFIG)
    classes = _classes_by_name(det, tx)
    # one code per parameter, carried to the flax names by the bridge
    got = state_dict_to_flax({
        n: torch.full_like(p, _code(classes[n]))
        for n, p in det.named_parameters()})["params"]
    params = deep["params"]
    jfrozen = j_frozen_backbone_mask(params, 1)
    want = jax.tree_util.tree_map_with_path(
        lambda path, _, fz: _code((0.0, 0.0, 1.0) if fz else (
            (2.0, 0.0, 0.0) if j_is_bias_param(path) else (1.0, 1.0, 0.0))),
        params, jfrozen)
    got_leaves = jax.tree_util.tree_leaves_with_path(got)
    want_leaves = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(got_leaves) == len(want_leaves) > 100
    seen = set()
    for path, g in got_leaves:
        assert np.all(g == want_leaves[path]), (
            jax.tree_util.keystr(path), g.ravel()[0], want_leaves[path])
        seen.add(want_leaves[path])
    assert seen == {_code((0.0, 0.0, 1.0)), _code((2.0, 0.0, 0.0)),
                    _code((1.0, 1.0, 0.0))}
    # the quirk: the last stage's last hidden-state BN is frozen always
    assert frozen["backbone.stage_bns.3.2.weight"]
    assert not frozen_backbone_mask(det, -1)["backbone.stages.0.0.conv1.weight"]
    assert frozen_backbone_mask(det, -1)["backbone.stage_bns.3.2.bias"]
    assert not build_detector(DEEP_CFG).backbone.stage_bns[3][2].weight.requires_grad


def test_frozen_mask_must_match_requires_grad():
    """The module's ``requires_grad`` is the one source of the frozen set:
    ``make_train_step`` takes the mask ``frozen_backbone_mask`` gives and
    refuses one that names other parameters."""
    det = build_detector(U.TINY_CFG)
    tx, _ = build_optimizer_from_cfg(U.OPTIMIZER, U.OPTIMIZER_CONFIG,
                                     U.LR_CONFIG)
    make_train_step(det, tx, frozen_mask=frozen_backbone_mask(det, 1),
                    device="cpu")
    with pytest.raises(ValueError, match="frozen_mask"):
        make_train_step(det, tx, frozen_mask=frozen_backbone_mask(det, 2),
                        device="cpu")


POLICIES = {
    "step": dict(policy="step", step_epochs=(2, 3), steps_per_epoch=1000),
    "cosine": dict(policy="CosineAnnealing", total_iters=4000,
                   min_lr_ratio=0.01),
    "poly": dict(policy="poly", total_iters=4000, power=0.9,
                 min_lr_ratio=1e-3),
    "cyclic": dict(policy="cyclic", total_iters=4000),
}


@pytest.mark.parametrize("name", list(POLICIES))
@pytest.mark.parametrize("warmup_iters", [500, 0])
def test_lr_schedule(name, warmup_iters):
    kw = dict(POLICIES[name], warmup_iters=warmup_iters, warmup_ratio=1 / 3)
    got = build_lr_schedule(0.01, **kw)
    want = j_build_lr_schedule(0.01, **kw)
    for step in (0, 1, 499, 500, 501, 1599, 1600, 1999, 2000, 2999, 3000,
                 3999, 4000, 5000):
        # atol: JAX's f32 rounding of the cyclic policy's end, a small
        # difference of two numbers near 10x base
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   atol=1e-8, err_msg=f"step {step}")


@pytest.fixture(scope="module")
def tiny():
    return U.jax_detector_and_variables(U.TINY_CFG, seed=3)[1]


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0],
                         ids=["clip_inactive", "clip_active"])
def test_sgd_update_matches_jax(tiny, grad_scale):
    """On the tiny flagship's head (convs with biases, GroupNorms, the
    per-level scales), ``conv_centerness`` frozen on both sides."""
    rng = np.random.RandomState(7)
    params = tiny["params"]["bbox_head"]
    jfrozen = jax.tree_util.tree_map_with_path(
        lambda path, _: path[0].key == "conv_centerness", params)
    # zero on frozen leaves, as JAX's train step gives them
    grads = [jax.tree_util.tree_map(
        lambda x, fz: np.asarray(rng.randn(*x.shape) * grad_scale * (not fz),
                                 np.float32), params, jfrozen)
        for _ in range(2)]
    lr = dict(U.LR_CONFIG, warmup_iters=3)
    jtx, _ = j_build_optimizer(params, U.OPTIMIZER, U.OPTIMIZER_CONFIG, lr,
                               frozen_mask=jfrozen)
    jstate = jtx.init(params)
    jparams = params
    for g in grads:
        updates, jstate = jax.jit(jtx.update)(g, jstate, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams, updates)

    det = build_detector(U.TINY_CFG)
    det.load_state_dict(flax_to_state_dict(tiny))
    head = det.bbox_head
    head.conv_centerness.requires_grad_(False)
    tx, _ = build_optimizer_from_cfg(U.OPTIMIZER, U.OPTIMIZER_CONFIG, lr)
    opt = tx.init(head)
    norms = []
    for count, g in enumerate(grads):
        sd = flax_to_state_dict({"params": {"bbox_head": g}})
        for name, p in head.named_parameters():
            p.grad = sd["bbox_head." + name].clone()
        norms.append(float(tx.update(opt, count)))
    want_norms = [np.sqrt(sum(np.sum(np.square(x, dtype=np.float64))
                              for x in jax.tree_util.tree_leaves(g)))
                  for g in grads]
    np.testing.assert_allclose(norms, want_norms, rtol=1e-5)
    assert (min(norms) > 35) == (grad_scale > 1)
    got = state_dict_to_flax(det.state_dict())["params"]["bbox_head"]
    assert sorted(got) == sorted(jparams)
    for (path, g), (_, w) in zip(jax.tree_util.tree_leaves_with_path(got),
                                 jax.tree_util.tree_leaves_with_path(jparams)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6, atol=1e-8,
                                   err_msg=jax.tree_util.keystr(path))
    np.testing.assert_array_equal(got["conv_centerness"]["kernel"],
                                  params["conv_centerness"]["kernel"])


def _run_both(tiny, optimizer, optimizer_config, lr_config, steps,
              momentum_config=None, total_epochs=None):
    """``steps`` updates of the tiny head from seeded gradients in both
    packages (``conv_centerness`` frozen); yields (update, port params,
    JAX params) after every 10."""
    rng = np.random.RandomState(11)
    params = tiny["params"]["bbox_head"]
    jfrozen = jax.tree_util.tree_map_with_path(
        lambda path, _: path[0].key == "conv_centerness", params)
    kw = dict(steps_per_epoch=10, total_epochs=total_epochs,
              momentum_config=momentum_config)
    jtx, _ = j_build_optimizer(params, optimizer, optimizer_config, lr_config,
                               frozen_mask=jfrozen, **kw)
    jstate, jparams = jtx.init(params), params
    jupdate = jax.jit(jtx.update)

    det = build_detector(U.TINY_CFG)
    det.load_state_dict(flax_to_state_dict(tiny))
    head = det.bbox_head
    head.conv_centerness.requires_grad_(False)
    tx, _ = build_optimizer_from_cfg(optimizer, optimizer_config, lr_config,
                                     **kw)
    opt = tx.init(head)
    for count in range(steps):
        g = jax.tree_util.tree_map(
            lambda x, fz: np.asarray(rng.randn(*x.shape) * 0.05 * (not fz),
                                     np.float32), params, jfrozen)
        updates, jstate = jupdate(g, jstate, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams, updates)
        sd = flax_to_state_dict({"params": {"bbox_head": g}})
        for name, p in head.named_parameters():
            p.grad = sd["bbox_head." + name].clone()
        tx.update(opt, count)
        if (count + 1) % 10 == 0:
            yield count, state_dict_to_flax(det.state_dict())["params"][
                "bbox_head"], jparams


def _assert_close(got, want, msg):
    """Each leaf within 1e-6 of its largest magnitude: over 50 updates the
    f32 roundings (JAX's schedules in f32, the port's in f64) leave a few
    ulps on elements that pass near zero."""
    for (path, g), (_, w) in zip(jax.tree_util.tree_leaves_with_path(got),
                                 jax.tree_util.tree_leaves_with_path(want)):
        w = np.asarray(w)
        err = float(np.abs(g - w).max())
        assert err <= 1e-6 * float(np.abs(w).max()), (
            f"{msg} {jax.tree_util.keystr(path)}: {err}")


ADAM_CASES = {
    "adamw": dict(type="AdamW", lr=2e-3, weight_decay=0.05,
                  paramwise_cfg=dict(custom_keys={
                      "conv_cls": dict(lr_mult=0.1),
                      "conv_reg": dict(lr_mult=0.5)})),
    "adam": dict(type="Adam", lr=1e-3, betas=(0.8, 0.99), eps=1e-6),
}


@pytest.mark.parametrize("name", list(ADAM_CASES))
def test_adam_updates_match_jax(tiny, name):
    lr = dict(policy="step", warmup="linear", warmup_iters=5,
              warmup_ratio=0.1, step=[3])
    clip = dict(grad_clip=dict(max_norm=0.5))
    moved = 0
    for count, got, want in _run_both(tiny, ADAM_CASES[name], clip, lr, 50):
        _assert_close(got, want, f"{name} update {count}")
        moved = max(moved, float(np.abs(got["conv_cls"]["kernel"]
                                        - tiny["params"]["bbox_head"][
                                            "conv_cls"]["kernel"]).max()))
    assert moved > 1e-4
    np.testing.assert_array_equal(
        got["conv_centerness"]["kernel"],
        tiny["params"]["bbox_head"]["conv_centerness"]["kernel"])


@pytest.mark.parametrize("anneal", ["cos", "linear"])
def test_momentum_config_matches_jax(tiny, anneal):
    from dsl_tpu.train.optim import build_momentum_schedule as j_momentum
    from dsl_tpu_torch.train import build_momentum_schedule

    kw = dict(target_ratio=(0.85 / 0.95, 1.0), step_ratio_up=0.4,
              total_iters=50, anneal_strategy=anneal)
    got, want = build_momentum_schedule(0.95, **kw), j_momentum(0.95, **kw)
    np.testing.assert_allclose([got(s) for s in range(60)],
                               [float(want(s)) for s in range(60)], rtol=1e-6)
    assert min(got(s) for s in range(50)) < 0.86
    mc = dict(policy="cyclic", target_ratio=(0.85 / 0.95, 1.0),
              step_ratio_up=0.4, anneal_strategy=anneal)
    sgd = dict(U.OPTIMIZER, momentum=0.95)
    lr = dict(U.LR_CONFIG, warmup_iters=3)
    for count, got_p, want_p in _run_both(tiny, sgd, U.OPTIMIZER_CONFIG, lr,
                                          50, momentum_config=mc,
                                          total_epochs=5):
        _assert_close(got_p, want_p, f"momentum {anneal} update {count}")


@pytest.mark.parametrize("kind", ["Adam", "AdamW"])
def test_adam_with_momentum_config_raises(tiny, kind):
    mc = dict(policy="cyclic")
    with pytest.raises(NotImplementedError, match="momentum_config"):
        build_optimizer_from_cfg(dict(type=kind, lr=1e-3), None, None,
                                 total_epochs=2, momentum_config=mc)
    with pytest.raises(NotImplementedError, match="momentum_config"):
        j_build_optimizer(tiny["params"], dict(type=kind, lr=1e-3), None,
                          None, total_epochs=2, momentum_config=mc)


def test_chip_smoke_momentum_values_are_jax():
    """The momentum values ``chip_smoke.py`` phase 16 holds the card's SGD
    run to are the JAX package's schedule for that run, exactly."""
    import sys
    from pathlib import Path

    from dsl_tpu.train.optim import build_momentum_schedule as j_momentum

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    mc = dict(chip_smoke.MOMENTUM_CONFIG)
    mc.pop("policy")
    want = j_momentum(chip_smoke.MOMENTUM_BASE, policy="cyclic",
                      total_iters=chip_smoke.MOMENTUM_ITERS, **mc)
    assert chip_smoke.MOMENTUM_EXPECTED == tuple(
        float(want(s)) for s in range(chip_smoke.MOMENTUM_ITERS))
