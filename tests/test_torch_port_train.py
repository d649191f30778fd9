"""The port's train step against the JAX package's, on the tiny flagship
(``__graft_entry__._flagship_detector(tiny=True)``'s config) at 64x96.

The batch (``torch_port_util.semi_batch``) has ignore boxes, per-source
weights (1 labeled, 3 unlabeled), an si pair and a labeled image with no
valid GT. The JAX step is compiled once per module, and the tests that run
it (the f32 trajectory, the resume, a bf16 step) are ``slow``.

Tolerances:
- ``detector_loss`` in f32: every loss within 1e-5 relative; the gradient
  of every trainable parameter within the banded check of
  ``torch_port_util.assert_banded`` (5% of the leaf's largest magnitude,
  floor 1e-5, and 1e-3 relative L2 over all leaves): f32 convolutions and
  GroupNorm sum in another order in the two frameworks;
- bf16 (every variable cast, BN statistics included): losses within 2e-2
  relative (si-soft, a mean square of differences of near-equal logits,
  within 0.15), gradients, and one whole step's updates, banded at 25% per
  leaf (floor 1e-4) and 5e-2 in L2 — bf16 keeps 8 bits of mantissa and the
  two round at different places; the port's own bf16 losses part from its
  f32 ones by more than 1e-5, and its gradients leave the f32 band (so the
  casts took effect);
- a 10-step f32 trajectory of the whole step (loss, backward, mmcv SGD,
  EMA): losses within 1e-4 and ``grad_norm`` within 1e-3 relative at every
  step (the two trajectories part by f32 rounding: ``grad_norm``, a sum of
  squares over every gradient, was seen 1.1e-4 apart at step 8), and the student's and the teacher's total updates banded as above;
  frozen parameters bit-identical to their start;
- the ``TrainState`` bridge exact both ways (the momentum of frozen
  parameters, which only JAX keeps, comes back as zeros).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as U
from dsl_tpu.models.detectors.single_stage import detector_loss as j_detector_loss
from dsl_tpu.train import build_optimizer_from_cfg as j_build_optimizer
from dsl_tpu.train import create_train_state as j_create_train_state
from dsl_tpu.train import frozen_backbone_mask as j_frozen_backbone_mask
from dsl_tpu.train import make_train_step as j_make_train_step
from dsl_tpu.train.optim import SGDState
from dsl_tpu_torch.models import build_detector
from dsl_tpu_torch.models.detectors.single_stage import detector_loss
from dsl_tpu_torch.train import (
    build_optimizer_from_cfg, create_train_state, frozen_backbone_mask,
    make_eval_step, make_train_step)
from dsl_tpu_torch.train.bridge import train_state_from_jax, train_state_to_jax
from dsl_tpu_torch.utils.jax_bridge import state_dict_to_flax
from dsl_tpu_torch.utils.random_batch import to_torch

torch.set_num_threads(2)

STEPS = 10


@pytest.fixture(scope="module")
def tiny():
    det, var = U.jax_detector_and_variables(U.TINY_CFG, seed=0)
    return det, var, U.semi_batch()


@pytest.fixture(scope="module")
def jax_loss_grad(tiny):
    det, var, batch = tiny
    jb = U.jax_batch(batch)

    @partial(jax.jit, static_argnames="dtype")
    def value_and_grad(params, cur_iter, dtype=None):
        def loss(p):
            return j_detector_loss(
                det, {"params": p, "batch_stats": var["batch_stats"]}, jb,
                cur_iter=cur_iter, compute_dtype=dtype)
        return jax.value_and_grad(loss, has_aux=True)(params)

    return value_and_grad


def _port_loss_grad(var, batch, cur_iter, dtype=None):
    port = U.port_detector(U.TINY_CFG, var)
    loss, log_vars = detector_loss(port, to_torch(batch, "cpu"),
                                   cur_iter=cur_iter, compute_dtype=dtype)
    loss.backward()
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
             for n, p in port.named_parameters()}
    return log_vars, state_dict_to_flax(grads)["params"], U.frozen_tree(port)


@pytest.mark.parametrize("cur_iter", [4999, 5001],
                         ids=["before_soft_warm_up", "after_soft_warm_up"])
def test_loss_and_grads_match_jax(tiny, jax_loss_grad, cur_iter):
    det, var, batch = tiny
    (_, want), want_grads = jax_loss_grad(var["params"], cur_iter)
    got, grads, frozen = _port_loss_grad(var, batch, cur_iter)
    assert set(got) == set(want) == {"loss", "loss_cls", "loss_bbox",
                                     "loss_centerness", "loss_sisoft"}
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)
    assert U.assert_banded(grads, want_grads, skip=frozen) > 50
    # the frozen parameters get no gradient in the port
    port = U.port_detector(U.TINY_CFG, var)
    assert not port.backbone.conv1.weight.requires_grad


def test_si_soft_warm_up_gate(tiny):
    det, var, batch = tiny
    soft = [float(_port_loss_grad(var, batch, it)[0]["loss_sisoft"])
            for it in (5000, 5001)]
    np.testing.assert_allclose(soft[1], 1000 * soft[0], rtol=1e-5)
    assert soft[0] > 0


def test_bf16_loss_and_grads_match_jax(tiny, jax_loss_grad):
    det, var, batch = tiny
    (_, want), want_grads = jax_loss_grad(var["params"], 10, jnp.bfloat16)
    got, grads, frozen = _port_loss_grad(var, batch, 10, torch.bfloat16)
    for k in want:
        # si-soft is a mean square of differences of near-equal bf16 logits
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=0.15 if k == "loss_sisoft" else 2e-2,
                                   err_msg=k)
    U.assert_banded(grads, want_grads, skip=frozen, rel=0.25, floor=1e-4,
                    l2=5e-2)


def test_bf16_casts_take_effect(tiny):
    """The port's own bf16 losses part from its f32 ones by more than the
    f32 limit against JAX (1e-5), and its gradients by more than the f32
    band: a port that ignored ``compute_dtype`` would pass the bf16 checks
    above, which sit at 2e-2. Seen: losses 7e-4 (``loss``) to 1.2e-3
    (``loss_bbox``) apart, si-soft 8%."""
    _, var, batch = tiny
    f32, grads32, frozen = _port_loss_grad(var, batch, 10)
    bf16, grads16, _ = _port_loss_grad(var, batch, 10, torch.bfloat16)
    rel = {k: abs(float(bf16[k]) - float(f32[k])) / abs(float(f32[k]))
           for k in f32}
    assert max(rel.values()) > 1e-5, rel
    with pytest.raises(AssertionError):
        U.assert_banded(grads16, grads32, skip=frozen)


def _jax_step(det, var, dtype=None):
    frozen = j_frozen_backbone_mask(var["params"], 1)
    tx, _ = j_build_optimizer(
        var["params"], U.OPTIMIZER, U.OPTIMIZER_CONFIG, U.LR_CONFIG,
        steps_per_epoch=U.STEPS_PER_EPOCH, frozen_mask=frozen)
    step = jax.jit(j_make_train_step(det, tx, ema_interval=1,
                                     ema_start_iter=1, compute_dtype=dtype,
                                     frozen_mask=frozen))
    return tx, step


@pytest.fixture(scope="module")
def jax_step(tiny):
    det, var, _ = tiny
    return _jax_step(det, var)


def _port_step(state_tree=None, var=None, dtype=None):
    """The port's entry point: build, mask, optimizer, state, step."""
    det = build_detector(U.TINY_CFG)
    frozen = frozen_backbone_mask(det, 1)
    tx, _ = build_optimizer_from_cfg(
        U.OPTIMIZER, U.OPTIMIZER_CONFIG, U.LR_CONFIG,
        steps_per_epoch=U.STEPS_PER_EPOCH)
    if state_tree is None:
        det.load_state_dict(U.port_detector(U.TINY_CFG, var).state_dict())
        state = create_train_state(det, tx, ema_ratio=0.99, device="cpu")
    else:
        state = train_state_from_jax(state_tree, det, tx, device="cpu")
    step = make_train_step(det, tx, ema_interval=1, ema_start_iter=1,
                           compute_dtype=dtype, frozen_mask=frozen,
                           device="cpu")
    return state, step


def _tree(state) -> dict:
    """A JAX TrainState as the bridge's plain numpy tree."""
    tree = dict(params=state.params, batch_stats=state.batch_stats,
                teacher_params=state.teacher_params,
                opt_state=dict(momentum=state.opt_state.momentum,
                               count=state.opt_state.count),
                step=state.step, ema_ratio=state.ema_ratio,
                ema_initialized=state.ema_initialized)
    return jax.tree_util.tree_map(np.asarray, tree)


def _run_both(jax_step, jstate, pstate, pstep, batch, steps):
    tx, jstep = jax_step
    jb, tb = U.jax_batch(batch), to_torch(batch, "cpu")
    got, want = [], []
    for _ in range(steps):
        jstate, jm = jstep(jstate, jb)
        want.append({k: float(v) for k, v in jm.items()})
        got.append({k: float(v) for k, v in pstep(pstate, tb).items()})
    return jstate, got, want


def _assert_metrics(got, want, first_step):
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(
                g[k], w[k], rtol=1e-3 if k == "grad_norm" else 1e-4,
                err_msg=f"step {first_step + i}: {k}")


@pytest.fixture(scope="module")
def trajectory(tiny, jax_step):
    det, var, batch = tiny
    tx, _ = jax_step
    jstate0 = j_create_train_state(var, tx, ema_ratio=0.99)
    pstate, pstep = _port_step(var=var)
    init = train_state_to_jax(pstate)
    jstate, got, want = _run_both(jax_step, jstate0, pstate, pstep, batch,
                                  STEPS)
    return init, jstate, pstate, got, want


@pytest.mark.slow
def test_trajectory_matches_jax(tiny, trajectory):
    init, jstate, pstate, got, want = trajectory
    _assert_metrics(got, want, first_step=0)
    assert want[0]["grad_norm"] > 35, "the clip must be active"
    final = train_state_to_jax(pstate)
    want_tree = _tree(jstate)
    assert final["step"] == want_tree["step"] == STEPS
    assert final["opt_state"]["count"] == STEPS and final["ema_initialized"]
    frozen = U.frozen_tree(pstate.student)
    for key in ("params", "teacher_params"):
        assert U.assert_banded(final[key], want_tree[key], init[key],
                               skip=frozen) > 50
    # frozen parameters: bit-identical to their start in the port
    for (path, got), (_, start), (_, fz) in zip(
            jax.tree_util.tree_leaves_with_path(final["params"]),
            jax.tree_util.tree_leaves_with_path(init["params"]),
            jax.tree_util.tree_leaves_with_path(frozen)):
        if fz:
            np.testing.assert_array_equal(got, start, err_msg=str(path))


@pytest.mark.slow
def test_bf16_step_matches_jax(tiny):
    """One whole bf16 step (loss, backward, SGD, EMA) against JAX's."""
    det, var, batch = tiny
    tx, jstep = _jax_step(det, var, jnp.bfloat16)
    pstate, pstep = _port_step(var=var, dtype=torch.bfloat16)
    init = train_state_to_jax(pstate)
    jstate, got, want = _run_both(
        (tx, jstep), j_create_train_state(var, tx, ema_ratio=0.99), pstate,
        pstep, batch, 1)
    for k in want[0]:
        np.testing.assert_allclose(got[0][k], want[0][k], err_msg=k,
                                   rtol=0.15 if k == "loss_sisoft" else 2e-2)
    final, want_tree = train_state_to_jax(pstate), _tree(jstate)
    for key in ("params", "teacher_params"):
        U.assert_banded(final[key], want_tree[key], init[key],
                        skip=U.frozen_tree(pstate.student), rel=0.25,
                        floor=1e-4, l2=5e-2)


def _assert_trees_equal(got, want):
    got_leaves = jax.tree_util.tree_leaves_with_path(got)
    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (path, g), (_, w) in zip(got_leaves, want_leaves):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=jax.tree_util.keystr(path))


def test_train_state_bridge_round_trips_exactly(tiny):
    """A tree with the JAX TrainState's fields (``_tree``'s), seeded
    teacher and momentum, and counters past the start."""
    det, var, _ = tiny
    frozen = j_frozen_backbone_mask(var["params"], 1)
    rng = np.random.RandomState(5)

    def noise(tree):
        return jax.tree_util.tree_map(
            lambda x: np.asarray(x + rng.randn(*np.shape(x)), np.float32), tree)

    tree = dict(params=var["params"], batch_stats=var["batch_stats"],
                teacher_params=noise(var["params"]),
                opt_state=dict(momentum=noise(var["params"]),
                               count=np.int32(6)),
                step=np.int32(7), ema_ratio=np.float32(0.995),
                ema_initialized=np.bool_(True))
    # JAX -> port -> JAX: exact, but the frozen leaves' momentum is zero
    pstate = _port_step(state_tree=tree)[0]
    assert (pstate.step, pstate.opt_count, pstate.ema_initialized) == (7, 6, True)
    want = dict(tree, opt_state=dict(
        tree["opt_state"], momentum=jax.tree_util.tree_map(
            lambda m, f: np.zeros_like(m) if f else m,
            tree["opt_state"]["momentum"], frozen)))
    once = train_state_to_jax(pstate)
    _assert_trees_equal(once, want)
    # port -> JAX -> port: exact
    _assert_trees_equal(train_state_to_jax(_port_step(state_tree=once)[0]),
                        once)


def test_entry_points_need_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the check is for hosts without it")
    det = build_detector(U.TINY_CFG)
    tx, _ = build_optimizer_from_cfg(U.OPTIMIZER, U.OPTIMIZER_CONFIG,
                                     U.LR_CONFIG)
    with pytest.raises(RuntimeError, match="CUDA"):
        create_train_state(det, tx)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_train_step(det, tx)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_eval_step(det)


@pytest.mark.slow
def test_resume_from_jax_across_the_soft_warm_up(tiny, jax_step, trajectory):
    """A JAX state at step 4998 carried into the port: both take the four
    steps 4998..5001, the last one past ``soft_warm_up`` = 5000."""
    _, var, batch = tiny
    _, jstate, _, _, _ = trajectory
    jstate = jstate.replace(
        step=jnp.int32(4998),
        opt_state=SGDState(jstate.opt_state.momentum, jnp.int32(4998)))
    start = _tree(jstate)
    pstate, pstep = _port_step(state_tree=start)
    jstate, got, want = _run_both(jax_step, jstate, pstate, pstep, batch, 4)
    _assert_metrics(got, want, first_step=4998)
    np.testing.assert_allclose(got[3]["loss_sisoft"] / got[2]["loss_sisoft"],
                               1000, rtol=0.5)
    assert pstate.step == 5002
    U.assert_banded(train_state_to_jax(pstate)["params"],
                    _tree(jstate)["params"], start["params"],
                    skip=U.frozen_tree(pstate.student))
