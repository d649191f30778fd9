"""The NMS kernel and the train path on the card (marker ``cuda``; skipped
where there is none).

Runs without JAX, so it can run on a machine that has only the port's
dependencies:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py

- ``nms_keep`` launches ``csrc/nms_kernel.cu`` and gives keeps bit-identical
  to ``nms_keep_reference`` on every case of ``dsl_tpu_torch.ops.nms_cases``,
  the card-only ``timing_cases()`` included;
- the wrapper refuses what the kernel does not take (a non-contiguous or
  misaligned box tensor, tensors on two devices) instead of launching, and
  takes an N past the first kernel's shared-memory ceiling (about 28k);
- the launch goes to the tensors' card whichever card is current (two
  cards needed);
- one f32 train step of the tiny flagship on the card agrees with the same
  step on the CPU (losses within 1e-4 and ``grad_norm`` within 1e-3
  relative, the updated parameters within 5% of each one's update, floor
  1e-5), and the teacher's eval step launches the NMS kernel once.
"""

import numpy as np
import pytest
import torch

import torch_port_util as U
from dsl_tpu_torch.models import build_detector
from dsl_tpu_torch.ops import nms_cases
from dsl_tpu_torch.ops.nms import nms_keep, nms_keep_reference
from dsl_tpu_torch.train import (
    build_optimizer_from_cfg, create_train_state, frozen_backbone_mask,
    make_eval_step, make_train_step)
from dsl_tpu_torch.utils.jax_bridge import flax_to_state_dict, state_dict_to_flax
from dsl_tpu_torch.utils.random_batch import to_torch

CASES = nms_cases.cases() + [nms_cases.tiny_boxes()] + nms_cases.timing_cases()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_kernel_matches_plain_version(card, case):
    _, boxes, valid, thr = case
    b = torch.from_numpy(boxes).to(card)
    v = torch.from_numpy(valid).to(card)
    before = nms_keep.launches
    got = nms_keep(b, v, thr)
    want = nms_keep_reference(b, v, thr)
    torch.cuda.synchronize()
    assert nms_keep.launches == before + 1
    assert torch.equal(got, want), int((got != want).sum())


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(card):
    _, boxes, valid, thr = nms_cases.cases(max_n=65)[1]
    b = torch.from_numpy(boxes).to(card)
    v = torch.from_numpy(valid).to(card)
    before = nms_keep.launches
    with pytest.raises(ValueError, match="contiguous"):
        nms_keep(b.transpose(0, 1).contiguous().transpose(0, 1), v, thr)
    shifted = torch.empty(b.numel() + 1, device=card)[1:].view_as(b)
    shifted.copy_(b)
    with pytest.raises(ValueError, match="aligned"):
        nms_keep(shifted, v, thr)
    with pytest.raises(ValueError, match="one CUDA device"):
        nms_keep(b, v.cpu(), thr)
    assert nms_keep.launches == before
    # the first version's scan kept (N/64 + 1) * N/8 bytes in shared memory
    # and refused N of about 28k and more; the scratch in device memory is
    # the only limit now
    big = torch.from_numpy(nms_cases.random_boxes(np.random.RandomState(0), 1,
                                                  40000)).to(card)
    keep = nms_keep(big, torch.ones(1, 40000, dtype=torch.bool, device=card), thr)
    torch.cuda.synchronize()
    assert nms_keep.launches == before + 1 and bool(keep[0, 0])


@pytest.mark.cuda
def test_kernel_runs_on_the_tensors_card_not_the_current_one(card):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: the tensors on one, the other current")
    _, boxes, valid, thr = nms_cases.cases(max_n=65)[1]
    other = torch.device("cuda", 1)
    b = torch.from_numpy(boxes).to(other)
    v = torch.from_numpy(valid).to(other)
    with torch.cuda.device(0):
        got = nms_keep(b, v, thr)
    torch.cuda.synchronize(other)
    assert got.device == other
    assert torch.equal(got, nms_keep_reference(b, v, thr))


def _tiny_train(device):
    """The tiny flagship's train entry point on ``device``, seeded weights."""
    det = build_detector(U.TINY_CFG)
    variables = U.fill_variables(state_dict_to_flax(det.state_dict()), seed=0)
    det.load_state_dict(flax_to_state_dict(variables))
    frozen = frozen_backbone_mask(det, 1)
    tx, _ = build_optimizer_from_cfg(
        U.OPTIMIZER, U.OPTIMIZER_CONFIG, U.LR_CONFIG,
        steps_per_epoch=U.STEPS_PER_EPOCH)
    state = create_train_state(det, tx, device=device)
    step = make_train_step(det, tx, ema_start_iter=1, frozen_mask=frozen,
                           device=device)
    return state, step


@pytest.mark.cuda
def test_train_step_matches_cpu(card):
    out = {}
    for device in (card, torch.device("cpu")):
        state, step = _tiny_train(device)
        init = {n: p.detach().cpu().clone()
                for n, p in state.student.named_parameters()}
        metrics = step(state, to_torch(U.semi_batch(), device))
        out[device.type] = ({k: float(v) for k, v in metrics.items()},
                            {n: p.detach().cpu()
                             for n, p in state.student.named_parameters()})
    (m_card, p_card), (m_cpu, p_cpu) = out["cuda"], out["cpu"]
    assert set(m_card) == set(m_cpu)
    for k, v in m_cpu.items():
        np.testing.assert_allclose(m_card[k], v, err_msg=k,
                                   rtol=1e-3 if k == "grad_norm" else 1e-4)
    moved = 0
    for n, want in p_cpu.items():
        dw, dg = want - init[n], p_card[n] - init[n]
        scale = float(torch.maximum(dw.abs().max(), dg.abs().max()))
        assert float((dg - dw).abs().max()) <= max(0.05 * scale, 1e-5), n
        moved += scale > 0
    assert moved > 50


@pytest.mark.cuda
def test_teacher_eval_step_launches_nms_once(card):
    state, step = _tiny_train(card)
    batch = to_torch(U.semi_batch(), card)
    before = nms_keep.launches
    step(state, batch)
    torch.cuda.synchronize()
    assert nms_keep.launches == before
    dets, _, valid = make_eval_step(state.student, use_teacher=True,
                                    device=card)(state, batch["images"])
    torch.cuda.synchronize()
    assert nms_keep.launches == before + 1
    assert dets.shape == (4, 100, 5) and bool(torch.isfinite(dets).all())
