"""The NMS kernel on the card (marker ``cuda``; skipped where there is none).

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
  cards needed).
"""

import numpy as np
import pytest
import torch

from dsl_tpu_torch.ops import nms_cases
from dsl_tpu_torch.ops.nms import nms_keep, nms_keep_reference

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
