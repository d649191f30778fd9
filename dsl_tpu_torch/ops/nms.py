"""Greedy hard-NMS keep mask: the CUDA kernel and its plain PyTorch version.

Counterpart of ``dsl_tpu/ops/nms_pallas.py::pallas_nms_keep``, batched over
images. :func:`nms_keep` launches ``csrc/nms_kernel.cu`` for CUDA tensors
and takes :func:`nms_keep_reference` only for CPU tensors.

Semantics (both versions, bit for bit): boxes are sorted by descending
score; a kept valid box i suppresses every later box j with
IoU(i, j) > thr (strict); area is ``max(x2-x1,0)*max(y2-y1,0)``; the union
is floored at 1e-10 (the TPU kernel's floor, not ``bbox_overlaps``'s 1e-6);
invalid boxes are never kept and never suppress.
"""

from __future__ import annotations

import ctypes

import torch

from dsl_tpu_torch.core.boxes import bbox_overlaps
from dsl_tpu_torch.ops import build

UNION_FLOOR = 1e-10
TILE = 64


def nms_keep_reference(boxes_sorted: torch.Tensor, valid: torch.Tensor,
                       iou_threshold: float) -> torch.Tensor:
    """Plain version: the Jacobi fixpoint of the greedy recurrence.

    ``keep[j] = valid[j] and no kept i < j has IoU(i, j) > thr`` iterated
    from ``keep = valid`` until it stops changing (at most N rounds; in
    practice the length of the longest suppression chain).

    boxes_sorted (B, N, 4) f32, valid (B, N) bool -> keep (B, N) bool.
    """
    n = valid.shape[1]
    # the kernel's operation order: (area_i + area_j) - inter, floored, then
    # one IEEE division
    iou = bbox_overlaps(boxes_sorted, boxes_sorted, eps=UNION_FLOOR)
    thr = torch.tensor(iou_threshold, dtype=torch.float32)
    later = torch.ones(n, n, dtype=torch.bool, device=valid.device).triu(1)
    overlap = ((iou > thr.to(iou.device)) & later & valid[:, :, None]).float()
    keep = valid
    for _ in range(n + 1):
        suppressed = torch.bmm(keep.float()[:, None, :], overlap)[:, 0] > 0
        new_keep = valid & ~suppressed
        if torch.equal(new_keep, keep):
            break
        keep = new_keep
    return keep


def _check(boxes_sorted: torch.Tensor, valid: torch.Tensor) -> None:
    if boxes_sorted.dim() != 3 or boxes_sorted.shape[-1] != 4:
        raise ValueError(f"boxes must be (B, N, 4), got {tuple(boxes_sorted.shape)}")
    if valid.shape != boxes_sorted.shape[:2]:
        raise ValueError(f"valid {tuple(valid.shape)} does not match boxes "
                         f"{tuple(boxes_sorted.shape)}")
    if boxes_sorted.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(f"need float32 boxes and bool valid, got "
                        f"{boxes_sorted.dtype} and {valid.dtype}")


def nms_keep(boxes_sorted: torch.Tensor, valid: torch.Tensor,
             iou_threshold: float) -> torch.Tensor:
    """Greedy-NMS keep mask for each image of a batch.

    boxes_sorted (B, N, 4) f32, each image's boxes in descending score
    order; valid (B, N) bool -> keep (B, N) bool. CUDA tensors go through
    the kernel (one launch of its two passes for the whole batch, on the
    current stream); CPU tensors through :func:`nms_keep_reference`.

    The kernel's shared memory is a fixed 128 KB ring plus 8 bytes per 64
    boxes, so what bounds N is the suppression-mask scratch the wrapper
    allocates, B * ceil(N/64)**2 * 512 bytes (about B * N**2 / 8: 4.2 MB
    at B=8, N=2000; 113 MB at B=1, N=30000).
    """
    _check(boxes_sorted, valid)
    if boxes_sorted.device.type == "cpu" and valid.device.type == "cpu":
        return nms_keep_reference(boxes_sorted, valid, iou_threshold)
    if boxes_sorted.device.type != "cuda" or valid.device != boxes_sorted.device:
        raise ValueError(f"nms_keep needs both tensors on one CUDA device, got "
                         f"{boxes_sorted.device} and {valid.device}")
    if not (boxes_sorted.is_contiguous() and valid.is_contiguous()):
        raise ValueError("nms_keep needs contiguous tensors")
    if boxes_sorted.data_ptr() % 16:
        raise ValueError("nms_keep reads boxes as float4: the data must be "
                         "16-byte aligned")
    bsz, n = valid.shape
    keep = torch.empty((bsz, n), dtype=torch.bool, device=valid.device)
    if bsz == 0 or n == 0:
        return keep
    lib = _library()
    chunks = (n + TILE - 1) // TILE
    # chunk-major: (image, row chunk, word, row in chunk); the scan copies
    # runs of it into shared memory in bulk, which needs 16-byte alignment,
    # and the caching allocator starts every block on 512 bytes
    mask = torch.empty((bsz, chunks, chunks, TILE), dtype=torch.int64,
                       device=valid.device)
    # the C launcher runs on the current device: make it the tensors' own
    with torch.cuda.device(valid.device):
        stream = torch.cuda.current_stream(valid.device).cuda_stream
        err = lib.nms_keep_launch(boxes_sorted.data_ptr(), valid.data_ptr(),
                                  mask.data_ptr(), keep.data_ptr(), bsz, n,
                                  float(iou_threshold), stream)
    if err != 0:
        raise RuntimeError(f"nms_keep: CUDA launch at B={bsz}, N={n} failed "
                           f"with cudaError {err}")
    nms_keep.launches += 1
    return keep


nms_keep.launches = 0


def _library() -> ctypes.CDLL:
    lib = build.load("nms_kernel")
    if not getattr(lib, "_dsl_typed", False):
        lib.nms_keep_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        lib.nms_keep_launch.restype = ctypes.c_int
        lib._dsl_typed = True
    return lib
