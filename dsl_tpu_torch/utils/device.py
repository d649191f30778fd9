"""Device choice for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The torch device for an entry point: CUDA unless the caller asks for
    the CPU, and an error, not a quiet CPU run, where CUDA is absent."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return device


def to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host tensor on ``device``: to a card through pinned memory and
    without a wait (a copy from pageable memory would wait for the stream,
    which may be queued behind a train step)."""
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t
