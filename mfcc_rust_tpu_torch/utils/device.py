"""Device resolution for the port's entry points."""

from __future__ import annotations

import contextlib

import torch

_CURRENT = contextlib.nullcontext()


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``.  A CUDA device without CUDA raises: the
    entry points never move to the CPU unless the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


def launch_stream(device: torch.device) -> tuple:
    """``(guard, stream)`` for a kernel launch on the CUDA ``device``: a
    context that makes it the current device (a null one where it already
    is) and the raw handle of its current stream.  The same as entering
    ``torch.cuda.device(device)`` and reading ``current_stream().cuda_stream``,
    at a fraction of their host time on every launch."""
    index = torch.cuda.current_device() if device.index is None else device.index
    guard = _CURRENT if index == torch.cuda.current_device() else torch.cuda.device(index)
    return guard, torch._C._cuda_getCurrentRawStream(index)
