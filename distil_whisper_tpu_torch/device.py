"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU.  A missing
GPU is an error, never a silent move to the CPU."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; raises if it is CUDA and no GPU
    is visible.  A bare ``cuda`` becomes the calling thread's current card
    (``cuda:i``): the current device is per thread, so a producer thread
    handed a bare ``cuda`` would work on card 0 whatever its rank's card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: distil_whisper_tpu_torch runs on the GPU "
            "by default; pass device='cpu' to run its plain PyTorch paths on "
            "the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
