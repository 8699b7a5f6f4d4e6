"""Device resolution for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another one.  Raises when CUDA is asked for (or defaulted to) but is
    absent, so a run never falls back to the CPU silently."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "sejonggo_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' explicitly to run on the CPU")
    return dev
