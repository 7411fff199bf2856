"""Where the port's entry points put their tensors."""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"
"""The entry points (FASST and its variants, STFT) run on the card unless
the caller asks for the CPU."""


def resolve_device(device) -> torch.device:
    """torch.device for a 'cpu' or 'cuda' request; raises when CUDA is asked
    for and no card is present (never falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} was requested but no CUDA device "
                "is available (pass device='cpu' to run on the CPU)")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev
