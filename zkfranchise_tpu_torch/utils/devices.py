"""Device choice for the port's entry points.

Entry points run on the card unless the caller names another device: with
``device=None`` they take ``cuda``, and they raise when there is no card
rather than carrying on on the CPU.
"""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """None -> cuda (raising if no card is visible); else the device named."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    return dev
