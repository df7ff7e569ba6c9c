"""Device choice for the port's entry points.

Entry points run on the card.  `device=None` means "cuda" and RAISES when
there is none: the CPU is used only when the caller asks for it by name
(`device="cpu"`, as the tests do), never as a silent substitute.
"""

from __future__ import annotations

import subprocess
from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """None/"cuda[:i]" → that CUDA device (RuntimeError when CUDA is
    absent); "cpu" → the CPU, only because the caller said so."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: this entry point runs on the GPU; pass "
            "device='cpu' explicitly to run the plain PyTorch versions")
    return dev


def card_name_and_power_limit() -> str:
    """The card's name and power limit, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`
    prints them (first card).  Every time measured on the card is reported
    beside this line: a card set below its maximum limit runs slower."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    if not out:
        raise RuntimeError("nvidia-smi reported no GPU")
    return out.splitlines()[0].strip()
