"""Device resolution for every entry point of the port.

The port runs on a CUDA card.  An entry point that is given no device takes
``cuda`` and raises when there is none; it never drops to the CPU quietly.
The CPU is used only when the caller asks for it (``device="cpu"``), as the
parity tests do.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the current CUDA card; ``"cpu"`` means the CPU.

    Raises ``RuntimeError`` when a CUDA device is wanted and none exists."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch needs a CUDA device and found none; pass "
                "device='cpu' to run the plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
