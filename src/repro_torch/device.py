"""Device resolution for every entry point of the port.

The port runs on a CUDA card.  An entry point that is given no device takes
``cuda`` and raises when there is none; it never drops to the CPU quietly.
The CPU is used only when the caller asks for it (``device="cpu"``), as the
parity tests do, and the ``meta`` device (shapes and dtypes, no data: the
dry run and the op cost counter) only when the caller names it.  Routing
treats meta as the card (:func:`card_like`): a meta tensor takes the route
a card tensor of its shape would, through each kernel's meta route.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the current CUDA card; ``"cpu"`` means the CPU and
    ``"meta"`` the meta device, each only when named.

    Raises ``RuntimeError`` when a CUDA device is wanted and none exists."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch needs a CUDA device and found none; pass "
                "device='cpu' to run the plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def card_like(t: torch.Tensor) -> bool:
    """Whether ``t`` takes the card's routes: it lies on a CUDA device, or
    on the meta device, which stands for the card in the dry run and the
    cost counter (each kernel's meta route checks and allocates as its
    launcher does, and launches nothing)."""
    return t.is_cuda or t.is_meta
