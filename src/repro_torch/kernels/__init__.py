"""Hand-written Hopper kernels of the port (``csrc/*.cu``), their plain
PyTorch versions, and the public wrappers in :mod:`.ops`."""
from . import ops
from .ops import LAUNCHES, flash_attention, paged_flash_decode, reset_launches

__all__ = ["ops", "LAUNCHES", "flash_attention", "paged_flash_decode",
           "reset_launches"]
