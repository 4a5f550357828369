"""Hand-written Hopper kernels of the port (``csrc/*.cu``), their plain
PyTorch versions, and the public wrappers in :mod:`.ops` (``ops.matmul``,
``ops.conv2d`` and ``ops.correlation`` are reached through :mod:`.ops`: the
package's own ``matmul``, ``conv2d`` and ``correlation`` are the kernel
modules)."""
from . import ops
from .ops import (LAUNCHES, flash_attention, flash_decode, paged_flash_decode,
                  reset_launches)

__all__ = ["ops", "LAUNCHES", "flash_attention", "flash_decode",
           "paged_flash_decode", "reset_launches"]
