"""Format-v2 checkpoints of the port, interchangeable with the reference
package's (see :mod:`repro_torch.checkpoint.manager`)."""
from .manager import (CheckpointCorruptError, CheckpointError,
                      CheckpointManager, TreeStructureError, latest_step,
                      restore_checkpoint, save_checkpoint, verified_steps,
                      verify_checkpoint)

__all__ = ["CheckpointCorruptError", "CheckpointError", "CheckpointManager",
           "TreeStructureError", "latest_step", "restore_checkpoint",
           "save_checkpoint", "verified_steps", "verify_checkpoint"]
