"""Optimizers of the port (AdamW so far)."""
from .adamw import (AdamWConfig, adamw_init, adamw_update, clip_by_global_norm,
                    cosine_schedule)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "clip_by_global_norm",
           "cosine_schedule"]
