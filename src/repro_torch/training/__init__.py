"""Training step of the port: loss, microbatch accumulation, AdamW with the
nonfinite skip, and the host-side GradGuard."""
from .step import (GradGuard, GuardPolicy, TrainHyper, loss_fn,
                   make_train_step)

__all__ = ["GradGuard", "GuardPolicy", "TrainHyper", "loss_fn",
           "make_train_step"]
