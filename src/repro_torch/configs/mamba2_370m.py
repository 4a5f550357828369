"""mamba2-370m [ssm]: 48L d=1024, attn-free, ssm_state=128, vocab=50432 —
SSD (state-space duality); sub-quadratic (the reference's
configs/mamba2_370m.py)."""
import torch

from repro_torch.models import Mamba2Config, mamba2
from .base import ArchBundle

ARCH_ID = "mamba2-370m"


def full_bundle() -> ArchBundle:
    cfg = Mamba2Config(name=ARCH_ID, n_layers=48, d_model=1024,
                       vocab=50432, d_state=128, headdim=64, chunk=256)
    return ArchBundle(ARCH_ID, "ssm", cfg, mamba2, sub_quadratic=True,
                      extras={"true_vocab": 50280})


def smoke_bundle() -> ArchBundle:
    cfg = Mamba2Config(name=ARCH_ID + "-smoke", n_layers=2, d_model=64,
                       vocab=256, d_state=16, headdim=16, chunk=16,
                       dtype=torch.float32)
    return ArchBundle(ARCH_ID, "ssm", cfg, mamba2, sub_quadratic=True)
