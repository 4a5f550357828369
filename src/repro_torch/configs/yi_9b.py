"""yi-9b [dense]: 48L d=4096 32H (GQA kv=4) d_ff=11008 vocab=64000 —
llama-arch GQA (the reference's configs/yi_9b.py)."""
import torch

from repro_torch.models import TransformerConfig, transformer
from .base import ArchBundle

ARCH_ID = "yi-9b"


def full_bundle() -> ArchBundle:
    cfg = TransformerConfig(
        name=ARCH_ID, n_layers=48, d_model=4096, n_heads=32, n_kv_heads=4,
        d_ff=11008, vocab=64000, rope_theta=5e6)
    return ArchBundle(ARCH_ID, "dense", cfg, transformer)


def smoke_bundle() -> ArchBundle:
    cfg = TransformerConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=1, d_ff=128, vocab=256, dtype=torch.float32)
    return ArchBundle(ARCH_ID, "dense", cfg, transformer)
