"""recurrentgemma-9b [hybrid]: 38L d=4096 16H (MQA kv=1, head_dim 256)
d_ff=12288 — RG-LRU + local attention (window 2048), pattern 1 attn : 2
rec, vocab=256000; sub-quadratic (the reference's
configs/recurrentgemma_9b.py)."""
import torch

from repro_torch.models import RGConfig, recurrentgemma
from .base import ArchBundle

ARCH_ID = "recurrentgemma-9b"


def full_bundle() -> ArchBundle:
    cfg = RGConfig(name=ARCH_ID, n_layers=38, d_model=4096, n_heads=16,
                   n_kv_heads=1, d_ff=12288, vocab=256000, window=2048)
    return ArchBundle(ARCH_ID, "hybrid", cfg, recurrentgemma,
                      sub_quadratic=True)


def smoke_bundle() -> ArchBundle:
    cfg = RGConfig(name=ARCH_ID + "-smoke", n_layers=5, d_model=64,
                   n_heads=4, n_kv_heads=1, d_ff=128, vocab=256, window=64,
                   dtype=torch.float32)
    return ArchBundle(ARCH_ID, "hybrid", cfg, recurrentgemma,
                      sub_quadratic=True)
