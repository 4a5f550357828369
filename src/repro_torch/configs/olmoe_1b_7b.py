"""olmoe-1b-7b [moe]: 16L d=2048 16H (MHA kv=16) vocab=50304, MoE 64 experts
top-8, expert d_ff=1024 (the reference's configs/olmoe_1b_7b.py)."""
import torch

from repro_torch.models import MoEConfig, TransformerConfig, transformer
from .base import ArchBundle

ARCH_ID = "olmoe-1b-7b"


def full_bundle() -> ArchBundle:
    cfg = TransformerConfig(
        name=ARCH_ID, n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=1024, vocab=50304,
        moe=MoEConfig(n_experts=64, top_k=8, d_ff=1024), rope_theta=1e6)
    return ArchBundle(ARCH_ID, "moe", cfg, transformer)


def smoke_bundle() -> ArchBundle:
    cfg = TransformerConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=96, vocab=256,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff=96, capacity_factor=8.0),
        dtype=torch.float32)
    return ArchBundle(ARCH_ID, "moe", cfg, transformer)
