"""granite-moe-3b-a800m [moe]: 32L d=1536 24H (GQA kv=8) vocab=49408,
MoE 40 experts top-8, expert d_ff=512 (the reference's
configs/granite_moe_3b.py)."""
import torch

from repro_torch.models import MoEConfig, TransformerConfig, transformer
from .base import ArchBundle

ARCH_ID = "granite-moe-3b-a800m"


def full_bundle() -> ArchBundle:
    cfg = TransformerConfig(
        name=ARCH_ID, n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
        d_ff=512, vocab=49408,
        moe=MoEConfig(n_experts=40, top_k=8, d_ff=512), rope_theta=1e6)
    return ArchBundle(ARCH_ID, "moe", cfg, transformer,
                      extras={"true_vocab": 49155})


def smoke_bundle() -> ArchBundle:
    cfg = TransformerConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=48, n_heads=3,
        n_kv_heads=1, d_ff=64, vocab=256,
        moe=MoEConfig(n_experts=5, top_k=2, d_ff=64, capacity_factor=8.0),
        dtype=torch.float32)
    return ArchBundle(ARCH_ID, "moe", cfg, transformer)
