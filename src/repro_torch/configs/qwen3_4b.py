"""qwen3-4b [dense]: 36L d=2560 32H (GQA kv=8, head_dim 128) d_ff=9728
vocab=151936 — qk_norm, no qkv bias (the reference's configs/qwen3_4b.py)."""
import torch

from repro_torch.models import TransformerConfig, transformer
from .base import ArchBundle

ARCH_ID = "qwen3-4b"


def full_bundle() -> ArchBundle:
    cfg = TransformerConfig(
        name=ARCH_ID, n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8,
        d_ff=9728, vocab=151936, head_dim=128, qk_norm=True,
        rope_theta=1e6)
    return ArchBundle(ARCH_ID, "dense", cfg, transformer)


def smoke_bundle() -> ArchBundle:
    cfg = TransformerConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=256, head_dim=16, qk_norm=True,
        dtype=torch.float32)
    return ArchBundle(ARCH_ID, "dense", cfg, transformer)
